"""Framebuffer output: accumulate → tonemap → PNG/npy, plus resume files.

The reference blits its CUDA accumulation buffer to the screen through a
GL pixel-buffer object every frame (SURVEY.md §2.1 R7/R10). Headless
rendering replaces that with explicit dumps ("Qt/OpenGL display → jnp
framebuffer dump", BASELINE.json:5): linear-radiance images are written as
.npy, display images as gamma-encoded PNG (numpy + stdlib zlib, no imaging
library), and long renders checkpoint the
(accumulated radiance, sample count) pair so they can resume exactly
(SURVEY.md §5.4 — deterministic threefry makes resumed samples identical).
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear radiance → uint8 sRGB-ish display image (clamp + gamma)."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    img = img ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filtering, zlib)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3, rgb.shape
    # Each scanline is prefixed with filter type 0 (None).
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by encode_png -> (H, W, 3) uint8."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2), "only 8-bit RGB is supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all(), "only unfiltered scanlines supported"
    return raw[:, 1:].reshape(h, w, 3).copy()


def write_png(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    """Write a linear-radiance (H, W, 3) image as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(tonemap(img, gamma)))


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, np.float32))


def save_accumulator(
    path: str, accum: np.ndarray, spp_done: int, meta: dict | None = None
) -> None:
    """Checkpoint a partially accumulated render (resumable)."""
    np.savez(
        path,
        accum=np.asarray(accum, np.float32),
        spp_done=np.int64(spp_done),
        meta=json.dumps(meta or {}),
    )


def load_accumulator(path: str):
    """Returns (accum, spp_done, meta) from save_accumulator output."""
    z = np.load(path, allow_pickle=False)
    return z["accum"], int(z["spp_done"]), json.loads(str(z["meta"]))
