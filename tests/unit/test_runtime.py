"""Runtime plumbing: the compile-cache directory rule, the zlib PNG
writer, and chip_smoke.py refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from pathtracer.io import framebuffer as fb
from pathtracer.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that is the cache, and
    enable() sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.cache_dir() == str(tmp_path)
    assert cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_repo_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    assert cache.enable() == cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13)])
def test_png_round_trip(h, w):
    rng = np.random.default_rng(h * w)
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    data = fb.encode_png(rgb)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(fb.decode_png(data), rgb)


def test_write_png_is_tonemapped_image(tmp_path):
    img = np.linspace(0.0, 1.5, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    path = tmp_path / "x.png"
    fb.write_png(str(path), img)
    np.testing.assert_array_equal(fb.decode_png(path.read_bytes()),
                                  fb.tonemap(img))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_on_cpu():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
