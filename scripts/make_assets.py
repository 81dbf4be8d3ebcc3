"""Generate the committed mesh asset(s).

The reference ships the Stanford bunny OBJ (SURVEY.md §2.1 R8); this
environment has no network, so the committed `assets/bunny.obj` is the
deterministic procedural bunny written out as a real OBJ — which routes
the primary benchmark scene through the loader -> clusters/BVH -> render
chain like the reference's asset path.

Vertex coordinates are printed with repr() of the float64 upcast of the
f32 values, so parse(print(x)) == x exactly and the loaded triangle array
is BIT-IDENTICAL to procedural_bunny(4): goldens and fixed-seed tests are
unaffected by switching the scene to the asset path.

Usage: python scripts/make_assets.py  (writes assets/bunny.obj, verifies
the roundtrip, prints a summary)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pathtracer.scene.builder import procedural_bunny
from pathtracer.scene.obj import load_obj


def write_obj(path: str, tri: np.ndarray) -> None:
    """Write a (T, 3, 3) f32 triangle array as a deduplicated-vertex OBJ."""
    tri = np.asarray(tri, np.float32)
    flat = tri.reshape(-1, 3)
    # Dedup by exact bytes; `index` maps each corner to its vertex id.
    seen: dict[bytes, int] = {}
    index = np.empty(len(flat), np.int64)
    verts: list[np.ndarray] = []
    for i, p in enumerate(flat):
        key = p.tobytes()
        j = seen.get(key)
        if j is None:
            j = len(verts)
            seen[key] = j
            verts.append(p)
        index[i] = j
    faces = index.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("# procedural bunny (deterministic stand-in for the "
                "Stanford bunny; scripts/make_assets.py)\n")
        f.write(f"# {len(verts)} vertices, {len(faces)} faces\n")
        for p in verts:
            # repr of the float64 upcast roundtrips the f32 exactly.
            f.write(f"v {float(p[0])!r} {float(p[1])!r} {float(p[2])!r}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(here, "assets"), exist_ok=True)
    path = os.path.join(here, "assets", "bunny.obj")
    tri = procedural_bunny(4)
    write_obj(path, tri)
    back = load_obj(path)
    assert back.shape == tri.shape, (back.shape, tri.shape)
    assert np.array_equal(back, tri), "OBJ roundtrip is not bit-exact"
    print(f"wrote {path}: {tri.shape[0]} triangles, "
          f"roundtrip bit-exact = True")
    return 0


if __name__ == "__main__":
    sys.exit(main())
