"""Regenerate committed golden images (tests/golden/*.npy).

Goldens pin the exact output of the engine at fixed seeds on the CPU
backend (SURVEY.md §4.6). Regenerate ONLY via this script, after an
intentional semantics change, and eyeball the PNGs it writes next to the
.npy files before committing:

    python scripts/regen_goldens.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from pathtracer.accel.build import with_bvh  # noqa: E402
from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.engine import wavefront  # noqa: E402
from pathtracer.io.framebuffer import write_png  # noqa: E402
from pathtracer.scene import builder  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "golden")

GOLDENS = {
    # name: (scene ctor, config)
    "config1_64": (
        lambda: builder.cornell_spheres(),
        RenderConfig(width=64, height=64, spp=4, max_depth=1,
                     scene="cornell_spheres", use_bvh=False),
    ),
    "config2_48": (
        lambda: with_bvh(builder.cornell_mesh(
            mesh_tris=builder.procedural_bunny(2))),
        RenderConfig(width=48, height=48, spp=2, max_depth=1,
                     scene="cornell_mesh", use_bvh=True),
    ),
    "config3_32": (
        lambda: with_bvh(builder.cornell_mesh(
            mesh_tris=builder.procedural_bunny(2))),
        RenderConfig(width=32, height=32, spp=4, max_depth=4, rr_start=2,
                     scene="cornell_mesh", use_bvh=True),
    ),
}


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    for name, (mk, cfg) in GOLDENS.items():
        img = np.asarray(wavefront.render(mk(), cfg))
        np.save(os.path.join(OUT, f"{name}.npy"), img)
        write_png(os.path.join(OUT, f"{name}.png"), img)
        print(f"{name}: mean {img.mean():.4f} -> tests/golden/{name}.npy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
