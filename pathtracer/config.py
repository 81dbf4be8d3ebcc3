"""Render configuration.

The reference (Ashish424/G.P.U-PathTracer) bakes its render parameters into
compile-time constants and Qt UI state (SURVEY.md §5.6; the reference checkout
at /root/reference was empty this round, so reference citations are to the
attested survey, not file:line). Here the whole configuration is a single
frozen, hashable dataclass so it can be a static argument to ``jax.jit`` —
every distinct (width, height, spp, max_depth, ...) tuple is one compiled XLA
program, matching how the reference recompiles per build.

The five driver milestone configs (BASELINE.json:6-12) are provided as named
presets in :data:`PRESETS`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (hashable; safe as a jit static arg).

    Attributes:
      width, height: image resolution in pixels.
      spp: samples per pixel.
      max_depth: number of path segments traced from the camera
        (1 = direct lighting only: primary hit + next-event estimation).
      rr_start: bounce index at which Russian roulette termination begins.
        ``rr_start >= max_depth`` disables RR.
      seed: base seed of the counter-based threefry sampler. All randomness
        in a render is a pure function of (seed, pixel_id, spp_idx, bounce),
        never of device id or iteration order (SURVEY.md §7 hard part 4).
      scene: name of a builtin scene preset (see scene/builder.py).
      spp_chunk: samples accumulated per jit step; bounds live memory for
        arbitrarily large spp (SURVEY.md §5.7). 0 means all spp in one pass.
      use_bvh: traverse the flat BVH (vs brute-force all triangles).
      backend: "cluster" (routes by scene size, accel/auto.py: the dense
        cluster kernel for small scenes, ops/intersect_cluster.py, the BVH
        walk for large ones) or "jnp" (plain-JAX skip-link BVH walk,
        accel/traverse.py).
      compact: stream-compact the active-ray buffer between bounces.
      mis: multiple importance sampling (power heuristic) between NEE and
        cosine-BSDF sampling at diffuse vertices (SURVEY.md §3.1
        "+MIS/NEE bookkeeping"). Off by default: the base estimator is
        the reference's NEE-only accounting; MIS lowers variance on
        scenes where BSDF sampling competes (large/near lights).
    """

    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 1
    rr_start: int = 2
    seed: int = 0
    scene: str = "cornell_spheres"
    spp_chunk: int = 0
    use_bvh: bool = True
    backend: str = "jnp"
    compact: bool = False
    mis: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))


# The five driver milestone configs, BASELINE.json:6-12.
PRESETS: dict[str, RenderConfig] = {
    # 1. Cornell box, analytic spheres, diffuse BRDF, 1 bounce, 1spp 256x256
    #    (CPU-runnable reference).
    "config1": RenderConfig(
        width=256, height=256, spp=1, max_depth=1, scene="cornell_spheres",
        use_bvh=False,
    ),
    # 2. Triangle-mesh Cornell (bunny) with flat BVH traversal, direct light.
    "config2": RenderConfig(
        width=256, height=256, spp=1, max_depth=1, scene="cornell_mesh",
        use_bvh=True,
    ),
    # 3. Multi-bounce GI (4 bounces) with NEE + Russian roulette, 64spp.
    "config3": RenderConfig(
        width=256, height=256, spp=64, max_depth=4, rr_start=2,
        scene="cornell_mesh", use_bvh=True, spp_chunk=16,
    ),
    # 4. Differentiable pass: grad of image loss w.r.t. per-material
    #    albedo/emission, allclose vs finite differences.
    "config4": RenderConfig(
        width=128, height=128, spp=4, max_depth=2, scene="cornell_spheres",
        use_bvh=False,
    ),
    # 5. Multi-host: 2M-triangle scene, tiles+rays sharded, grads allreduced.
    # backend="cluster" routes this scene to the BVH walk by its size
    # (accel/auto.py); PERF.md holds its GPU measurements.
    "config5": RenderConfig(
        width=1024, height=1024, spp=1, max_depth=4, scene="big_mesh",
        use_bvh=True, spp_chunk=1, backend="cluster",
    ),
    # The primary benchmark metric config (BASELINE.json:2):
    # rays/s per GPU at 1spp 1024x1024 Cornell-mesh. backend="cluster"
    # routes this scene to the dense cluster kernel. compact=True: the
    # coherence sort tightens the cluster cull for bounce/shadow passes.
    "bench": RenderConfig(
        width=1024, height=1024, spp=1, max_depth=4, rr_start=2,
        scene="cornell_mesh", use_bvh=True, backend="cluster",
        compact=True,
    ),
}
