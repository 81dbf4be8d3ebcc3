"""Backend-aware acceleration-table preparation (one source of truth).

Builds the host-side tables a RenderConfig's backend needs, and routes
by scene size: backend="cluster" (the default of the bench preset) gets
dense cluster tables for small scenes and only the BVH for large ones,
and engine/wavefront.py:_intersector applies the same rule at trace
time (dense_route), so scene and engine agree.

The dense route walks near-first per-tile candidate lists; its cost per
ray grows with the clusters a tile's rays cross, and its culling tables
are (tiles x clusters). The BVH walk (accel/traverse.py) grows with the
tree's depth only. Timed on an H100 at the bench shape (PERF.md), the
dense route renders 256 clusters 4.5x faster than the walk and 1,024
clusters 1.9x slower. Above 512 clusters
(ops/intersect_cluster.py:RAY_CULL_MAX_C) the dense route swaps its
per-cluster line cull for the coarser super-cluster mask, so 512 is the
largest size that keeps the cull the 256-cluster run measured;
log-linear interpolation of the two ratios puts the crossover near 680.
"""

from __future__ import annotations

from ..config import RenderConfig
from ..scene.model import Scene
from .clusters import CLUSTER_TRIS

# Largest cluster table (128-triangle clusters) routed to the dense
# cluster kernel; larger scenes take the BVH walk.
DENSE_MAX_CLUSTERS = 512


def dense_route(n_clusters: int) -> bool:
    """True when a scene of `n_clusters` clusters takes the dense route."""
    return n_clusters <= DENSE_MAX_CLUSTERS


def prepare_accel(scene: Scene, cfg: RenderConfig) -> Scene:
    """Attach the accel tables `cfg.backend` needs (host-side numpy).

    backend="cluster": dense cluster tables when dense_route says so,
        else none (the engine walks the BVH, which cfg.use_bvh builds
        upstream).
    backend="jnp":    BVH only (handled by cfg.use_bvh upstream).
    """
    if cfg.backend != "cluster":
        return scene
    from .clusters import with_clusters

    # ceil(T/128) is a LOWER bound on the cluster count, so a failing
    # estimate is definitive — skip the cluster build.
    n_tris = int(scene.geometry.tri_v0.shape[0])
    if not dense_route(-(-n_tris // CLUSTER_TRIS)):
        return scene
    clustered = with_clusters(scene)
    if not dense_route(int(clustered.geometry.cl_lo.shape[0])):
        return scene
    return clustered
