"""Stackless BVH traversal + Möller–Trumbore, pure-jnp path (SURVEY.md T6).

Replaces the reference's per-thread stack walk over pointer nodes
(SURVEY.md §3.1 "HOTTEST: pointer-chasing, divergent") with a single
`lax.while_loop` per ray over the skip-link layout from accel/build.py:
one int32 cursor, gathers into the flat SoA node/triangle arrays, no
stack. Under vmap the loop becomes one batched while-loop that runs until
every lane's cursor reaches the end sentinel — lanes that finish early are
predicated off, which is exactly the wavefront behavior the reference's
megakernel lacks.

The whole batch is one while-loop: on an H100, splitting it into
sequential fixed-size chunks (so one long ray stalls only its chunk)
rendered 7.8x (cornell_mesh) and 10.2x (big_mesh) slower than one
batch-wide loop (PERF.md).

Return contract matches engine/intersect.py:brute: (t, n_geom, mat) with
t == T_FAR on miss. Equality vs brute force is asserted in
tests/unit/test_bvh.py; the MT predicate here must stay in lockstep with
the brute/oracle versions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants as C
from ..engine import intersect as isect

def _traverse(geom, o, d, max_leaf: int):
    """Traverse a batch of rays: o, d (R, 3) → (t, tri_idx)."""
    n_nodes = geom.bvh_lo.shape[0]

    # Safe inverse direction for slab tests (avoid 0*inf → NaN).
    tiny = 1e-20
    dd = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv_d = 1.0 / dd

    def cond(state):
        cursor, t_best, best = state
        return jnp.any(cursor < n_nodes)

    def body(state):
        cursor, t_best, best = state
        c = jnp.minimum(cursor, n_nodes - 1)  # clamp finished lanes
        active = cursor < n_nodes
        lo = geom.bvh_lo[c]
        hi = geom.bvh_hi[c]
        first = geom.bvh_first[c]
        count = geom.bvh_count[c]
        skip = geom.bvh_skip[c]

        # AABB slab test, culled against the current best hit.
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit_box = active & (tfar >= jnp.maximum(tnear, C.T_MIN)) & (
            tnear < t_best
        )
        is_leaf = count > 0

        # Leaf: up to max_leaf Möller–Trumbore tests (static unroll).
        for k in range(max_leaf):
            idx = jnp.minimum(first + k, geom.tri_v0.shape[0] - 1)
            valid = hit_box & is_leaf & (k < count)
            v0 = geom.tri_v0[idx]
            e1 = geom.tri_e1[idx]
            e2 = geom.tri_e2[idx]
            pvec = jnp.cross(d, e2)
            det = jnp.sum(e1 * pvec, -1)
            safe = jnp.where(det == 0, 1.0, det)
            inv = jnp.where(jnp.abs(det) > C.DET_EPS, 1.0 / safe, 0.0)
            tvec = o - v0
            uu = jnp.sum(tvec * pvec, -1) * inv
            qvec = jnp.cross(tvec, e1)
            vv = jnp.sum(d * qvec, -1) * inv
            t = jnp.sum(e2 * qvec, -1) * inv
            ok = (
                valid
                & (jnp.abs(det) > C.DET_EPS)
                & (uu >= 0.0)
                & (vv >= 0.0)
                & (uu + vv <= 1.0)
                & (t > C.T_MIN)
                & (t < C.T_FAR)
            )
            better = ok & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            best = jnp.where(better, idx, best)

        nxt = jnp.where(hit_box & ~is_leaf, c + 1, skip)
        cursor = jnp.where(active, nxt, cursor)
        return cursor, t_best, best

    # Derive the carry init from the (possibly device-varying) rays, not
    # from constants: under `shard_map` a constant init is "unvarying"
    # while the loop body makes the carry varying, which jax rejects
    # (scan-vma rule). (o + d) covers both sources of varying-ness —
    # camera rays share one origin, so o alone can be an unvarying
    # broadcast while d varies per pixel. XLA folds the zero; outside
    # shard_map this is identical to zeros().
    zero = (o[:, 0] + d[:, 0]) * 0.0
    init = (
        zero.astype(jnp.int32),
        zero + C.T_FAR,
        zero.astype(jnp.int32) - 1,
    )
    _, t_best, best = jax.lax.while_loop(cond, body, init)
    return t_best, best


def closest_hit(geom, o, d, max_leaf: int = 4):
    """Closest hit via BVH (triangles) + brute spheres.

    Same contract as engine/intersect.py:brute.
    """
    # Host-side (numpy) scenes must become jnp arrays before traced
    # indexing inside the while-loop body.
    geom = jax.tree.map(jnp.asarray, geom)
    o = jnp.asarray(o)
    d = jnp.asarray(d)
    t_best, best = _traverse(geom, o, d, max_leaf)
    hit = best >= 0
    safe = jnp.maximum(best, 0)
    n_best = jnp.where(hit[:, None], geom.tri_n[safe], 0.0)
    m_best = jnp.where(hit, geom.tri_mat[safe], 0)
    t_out = jnp.where(hit, t_best, C.T_FAR)

    if geom.sph_c.shape[0] > 0:
        ts = isect.intersect_spheres(o, d, geom.sph_c, geom.sph_r)
        si = jnp.argmin(ts, axis=1)
        sv = jnp.take_along_axis(ts, si[:, None], axis=1)[:, 0]
        better = sv < t_out
        p = o + sv[:, None] * d
        ns = (p - geom.sph_c[si]) / geom.sph_r[si][:, None]
        t_out = jnp.where(better, sv, t_out)
        n_best = jnp.where(better[:, None], ns, n_best)
        m_best = jnp.where(better, geom.sph_mat[si], m_best)
    return t_out, n_best, m_best
