"""Dense cluster intersection: the closest-hit path for small scenes.

The reference's hot path is a divergent per-thread BVH stack walk in CUDA
(SURVEY.md §2.1 R2/R3, §3.1 "HOTTEST"). This module poses the same query
as dense work over 128-triangle clusters (accel/clusters.py):

  candidate build (XLA, cull_candidates): conservative interval-
      arithmetic slab test per (ray tile, cluster), narrowed by a per-ray
      line test -> per-tile lists of surviving cluster ids SORTED
      NEAR-FIRST by the lower bound of the entry distance. Plays with
      engine/wavefront.py's coherence compaction: sorted rays give tight
      tile intervals, so lists get shorter exactly when it matters.

  fine test (Pallas kernel through Triton, walk_candidates): one program
      per RAY_TILE-ray tile walks its candidate list front-to-back. A
      visit tests the cluster's 128 triangles against the tile's rays in
      TRI_CHUNK-triangle sub-chunks: the (det, u*det, v*det, t*det)
      feature dots as f32 multiply-adds (19 per ray-triangle pair, no
      tensor-core rounding), then a sign-canonical Möller-Trumbore
      predicate in multiply form and a running min. The walk
      EARLY-TERMINATES once every ray's best hit is nearer than the next
      cluster's conservative entry distance — the ordered-traversal
      optimization of a classic BVH walk, re-posed per tile. Each program
      loads its own candidate row and count from device memory.

Correctness contract: same hit set as engine/intersect.py:brute (same
DET_EPS/T_MIN/T_FAR predicate, evaluated in multiply-by-|det| form).
t values agree to f32 tolerance, not bit-exactly (different association);
tie-breaks between equal-t triangles may differ in *index* but tests pin
t/material/normal agreement (tests/unit/test_cluster.py). Early exit
cannot drop a hit: it only skips clusters whose whole AABB lies strictly
beyond every ray's current best t.

The kernel runs compiled on a GPU and in Pallas interpret mode on the
CPU (interpret_for); any other platform raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .. import constants as C
from ..accel.clusters import CLUSTER_COLS, CLUSTER_TRIS, FEAT_ROWS
from ..engine import intersect as isect

# Rays per kernel program (a power of two, as Triton requires). Also the
# cull granularity of the dense route: one candidate list per tile.
RAY_TILE = 64
# Triangles per sub-chunk of a visit: the (TRI_CHUNK, RAY_TILE) tiles of
# the four feature dots live in registers.
TRI_CHUNK = 32
_NUM_WARPS = 4


def interpret_for(platform: str) -> bool:
    """Pallas interpret flag for a JAX platform name.

    "cpu" interprets (tests and CPU renders), "gpu" compiles the Triton
    kernel. Anything else has no hit-query kernel and raises rather than
    quietly interpreting on an accelerator.
    """
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise NotImplementedError(
        f"no hit-query kernel for JAX platform {platform!r} "
        "(the kernels compile for 'gpu' and interpret on 'cpu')"
    )


def _visit(feat_ref, rows, cid, t_best, best):
    """Test cluster `cid`'s 128 triangles against one ray tile.

    rows: ray feature rows 0-8, each (1, RT) — [d(3), o x d(3), o(3)].
    Returns updated (t_best, best), best = cid * 128 + triangle slot for
    lanes whose nearest hit improved. A loop over TRI_CHUNK-triangle
    sub-chunks keeps the per-chunk (TRI_CHUNK, RT) tiles register-sized;
    the slot of the minimum is the lowest one attaining it, and a later
    sub-chunk must be strictly nearer, so equal-t ties resolve to the
    lowest slot deterministically.
    """
    n = CLUSTER_TRIS
    base = cid * CLUSTER_COLS

    def chunk(s, carry):
        t_best, best = carry
        off = base + s * TRI_CHUNK

        def col(q, j):
            start = pl.multiple_of(off + q * n, TRI_CHUNK)
            return feat_ref[j, pl.ds(start, TRI_CHUNK)][:, None]

        det = col(0, 0) * rows[0] + col(0, 1) * rows[1] + col(0, 2) * rows[2]
        un = (col(1, 0) * rows[0] + col(1, 1) * rows[1]
              + col(1, 2) * rows[2] + col(1, 3) * rows[3]
              + col(1, 4) * rows[4] + col(1, 5) * rows[5])
        vn = (col(2, 0) * rows[0] + col(2, 1) * rows[1]
              + col(2, 2) * rows[2] + col(2, 3) * rows[3]
              + col(2, 4) * rows[4] + col(2, 5) * rows[5])
        tn = (col(3, 6) * rows[6] + col(3, 7) * rows[7]
              + col(3, 8) * rows[8] + col(3, 9))
        # Dividing by det flips inequality directions when det < 0, so
        # fold the sign into the numerators and compare against |det|.
        sgn = jnp.where(det < 0.0, -1.0, 1.0)
        adet = det * sgn
        un = un * sgn
        vn = vn * sgn
        tn = tn * sgn
        valid = (
            (adet > C.DET_EPS)
            & (un >= 0.0)
            & (vn >= 0.0)
            & (un + vn <= adet)
            & (tn > C.T_MIN * adet)
        )
        # Invalid sentinel strictly above any t_best init (<= T_FAR), so an
        # all-miss chunk never reads as an improvement.
        tc = jnp.where(valid, tn / jnp.maximum(adet, np.float32(1e-30)),
                       np.float32(2.0 * C.T_FAR))
        tmin = jnp.min(tc, axis=0)
        slot = jnp.arange(TRI_CHUNK, dtype=jnp.int32)[:, None] + s * TRI_CHUNK
        smin = jnp.min(jnp.where(tc == tmin[None, :], slot, n), axis=0)
        better = tmin < t_best
        best = jnp.where(better, cid * n + smin, best)
        t_best = jnp.where(better, tmin, t_best)
        return t_best, best

    return jax.lax.fori_loop(0, n // TRI_CHUNK, chunk, (t_best, best))


def _walk_kernel(cand_ref, count_ref, tnear_ref, rayf_ref, feat_ref, t_ref,
                 idx_ref):
    """Kernel for one RAY_TILE-ray tile walking its candidate row.

    Inputs (whole arrays in device memory unless noted):
      cand (B, K) i32 cluster ids; count (B,) i32 candidates to walk;
      tnear (B, K) f32 sorted entry-distance lower bounds;
      rayf (RT, 16) f32 tile block — columns [d, o x d, o, 1, t_init,
        0...];
      feat (16, C*512) f32 feature table.
    Outputs: t (RT,) f32 nearest t (t_init if nothing nearer), slot (RT,)
    i32 winning padded cluster slot (-1 if none). The walk stops once the
    next candidate's entry bound is beyond every lane's best t.
    """
    row = pl.program_id(0)
    K = cand_ref.shape[1]
    rows = [rayf_ref[:, j][None, :] for j in range(9)]
    t0 = rayf_ref[:, 10]
    n_cand = jnp.minimum(count_ref[row], K)

    def cond(state):
        k, tmax, _, _ = state
        kc = jnp.minimum(k, K - 1)
        return (k < n_cand) & (tnear_ref[row, kc] < tmax)

    def body(state):
        k, _, t_best, best = state
        t_best, best = _visit(feat_ref, rows, cand_ref[row, k], t_best, best)
        return k + 1, jnp.max(t_best), t_best, best

    init = (jnp.int32(0), jnp.max(t0), t0, jnp.full(t0.shape, -1, jnp.int32))
    _, _, t_best, best = jax.lax.while_loop(cond, body, init)
    t_ref[...] = t_best
    idx_ref[...] = best


@functools.partial(jax.jit, static_argnames=("interpret",))
def _walk_impl(cand, count, tnear, rayf, feat, interpret):
    R = rayf.shape[1]
    assert R % RAY_TILE == 0, (R, RAY_TILE)
    n_tiles = R // RAY_TILE
    assert cand.shape[0] == n_tiles, (cand.shape, n_tiles)
    whole = pl.BlockSpec(memory_space=pl.ANY)
    tile = pl.BlockSpec((RAY_TILE,), lambda i: (i,))
    # Ray-major features: the kernel's strides then do not depend on the
    # batch size, so every call lowers to the same kernel.
    return pl.pallas_call(
        _walk_kernel,
        grid=(n_tiles,),
        in_specs=[whole, whole, whole,
                  pl.BlockSpec((RAY_TILE, FEAT_ROWS), lambda i: (i, 0)),
                  whole],
        out_specs=[tile, tile],
        out_shape=[
            jax.ShapeDtypeStruct((R,), jnp.float32),
            jax.ShapeDtypeStruct((R,), jnp.int32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="cluster_walk",
    )(cand, count, tnear, rayf.T, feat)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def walk_candidates(cand, count, tnear, rayf, feat, interpret):
    """Closest hit of every ray against its tile's candidate clusters.

    cand (B, K) i32 / count (B,) i32: per-tile candidate lists; tnear
    (B, K) f32 near-first entry bounds driving the ordered early exit
    (-inf walks every listed candidate); rayf (16, R) f32 ray features
    with row 10 the per-ray initial best t (an upper bound: only strictly
    nearer hits are reported); feat (16, C*512) f32 table.
    Returns (t (R,), slot (R,)).

    custom_vjp boundary: traversal outputs are piecewise-constant in the
    differentiable parameters, so the VJP returns zero cotangents
    (SURVEY.md §3.4/T9).
    """
    return _walk_impl(cand, count, tnear, rayf, feat, interpret)


def _walk_fwd(cand, count, tnear, rayf, feat, interpret):
    out = _walk_impl(cand, count, tnear, rayf, feat, interpret)
    return out, (cand.shape, count.shape, tnear.shape, rayf.shape,
                 feat.shape)


def _walk_bwd(interpret, shapes, g):
    c_shape, n_shape, tn_shape, r_shape, f_shape = shapes
    return (
        np.zeros(c_shape, jax.dtypes.float0),  # int input -> float0
        np.zeros(n_shape, jax.dtypes.float0),
        jnp.zeros(tn_shape, jnp.float32),
        jnp.zeros(r_shape, jnp.float32),
        jnp.zeros(f_shape, jnp.float32),
    )


walk_candidates.defvjp(_walk_fwd, _walk_bwd)


def _ray_features(o, d, t_max=None):
    """(R, 3) origins/directions -> planar (16, R) ray feature rows.

    Row layout: [d(3), o x d(3), o(3), 1, t_max, 0(5)]. Rows 0-9 pair
    with the triangle feature columns (accel/clusters.py — those columns
    are zero in rows 10+, so extra rows never perturb q). Row 10 carries
    the per-ray t upper bound: the kernels initialize their best-t to it,
    so hits beyond t_max MAY be reported as misses and the ordered early
    exit stops at t_max instead of T_FAR — the NEE shadow-ray win (a
    shadow query only cares about occluders nearer than the light).
    """
    R = o.shape[0]
    oxd = jnp.cross(o, d)
    if t_max is None:
        tm = jnp.full((1, R), C.T_FAR, jnp.float32)
    else:
        tm = jnp.asarray(t_max, jnp.float32).reshape(1, R)
    rows = jnp.concatenate(
        [d.T, oxd.T, o.T, jnp.ones((1, R), jnp.float32), tm,
         jnp.zeros((FEAT_ROWS - 11, R), jnp.float32)],
        axis=0,
    )
    return rows


def _interval_prod_bounds(xlo, xhi, ylo, yhi):
    """Elementwise interval product bounds: [xlo,xhi] * [ylo,yhi]."""
    p1 = xlo * ylo
    p2 = xlo * yhi
    p3 = xhi * ylo
    p4 = xhi * yhi
    pmin = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
    pmax = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
    return pmin, pmax


def _block_cluster_intervals(cl_lo, cl_hi, o, d, block):
    """Conservative per-(block, cluster) slab-test intervals.

    Returns (tnear_lo, tfar_hi): LOWER bound of the entry distance and
    UPPER bound of the exit distance of cluster c for ANY ray in block b
    — the interval-arithmetic 'coarse BVH' of the two-phase intersector.
    """
    R = o.shape[0]
    B = R // block
    tiny = 1e-20
    dd = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / dd
    o_b = o.reshape(B, block, 3)
    i_b = inv.reshape(B, block, 3)
    olo = o_b.min(1)[:, None, :]  # (B, 1, 3)
    ohi = o_b.max(1)[:, None, :]
    ilo = i_b.min(1)[:, None, :]
    ihi = i_b.max(1)[:, None, :]
    # Per axis: products (plane - o) * inv over plane in {lo, hi} corners.
    a_lo = cl_lo[None, :, :] - ohi  # (B, C, 3) lower end of (lo - o)
    a_hi = cl_lo[None, :, :] - olo
    b_lo = cl_hi[None, :, :] - ohi
    b_hi = cl_hi[None, :, :] - olo
    pmin_a, pmax_a = _interval_prod_bounds(a_lo, a_hi, ilo, ihi)
    pmin_b, pmax_b = _interval_prod_bounds(b_lo, b_hi, ilo, ihi)
    ax_min = jnp.minimum(pmin_a, pmin_b)  # lower bound of min(t0, t1)
    ax_max = jnp.maximum(pmax_a, pmax_b)  # upper bound of max(t0, t1)
    tnear_lo = jnp.max(ax_min, axis=-1)  # (B, C)
    tfar_hi = jnp.min(ax_max, axis=-1)
    return tnear_lo, tfar_hi


# Per-ray line cull at CLUSTER granularity is affordable up to this
# many clusters ((R, C) dense slab tests); beyond it the super-cluster
# mask (ray_super_mask) provides the same effect at ~C/32 granularity.
RAY_CULL_MAX_C = 512


def ray_cluster_mask(cl_lo, cl_hi, o, d, t_max, block: int = RAY_TILE):
    """(B, C) per-ray line cull at CLUSTER granularity.

    The per-BLOCK interval cone over hemisphere-scattered bounce rays
    covers most of a small scene, and the super mask is useless there
    (cornell has 2 supers). This mask slab-tests every RAY against
    every CLUSTER box (dense (R, C) — affordable for small scenes,
    <= RAY_CULL_MAX_C clusters) within the ray's own
    [T_MIN, t_max], and cluster c survives for block b iff SOME ray in
    b crosses it: the block list shrinks to the exact union of its
    rays' line needs.

    Sound: a hit at t < t_max lies on the ray's line inside the
    cluster box, so the (inflated — same fp-conservatism policy as
    build_supers) slab test keeps that cluster; dropping never loses a
    hit. The hit set — and the rendered image — is bit-unchanged.
    """
    R = o.shape[0]
    B = R // block
    tiny = 1e-20
    dd = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / dd
    pad = 1e-6 * jnp.maximum(jnp.abs(cl_lo), jnp.abs(cl_hi)) + 1e-7
    lo = cl_lo - pad
    hi = cl_hi + pad
    # Per-axis accumulation keeps the largest live intermediate at
    # (R, C) instead of (R, C, 3).
    t_in = jnp.full((R, cl_lo.shape[0]), -jnp.inf, jnp.float32)
    t_out = jnp.full((R, cl_lo.shape[0]), jnp.inf, jnp.float32)
    for ax in range(3):
        t0 = (lo[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (hi[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t_in = jnp.maximum(t_in, jnp.minimum(t0, t1))
        t_out = jnp.minimum(t_out, jnp.maximum(t0, t1))
    tm = jnp.asarray(t_max, jnp.float32)[:, None]
    crossed = (t_out >= jnp.maximum(t_in, C.T_MIN)) & (t_in <= tm)
    return crossed.reshape(B, block, -1).any(axis=1)  # (B, C)


def ray_super_mask(su_lo, su_hi, cl_super, o, d, t_max,
                   block: int = RAY_TILE):
    """(B, C) per-ray line-union cull at super-cluster granularity.

    The per-block interval cull (_block_cluster_intervals) keeps every
    cluster in the block's origin-direction CONE; a single ray only
    crosses the clusters on its LINE. At large cluster counts the cone
    holds thousands while the union of 512 lines holds dozens — the
    big_mesh collapse of block-level culls. This mask restores per-ray
    precision while staying fully dense: every ray slab-tests every
    SUPER box (supers = ~32-cluster groups, accel/clusters.py:
    build_supers), each against its OWN [T_MIN, t_max] interval, and
    cluster c survives for block b iff some ray in b crosses super(c).

    Sound: cluster boxes are contained in their (inflated) super box,
    so a ray that crosses a cluster within its bounds crosses the super
    too — dropping never loses a hit at t < t_max.
    """
    R = o.shape[0]
    B = R // block
    tiny = 1e-20
    dd = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / dd
    t0 = (su_lo[None, :, :] - o[:, None, :]) * inv[:, None, :]  # (R, S, 3)
    t1 = (su_hi[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t_in = jnp.max(jnp.minimum(t0, t1), axis=-1)  # (R, S)
    t_out = jnp.min(jnp.maximum(t0, t1), axis=-1)
    tm = jnp.asarray(t_max, jnp.float32)[:, None]
    crossed = (t_out >= jnp.maximum(t_in, C.T_MIN)) & (t_in <= tm)
    block_super = crossed.reshape(B, block, -1).any(axis=1)  # (B, S)
    return block_super[:, cl_super]  # (B, C)


def cull_mask(cl_lo, cl_hi, o, d, block: int = RAY_TILE):
    """Conservative (n_blocks, C) i32 mask: 0 => no ray in block i can hit
    cluster c."""
    tnear_lo, tfar_hi = _block_cluster_intervals(cl_lo, cl_hi, o, d, block)
    hit = tfar_hi >= jnp.maximum(tnear_lo, C.T_MIN)
    return hit.astype(jnp.int32)


def cull_candidates(cl_lo, cl_hi, o, d, block: int = RAY_TILE,
                    max_cand: int | None = None, t_max=None,
                    extra_mask=None):
    """Per-ray-block candidate cluster lists, near-first.

    Same conservative interval slab test as cull_mask, additionally
    keeping the LOWER bound of the entry distance so candidates are
    ordered front-to-back — the kernels visit them in this order and
    early-terminate on it. With per-ray `t_max` (shadow queries),
    clusters entirely beyond the block's farthest bound are culled too.
    `extra_mask` ((B, C) bool, e.g. ray_super_mask) is ANDed in.

    Returns (cand, count, tnear, overflow):
      cand: (B, K) i32 cluster ids, -1 padded, sorted by tnear_lo
      count: (B,) i32 number of valid candidates per block (uncapped)
      tnear: (B, K) f32 sorted entry-distance lower bounds (T_FAR padded)
      overflow: () bool — some block exceeded K (K < C only)
    """
    n_clusters = cl_lo.shape[0]
    K = n_clusters if max_cand is None else min(max_cand, n_clusters)
    tnear_lo, tfar_hi = _block_cluster_intervals(cl_lo, cl_hi, o, d, block)
    hit = tfar_hi >= jnp.maximum(tnear_lo, C.T_MIN)
    if t_max is not None:
        B = o.shape[0] // block
        block_tmax = jnp.asarray(t_max, jnp.float32).reshape(B, block)
        hit = hit & (tnear_lo < block_tmax.max(1)[:, None])
    if extra_mask is not None:
        hit = hit & extra_mask
    count = hit.sum(axis=1).astype(jnp.int32)  # (B,)
    key = jnp.where(hit, tnear_lo, jnp.inf)
    order = jnp.argsort(key, axis=1)[:, :K].astype(jnp.int32)  # (B, K)
    tkey = jnp.take_along_axis(key, order, axis=1).astype(jnp.float32)
    rank = jax.lax.broadcasted_iota(jnp.int32, order.shape, 1)
    in_range = rank < count[:, None]
    cand = jnp.where(in_range, order, -1)
    tnear = jnp.where(in_range, tkey, C.T_FAR)
    overflow = jnp.max(count) > K
    return cand, count, tnear, overflow


def _decode_winner(geom, slot, t_best):
    """(t, n, mat) from the winning padded cluster slot per ray.

    Uses the pre-joined (C*128, 8) cl_slot_nm row table when present —
    ONE well-shaped row gather instead of the cl_map -> tri_n ->
    tri_mat chain.
    """
    if geom.cl_slot_nm.shape[0] > 0:
        row_nm = jnp.asarray(geom.cl_slot_nm)[jnp.maximum(slot, 0)]
        hit = (slot >= 0) & (row_nm[:, 4] > 0.0)
        n_best = jnp.where(hit[:, None], row_nm[:, 0:3], 0.0)
        m_best = jnp.where(hit, row_nm[:, 3].astype(jnp.int32), 0)
    else:
        hit = slot >= 0
        best = jnp.where(
            hit, jnp.asarray(geom.cl_map)[jnp.maximum(slot, 0)], -1
        )
        hit = best >= 0  # padding slots never win, but be safe
        safe = jnp.maximum(best, 0)
        n_best = jnp.where(hit[:, None],
                           jnp.asarray(geom.tri_n)[safe], 0.0)
        m_best = jnp.where(hit, jnp.asarray(geom.tri_mat)[safe], 0)
    t_out = jnp.where(hit, t_best, C.T_FAR)
    return t_out, n_best, m_best


def _pad_rays(o, d, t_max, block):
    """Pad ray arrays to a whole number of `block`-ray blocks."""
    R0 = o.shape[0]
    pad = (-R0) % block
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], d.dtype), (pad, 1))]
        )
        if t_max is not None:
            # Pad lanes share the final partial block with real rays and
            # the ordered early exit uses the block-wide max of best-t, so
            # pad with T_MIN (the engine's dead-lane canonicalization):
            # a T_FAR pad lane would pin that block's exit bound at its
            # scene-box exit and defeat the shadow distance cap.
            t_max = jnp.concatenate(
                [jnp.asarray(t_max, jnp.float32),
                 jnp.full((pad,), C.T_MIN, jnp.float32)]
            )
    return o, d, t_max


def exit_bound(cl_lo, cl_hi, o, d):
    """Per-ray scene-box exit distance — a universal t upper bound.

    Every cluster (hence every triangle) lies inside the union AABB of
    the cluster boxes, so no ray can hit anything beyond the point where
    it exits that box. Initializing best-t at this bound lets rays that
    MISS the scene resolve their ordered walk after the near candidates
    instead of scanning to T_FAR (the dominant cost of open scenes).
    The small relative+absolute epsilon
    keeps boundary triangles (exactly on a box face) strictly inside the
    bound. Rays that miss the box entirely get ~0 => zero walk work.
    """
    lo = jnp.min(cl_lo, axis=0)
    hi = jnp.max(cl_hi, axis=0)
    tiny = 1e-20
    dd = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / dd
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    t_exit = jnp.min(jnp.maximum(t0, t1), axis=-1)
    # Clamp to T_FAR: a bound above T_FAR would let an all-miss cluster
    # visit (tc == T_FAR) read as an "improvement" and return slot >= 0
    # with stale normal/material for direct API callers.
    return jnp.minimum(jnp.maximum(t_exit, 0.0) * 1.0001 + 1e-3, C.T_FAR)


def closest_hit_cluster(geom, o, d, interpret: bool | None = None,
                        use_cull: bool = True, t_max=None):
    """Drop-in closest hit via the dense cluster kernel.

    Same contract as engine/intersect.py:brute / accel/traverse.py:
    (t, n_geom, mat) with t == T_FAR on miss. Requires cluster tables on
    the Geometry (accel/clusters.py:with_clusters). Sphere primitives are
    merged via the brute sphere path (spheres are few).

    t_max: optional (R,) per-ray t upper bound; hits at t >= t_max[i] MAY
    be reported as misses (exactly right for shadow/visibility queries —
    see _ray_features). Hits strictly nearer are always found.
    interpret: None picks interpret_for(jax.default_backend()).
    """
    if interpret is None:
        interpret = interpret_for(jax.default_backend())
    n_clusters = geom.cl_lo.shape[0]
    assert n_clusters > 0, "no cluster tables: call with_clusters(scene)"
    o = jnp.asarray(o)
    d = jnp.asarray(d)
    R0 = o.shape[0]
    block = RAY_TILE
    o_p, d_p, t_max_p = _pad_rays(o, d, t_max, block)
    # Cap every ray at its scene-box exit (see exit_bound): miss rays
    # then early-terminate the ordered walk instead of scanning to T_FAR.
    t_exit = exit_bound(jnp.asarray(geom.cl_lo), jnp.asarray(geom.cl_hi),
                        o_p, d_p)
    t_max_p = t_exit if t_max_p is None else jnp.minimum(
        jnp.asarray(t_max_p, jnp.float32), t_exit
    )

    rayf = _ray_features(o_p, d_p, t_max_p)
    B = o_p.shape[0] // block
    if use_cull:
        # Per-ray line cull: exact cluster granularity when the scene
        # is small enough for the dense (R, C) test (see RAY_CULL_MAX_C),
        # else super granularity.
        extra = None
        if 1 < n_clusters <= RAY_CULL_MAX_C:
            extra = ray_cluster_mask(
                jnp.asarray(geom.cl_lo), jnp.asarray(geom.cl_hi),
                o_p, d_p, t_max_p, block,
            )
        elif geom.su_lo.shape[0] > 1:
            extra = ray_super_mask(
                jnp.asarray(geom.su_lo), jnp.asarray(geom.su_hi),
                jnp.asarray(geom.cl_super), o_p, d_p, t_max_p, block,
            )
        # K = C: the dense candidate list can never overflow — exact.
        cand, count, tnear, _ = cull_candidates(
            jnp.asarray(geom.cl_lo), jnp.asarray(geom.cl_hi), o_p, d_p,
            block, t_max=t_max_p, extra_mask=extra,
        )
    else:
        # Visit everything in index order with early exit disabled
        # (tnear = -inf): the pure-performance filter off switch.
        cand = jnp.broadcast_to(
            jnp.arange(n_clusters, dtype=jnp.int32)[None, :],
            (B, n_clusters),
        )
        count = jnp.full((B,), n_clusters, jnp.int32)
        tnear = jnp.full((B, n_clusters), -jnp.inf, jnp.float32)
    t_best, slot = walk_candidates(cand, count, tnear, rayf,
                                   jnp.asarray(geom.cl_feat), interpret)
    t_best = t_best[:R0]
    slot = slot[:R0]
    t_out, n_best, m_best = _decode_winner(geom, slot, t_best)

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
