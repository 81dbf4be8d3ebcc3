"""Triangle clustering for the dense cluster intersector (SURVEY.md §1.3-T2).

Intersection is posed as dense arithmetic over fixed-size triangle
groups instead of a per-ray pointer walk:

  1. HOST (this module): partition triangles into clusters of <= 128 by
     recursive median split (same policy as accel/build.py), pad each
     cluster to exactly 128 with degenerate triangles, compute one AABB
     per cluster, and precompute per-triangle *feature columns* such that
     every Möller-Trumbore quantity is a dot product with a shared
     per-ray feature vector (see below).
  2. XLA (ops/intersect_cluster.py): a conservative per-(ray-tile,
     cluster) cull from interval arithmetic and per-ray slab tests,
     sorted near-first into candidate lists.
  3. KERNEL (ops/intersect_cluster.py): each ray tile walks its
     candidate list; a visit tests the cluster's 128 triangles against
     every ray of the tile with f32 multiply-adds over the feature rows.

Feature algebra: with ray features F = [d, o x d, o, 1, 0...] (16) and
per-triangle columns

  det column: [e2 x e1, 0, 0, 0]            -> det   = e1 . (d x e2)
  u   column: [v0 x e2, e2, 0, 0]           -> u_num = tvec . (d x e2)
  v   column: [-(v0 x e1), -e1, 0, 0]       -> v_num = d . (tvec x e1)
  t   column: [0, 0, e1 x e2, -v0 . n]      -> t_num = e2 . (tvec x e1)

so  q = F . cols  gives (det, u*det, v*det, t*det) for all 128 triangles
of a cluster at once. Only rows 0-2 feed det, rows 0-5 feed u and v, and
rows 6-9 feed t; the kernel skips the rows that are zero by construction.
Degenerate padding triangles have all-zero columns (det = 0 -> never
hit), exactly like the brute-force predicate treats zero-det triangles.

Unlike accel/build.py:with_bvh, clustering does NOT permute the caller's
triangle arrays: `cl_map` maps padded cluster slots back to original
triangle indices, so lights/materials/goldens are untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..scene.model import Scene

CLUSTER_TRIS = 128  # triangles per padded cluster
FEAT_ROWS = 16  # ray-feature rows
QUANTITIES = 4  # det, u_num, v_num, t_num
CLUSTER_COLS = CLUSTER_TRIS * QUANTITIES  # feature columns per cluster


def empty_feat() -> np.ndarray:
    return np.zeros((FEAT_ROWS, 0), np.float32)


@dataclasses.dataclass
class ClusterSet:
    lo: np.ndarray  # (C, 3) f32 cluster AABB min
    hi: np.ndarray  # (C, 3) f32 cluster AABB max
    feat: np.ndarray  # (16, C*512) f32 feature columns
    tri_map: np.ndarray  # (C*128,) i32 padded slot -> original tri (-1 pad)


def _median_split_clusters(tri_lo, tri_hi, max_tris: int) -> list[np.ndarray]:
    """Partition triangle ids into spatial clusters of <= max_tris.

    Same median-split-on-longest-centroid-axis policy as
    accel/build.py:build_bvh, but terminating at cluster granularity —
    the tree above clusters is implicit (the cull mask replaces it).
    """
    T = len(tri_lo)
    centroid = (tri_lo + tri_hi) * 0.5
    out: list[np.ndarray] = []
    stack = [np.arange(T, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= max_tris:
            out.append(ids)
            continue
        c = centroid[ids]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            mid = len(ids) // 2
            stack.append(ids[mid:])
            stack.append(ids[:mid])
            continue
        part = np.argsort(c[:, axis], kind="stable")
        mid = len(ids) // 2
        stack.append(ids[part[mid:]])
        stack.append(ids[part[:mid]])
    return out


def cluster_tables(groups: list[np.ndarray], v0, e1, e2) -> ClusterSet:
    """Feature-column tables for an EXPLICIT cluster decomposition.

    `groups` is any list of triangle-id arrays, each of length
    <= CLUSTER_TRIS; ids MAY repeat across groups (duplicate hits are
    idempotent under the closest-hit min). build_clusters passes its
    median-split groups.
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    p1 = v0 + e1
    p2 = v0 + e2
    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    C = len(groups)

    # Padded (C, 128) slot -> triangle-id table (-1 padding), built once;
    # everything below is vectorized over all slots (a per-cluster Python
    # loop is ~16k iterations of fancy indexing on a 2M-triangle scene).
    tri_map = np.full((C, CLUSTER_TRIS), -1, np.int32)
    lens = np.fromiter((len(g) for g in groups), np.int64, count=C)
    assert (lens <= CLUSTER_TRIS).all()
    if C:
        flat = np.concatenate(groups) if len(groups) else \
            np.zeros((0,), np.int64)
        rows = np.repeat(np.arange(C), lens)
        cols = np.arange(len(flat)) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        tri_map[rows, cols] = flat
    valid = tri_map >= 0
    safe = np.maximum(tri_map, 0)

    big = np.float32(3.0e38)
    lo = np.where(valid[:, :, None], tri_lo[safe], big).min(1)
    hi = np.where(valid[:, :, None], tri_hi[safe], -big).max(1)

    # Per-triangle feature pieces (float64 cross products for accuracy,
    # rounded once at the end).
    v0d, e1d, e2d = v0.astype(np.float64), e1.astype(np.float64), \
        e2.astype(np.float64)
    n = np.cross(e1d, e2d)  # e1 x e2
    det_col = np.cross(e2d, e1d)  # = -n
    u_d = np.cross(v0d, e2d)
    v_d = -np.cross(v0d, e1d)
    t_c = -(v0d * n).sum(-1)

    # Assemble as (16, C, quantity, 128) then flatten: per cluster the
    # column layout is [det(128) | u(128) | v(128) | t(128)].
    feat4 = np.zeros((FEAT_ROWS, C, QUANTITIES, CLUSTER_TRIS), np.float64)
    vm = valid[None, :, :]  # (1, C, 128)

    def put(rows, q, src):  # src: (T, k) per-triangle rows
        feat4[rows, :, q, :] = np.where(vm, src[safe].transpose(2, 0, 1),
                                        0.0)

    put(slice(0, 3), 0, det_col)
    put(slice(0, 3), 1, u_d)
    put(slice(3, 6), 1, e2d)
    put(slice(0, 3), 2, v_d)
    put(slice(3, 6), 2, -e1d)
    put(slice(6, 9), 3, n)
    feat4[9, :, 3, :] = np.where(valid, t_c[safe], 0.0)
    feat = feat4.reshape(FEAT_ROWS, C * CLUSTER_COLS).astype(np.float32)
    return ClusterSet(lo=lo.astype(np.float32), hi=hi.astype(np.float32),
                      feat=feat,
                      tri_map=tri_map.reshape(-1))


def build_clusters(v0, e1, e2, max_tris: int = CLUSTER_TRIS) -> ClusterSet:
    """Cluster triangles (v0, v0+e1, v0+e2) and precompute feature columns."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    if len(v0) == 0:
        return ClusterSet(
            lo=np.zeros((0, 3), np.float32),
            hi=np.zeros((0, 3), np.float32),
            feat=empty_feat(),
            tri_map=np.zeros((0,), np.int32),
        )
    p1 = v0 + e1
    p2 = v0 + e2
    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    groups = _median_split_clusters(tri_lo, tri_hi, max_tris)
    return cluster_tables(groups, v0, e1, e2)


SUPER_GROUP = 32  # clusters per super-cluster (<= 4096 triangles)


def build_supers(cl_lo: np.ndarray, cl_hi: np.ndarray,
                 group: int = SUPER_GROUP):
    """Group clusters into super-clusters for the per-ray line cull.

    The per-BLOCK interval cull keeps every cluster inside the block's
    origin-direction CONE, but a ray only crosses the clusters on its
    LINE — at 16k clusters the cone holds thousands, the line ~dozens.
    The per-ray test stays dense by running at a coarser granularity:
    clusters are grouped into supers of <= `group`
    by the same median-split policy, every RAY is slab-tested against
    every SUPER box ((R, S) dense — S is ~C/group, small enough to
    afford), and a cluster survives for a ray block only if SOME ray in
    the block crosses its super within that ray's own t bounds
    (ops/intersect_cluster.py:ray_super_mask).

    Returns (su_lo, su_hi, cl_super):
      su_lo/su_hi: (S, 3) f32 super AABBs = union of member cluster
          boxes, inflated by a hair so f32 rounding in the per-ray slab
          test can never exclude a boundary crossing (conservative).
      cl_super: (C,) i32 cluster -> super id.
    """
    C = len(cl_lo)
    if C == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0,), np.int32))
    groups = _median_split_clusters(cl_lo, cl_hi, group)
    S = len(groups)
    su_lo = np.empty((S, 3), np.float32)
    su_hi = np.empty((S, 3), np.float32)
    cl_super = np.empty((C,), np.int32)
    for si, ids in enumerate(groups):
        lo = cl_lo[ids].min(0)
        hi = cl_hi[ids].max(0)
        pad = 1e-6 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-7
        su_lo[si] = lo - pad
        su_hi[si] = hi + pad
        cl_super[ids] = si
    return su_lo, su_hi, cl_super


def slot_nm_table(tri_map: np.ndarray, tri_n, tri_mat) -> np.ndarray:
    """(C*128, 8) pre-joined per-slot [n(3), mat, valid, pad(3)] rows.

    The winner decode of every cluster-table backend then needs ONE
    well-shaped row gather instead of the cl_map -> tri_n -> tri_mat
    gather chain."""
    n_slots = len(tri_map)
    valid = tri_map >= 0
    safe = np.maximum(tri_map, 0)
    tri_mat = np.asarray(tri_mat)
    # The material id round-trips through f32 (exact only below 2^24);
    # guard at build time so table growth can never corrupt silently.
    assert tri_mat.size == 0 or int(tri_mat.max()) < 2 ** 24, (
        "material ids >= 2^24 are not exactly representable in the f32 "
        "slot table; shrink the material table or extend slot_nm_table "
        "to an int32-bitcast column"
    )
    out = np.zeros((n_slots, 8), np.float32)
    out[:, 0:3] = np.asarray(tri_n)[safe]
    out[:, 3] = tri_mat[safe].astype(np.float32)
    out[:, 4] = valid.astype(np.float32)
    return out


def with_clusters(scene: Scene, max_tris: int = CLUSTER_TRIS,
                  super_group: int = SUPER_GROUP) -> Scene:
    """Scene with cluster tables attached to its Geometry (non-permuting)."""
    g = scene.geometry
    cs = build_clusters(
        np.asarray(g.tri_v0), np.asarray(g.tri_e1), np.asarray(g.tri_e2),
        max_tris,
    )
    su_lo, su_hi, cl_super = build_supers(cs.lo, cs.hi, super_group)
    g2 = dataclasses.replace(
        g, cl_lo=cs.lo, cl_hi=cs.hi, cl_feat=cs.feat, cl_map=cs.tri_map,
        su_lo=su_lo, su_hi=su_hi, cl_super=cl_super,
        cl_slot_nm=slot_nm_table(cs.tri_map, g.tri_n, g.tri_mat),
    )
    return dataclasses.replace(scene, geometry=g2)


def check_cluster_invariants(cs: ClusterSet, n_tris: int,
                             max_tris: int = CLUSTER_TRIS) -> None:
    """Structural invariants; raises AssertionError on violation."""
    C = len(cs.lo)
    assert cs.feat.shape == (FEAT_ROWS, C * CLUSTER_COLS)
    assert cs.tri_map.shape == (C * CLUSTER_TRIS,)
    real = cs.tri_map[cs.tri_map >= 0]
    assert sorted(real.tolist()) == list(range(n_tris)), (
        "every triangle in exactly one cluster slot"
    )
    per_cluster = (cs.tri_map.reshape(C, CLUSTER_TRIS) >= 0).sum(1)
    assert (per_cluster >= 1).all() and (per_cluster <= max_tris).all()
    assert (cs.lo <= cs.hi).all()
