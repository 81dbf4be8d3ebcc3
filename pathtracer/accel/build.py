"""Host-side BVH builder → flat SoA arrays with stackless skip links.

The reference builds a pointer-linked AoS node tree on the CPU and
traverses it with a per-thread stack on the GPU (SURVEY.md §2.1 R2/R6,
BASELINE.json:5 "AoS pointer nodes → SoA flat arrays"). Neither pointers
nor per-lane stacks suit a lockstep batched walk, so this builder emits a
*threaded* (skip-link) BVH in depth-first preorder:

    hit an interior node's box → advance cursor to i+1 (first child)
    miss the box / finish a leaf → jump to bvh_skip[i]
    cursor == n_nodes             → traversal done

which turns traversal into a single branchless while-loop with one int32
cursor per ray — ideal for the vectorized jnp traverser
(accel/traverse.py). Triangles are reordered so
every leaf owns a contiguous [first, first+count) range; all arrays are
flat SoA, ready to device_put.

Split policy: median split on the longest centroid-bounds axis (the
classic robust choice; binned SAH is a later native-builder upgrade —
SURVEY.md §7 hard part 6). Children are emitted near-axis-first, giving
front-to-back-ish visit order for coherent rays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..scene.model import Geometry, Scene


@dataclasses.dataclass
class FlatBVH:
    lo: np.ndarray  # (N, 3) f32
    hi: np.ndarray  # (N, 3) f32
    first: np.ndarray  # (N,) i32: leaf → first triangle; interior → unused
    count: np.ndarray  # (N,) i32: 0 interior, >0 leaf size
    skip: np.ndarray  # (N,) i32: cursor on miss / after leaf
    order: np.ndarray  # (T,) i32: new→old triangle permutation


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              max_leaf: int = 4) -> FlatBVH:
    """Build the flat skip-link BVH over triangles (v0, v0+e1, v0+e2)."""
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    T = len(v0)
    if T == 0:
        z3 = np.zeros((0, 3), np.float32)
        z1 = np.zeros((0,), np.int32)
        return FlatBVH(z3, z3, z1, z1, z1, z1)

    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    centroid = (tri_lo + tri_hi) * 0.5

    lo_l, hi_l, first_l, count_l, skip_l = [], [], [], [], []
    order: list[int] = []

    # Iterative DFS with an explicit frame stack; a frame is either
    # ("node", tri_ids) to emit a subtree or ("skip", node_idx) to patch
    # the skip pointer once the subtree is fully emitted.
    stack: list[tuple[str, object]] = [("node", np.arange(T, dtype=np.int64))]
    while stack:
        kind, payload = stack.pop()
        if kind == "skip":
            skip_l[payload] = len(lo_l)
            continue
        ids = payload
        my = len(lo_l)
        lo_l.append(tri_lo[ids].min(0))
        hi_l.append(tri_hi[ids].max(0))
        first_l.append(0)
        count_l.append(0)
        skip_l.append(-1)
        stack.append(("skip", my))
        if len(ids) <= max_leaf:
            first_l[my] = len(order)
            count_l[my] = len(ids)
            order.extend(int(i) for i in ids)
            continue
        c = centroid[ids]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            # All centroids identical: split by halves to guarantee progress.
            mid = len(ids) // 2
            left, right = ids[:mid], ids[mid:]
        else:
            key = c[:, axis]
            part = np.argsort(key, kind="stable")
            mid = len(ids) // 2
            left, right = ids[part[:mid]], ids[part[mid:]]
        # Push right first so left (near side on the axis) is emitted at i+1.
        stack.append(("node", right))
        stack.append(("node", left))

    return FlatBVH(
        lo=np.asarray(lo_l, np.float32),
        hi=np.asarray(hi_l, np.float32),
        first=np.asarray(first_l, np.int32),
        count=np.asarray(count_l, np.int32),
        skip=np.asarray(skip_l, np.int32),
        order=np.asarray(order, np.int32),
    )


# Above this triangle count, `with_bvh(engine="auto")` switches from the
# numpy median-split builder to the native C++ binned-SAH builder
# (accel/native.py) — the numpy recursion is too slow for config-5 scale.
AUTO_NATIVE_THRESHOLD = 100_000


def with_bvh(scene: Scene, max_leaf: int = 4, engine: str = "auto") -> Scene:
    """Scene with triangles reordered by leaf and BVH arrays attached.

    engine: "numpy" (median split, pure python/numpy, reproducible
    everywhere), "native" (C++ binned SAH, faster build and better trees),
    or "auto" (numpy below AUTO_NATIVE_THRESHOLD triangles, else native
    with numpy fallback). Light triangle indices are remapped through the
    permutation so NEE keeps pointing at the same physical triangles.
    """
    g = scene.geometry
    n_tris = int(np.asarray(g.tri_v0).shape[0])
    use_native = engine == "native" or (
        engine == "auto" and n_tris > AUTO_NATIVE_THRESHOLD
    )
    if use_native:
        from . import native

        if native.available():
            bvh = native.build_bvh_native(
                np.asarray(g.tri_v0), np.asarray(g.tri_e1),
                np.asarray(g.tri_e2), max_leaf,
            )
        elif engine == "native":
            raise RuntimeError("native BVH builder unavailable")
        else:
            bvh = build_bvh(
                np.asarray(g.tri_v0), np.asarray(g.tri_e1),
                np.asarray(g.tri_e2), max_leaf,
            )
    else:
        bvh = build_bvh(
            np.asarray(g.tri_v0), np.asarray(g.tri_e1),
            np.asarray(g.tri_e2), max_leaf,
        )
    perm = bvh.order  # new position i holds old triangle perm[i]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    g2 = dataclasses.replace(
        g,
        tri_v0=np.asarray(g.tri_v0)[perm],
        tri_e1=np.asarray(g.tri_e1)[perm],
        tri_e2=np.asarray(g.tri_e2)[perm],
        tri_n=np.asarray(g.tri_n)[perm],
        tri_mat=np.asarray(g.tri_mat)[perm],
        bvh_lo=bvh.lo,
        bvh_hi=bvh.hi,
        bvh_first=bvh.first,
        bvh_count=bvh.count,
        bvh_skip=bvh.skip,
    )
    lights = scene.lights
    lights2 = dataclasses.replace(
        lights, tri_idx=inv[np.asarray(lights.tri_idx)].astype(np.int32)
    )
    return dataclasses.replace(scene, geometry=g2, lights=lights2)


def check_invariants(bvh: FlatBVH, n_tris: int, max_leaf: int = 4) -> None:
    """Structural invariants (SURVEY.md §4.1): raises AssertionError."""
    n = len(bvh.lo)
    assert len(bvh.order) == n_tris
    assert sorted(bvh.order.tolist()) == list(range(n_tris)), (
        "every triangle in exactly one leaf"
    )
    assert (bvh.skip > np.arange(n)).all() and (bvh.skip <= n).all()
    leaf = bvh.count > 0
    assert (bvh.count[leaf] <= max_leaf).all()
    covered = np.zeros(n_tris, bool)
    for i in np.nonzero(leaf)[0]:
        covered[bvh.first[i]: bvh.first[i] + bvh.count[i]] = True
    assert covered.all(), "leaf ranges cover the reordered triangle array"
    # Parent boxes contain children: interior node i's children are i+1 and
    # skip[i+1]; check containment over the DFS structure with a stack.
    for i in range(n):
        if bvh.count[i] == 0:
            c1 = i + 1
            c2 = bvh.skip[c1]
            for c in (c1, c2):
                assert c < n
                assert (bvh.lo[i] <= bvh.lo[c] + 1e-6).all()
                assert (bvh.hi[i] >= bvh.hi[c] - 1e-6).all()
