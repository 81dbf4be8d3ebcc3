"""Scene data model: flat SoA arrays + differentiable material pytree.

The reference keeps its scene as C++ structs — AoS triangle/material arrays
and a pointer-linked BVH node tree uploaded with cudaMemcpy (SURVEY.md §1.2
L1, §2.1 R6/R8). A batched design instead stores everything as flat
structure-of-arrays so XLA can lay tensors out contiguously, gathers are
vectorized, and the whole scene is a single pytree that `device_put`s once
and shards/replicates with `jax.sharding` (SURVEY.md §1.3 T1).

Three pytrees:

* :class:`Geometry` — triangles (SoA: v0/e1/e2, geometric normal, material
  id), analytic spheres, and the flattened BVH (see accel/build.py for the
  layout). Never differentiated: the renderer detaches it (SURVEY.md §7
  hard part 3).
* :class:`Materials` — per-material albedo and emission. This is THE
  differentiable parameter pytree (BASELINE.json:5 "reverse-mode gradients
  of pixel radiance w.r.t. material albedo/emission").
* :class:`Camera` — pinhole camera.

`Scene` bundles them with the emissive-triangle light table used by
next-event estimation.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np


def _pytree_dataclass(cls):
    """Register a frozen dataclass whose every field is a pytree leaf."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
class Geometry:
    """Static scene geometry as flat SoA arrays.

    Triangle i is (v0[i], v0[i]+e1[i], v0[i]+e2[i]); storing edges directly
    feeds Möller–Trumbore without re-deriving them per ray. `tri_n` is the
    normalized geometric normal (cross(e1, e2) direction).

    The BVH arrays use the stackless skip-link layout produced by
    accel/build.py: depth-first node order where a box hit advances the
    cursor to `i+1` (first child) and a miss jumps to `bvh_skip[i]`;
    `bvh_count[i] > 0` marks a leaf owning triangles
    `[bvh_first[i], bvh_first[i] + bvh_count[i])` (triangles are reordered
    at build time so leaves are contiguous). `n_nodes` is the termination
    sentinel. Empty (0-length) BVH arrays mean "no BVH" (brute force).
    """

    tri_v0: jax.Array  # (T, 3) f32
    tri_e1: jax.Array  # (T, 3) f32
    tri_e2: jax.Array  # (T, 3) f32
    tri_n: jax.Array  # (T, 3) f32, unit geometric normal
    tri_mat: jax.Array  # (T,) i32
    sph_c: jax.Array  # (S, 3) f32 sphere centers
    sph_r: jax.Array  # (S,) f32 radii
    sph_mat: jax.Array  # (S,) i32
    bvh_lo: jax.Array  # (N, 3) f32 AABB min
    bvh_hi: jax.Array  # (N, 3) f32 AABB max
    bvh_first: jax.Array  # (N,) i32 first-triangle (leaf) / unused (internal)
    bvh_count: jax.Array  # (N,) i32 0 = internal, >0 = leaf triangle count
    bvh_skip: jax.Array  # (N,) i32 next cursor on box miss / after leaf
    # Per-material-id scatter type table (constants.MAT_DIFF/SPEC/REFR) and
    # dielectric index of refraction. These live in Geometry, NOT Materials,
    # because they are structural (non-differentiable) scene data: jax.grad
    # runs w.r.t. the Materials pytree only, and keeping int/ior tables out
    # of it keeps the optimizer pytrees purely float (SURVEY.md §7 part 3).
    mat_type: jax.Array  # (M,) i32
    mat_ior: jax.Array  # (M,) f32 (used when mat_type == MAT_REFR)
    # Cluster tables for the dense cluster intersector (accel/clusters.py,
    # ops/intersect_cluster.py): triangles grouped into 128-wide padded
    # clusters with one AABB each. `cl_feat` holds the Plücker-style
    # per-triangle feature columns the hit-query kernel dots rays with;
    # `cl_map` maps padded cluster slots back to original triangle indices
    # (-1 for padding). Empty (0-length) arrays mean "no clusters built".
    cl_lo: jax.Array  # (C, 3) f32 cluster AABB min
    cl_hi: jax.Array  # (C, 3) f32 cluster AABB max
    cl_feat: jax.Array  # (16, C*512) f32 feature columns
    cl_map: jax.Array  # (C*128,) i32 padded slot -> original tri index
    # Super-cluster tables for the per-ray line cull on large scenes
    # (accel/clusters.py:build_supers): clusters grouped ~32 at a time;
    # every ray is slab-tested against every super box so candidate
    # lists shrink from the block's cone to the union of its rays'
    # lines (ops/intersect_cluster.py:ray_super_mask). Empty = no supers.
    su_lo: jax.Array  # (S, 3) f32 super AABB min (slightly inflated)
    su_hi: jax.Array  # (S, 3) f32 super AABB max
    cl_super: jax.Array  # (C,) i32 cluster -> super id
    # Pre-joined per-SLOT hit attributes for the cluster kernel's winner
    # decode: row = [n(3), mat, valid, pad(3)] per padded cluster slot. One well-shaped (R, 8)
    # row gather replaces the cl_map -> tri_n -> tri_mat gather chain.
    # Empty = fall back to the chain.
    cl_slot_nm: jax.Array  # (C*128, 8) f32


@_pytree_dataclass
class Materials:
    """Differentiable material parameters (the pytree jax.grad sees)."""

    albedo: jax.Array  # (M, 3) f32 in [0, 1]
    emission: jax.Array  # (M, 3) f32 radiance, >= 0


@_pytree_dataclass
class Camera:
    """Pinhole camera. `fov_y` is the vertical field of view in radians."""

    position: jax.Array  # (3,) f32
    look_at: jax.Array  # (3,) f32
    up: jax.Array  # (3,) f32
    fov_y: jax.Array  # () f32


@_pytree_dataclass
class Lights:
    """Emissive-surface table for next-event estimation.

    NEE samples a point uniformly by area over ALL emissive surfaces —
    triangles and analytic spheres: `cdf` is the normalized cumulative area
    distribution over the concatenation [tri_idx lights..., sph_idx
    lights...] (triangles first — light_rows/_sample_light rely on this
    order), and `total_area` converts the per-area pdf (1/total_area)
    into the estimator weight (SURVEY.md §3.1 NEE step). Sphere lights
    use uniform-by-area surface sampling (area 4*pi*r^2); back-facing
    samples (cos_l <= 0) contribute zero, exactly the surface-integral
    visibility of an opaque emitter, so the estimator stays unbiased.
    """

    tri_idx: jax.Array  # (Lt,) i32 indices into Geometry triangles
    sph_idx: jax.Array  # (Ls,) i32 indices into Geometry spheres
    cdf: jax.Array  # (Lt+Ls,) f32 normalized cumulative area
    total_area: jax.Array  # () f32
    background: jax.Array  # (3,) f32 environment radiance on ray miss


@_pytree_dataclass
class Scene:
    geometry: Geometry
    materials: Materials
    camera: Camera
    lights: Lights


def make_geometry(
    tri_verts: np.ndarray,
    tri_mat: np.ndarray,
    sph_c: np.ndarray | None = None,
    sph_r: np.ndarray | None = None,
    sph_mat: np.ndarray | None = None,
    mat_type: np.ndarray | None = None,
    mat_ior: np.ndarray | None = None,
) -> Geometry:
    """Build a Geometry (without BVH) from a (T, 3, 3) vertex array.

    mat_type/mat_ior are per-material-id tables (see Geometry docstring);
    omitted, every material is Lambertian (MAT_DIFF) — the pre-extension
    default, so all-diffuse scenes are unchanged.
    """
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-20)
    if sph_c is None:
        sph_c = np.zeros((0, 3), np.float32)
        sph_r = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)
    tri_mat = np.asarray(tri_mat, np.int32)
    sph_mat_a = np.asarray(sph_mat, np.int32).reshape(-1)
    n_mats = int(
        max(
            tri_mat.max(initial=-1),
            sph_mat_a.max(initial=-1),
        )
    ) + 1
    if mat_type is None:
        mat_type = np.zeros((n_mats,), np.int32)  # all MAT_DIFF
    if mat_ior is None:
        mat_ior = np.full((n_mats,), 1.5, np.float32)
    empty3 = np.zeros((0, 3), np.float32)
    empty1i = np.zeros((0,), np.int32)
    return Geometry(
        tri_v0=v0.astype(np.float32),
        tri_e1=e1.astype(np.float32),
        tri_e2=e2.astype(np.float32),
        tri_n=n.astype(np.float32),
        tri_mat=tri_mat,
        sph_c=np.asarray(sph_c, np.float32).reshape(-1, 3),
        sph_r=np.asarray(sph_r, np.float32).reshape(-1),
        sph_mat=sph_mat_a,
        bvh_lo=empty3,
        bvh_hi=empty3,
        bvh_first=empty1i,
        bvh_count=empty1i,
        bvh_skip=empty1i,
        mat_type=np.asarray(mat_type, np.int32).reshape(-1),
        mat_ior=np.asarray(mat_ior, np.float32).reshape(-1),
        cl_lo=empty3,
        cl_hi=empty3,
        cl_feat=np.zeros((16, 0), np.float32),
        cl_map=empty1i,
        su_lo=empty3,
        su_hi=empty3,
        cl_super=empty1i,
        cl_slot_nm=np.zeros((0, 8), np.float32),
    )


def triangle_areas(geom: Geometry) -> np.ndarray:
    e1 = np.asarray(geom.tri_e1)
    e2 = np.asarray(geom.tri_e2)
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def make_lights(
    geom: Geometry, materials: Materials, background=(0.0, 0.0, 0.0)
) -> Lights:
    """Derive the NEE light table from emissive materials.

    Both TRIANGLES and analytic SPHERES with emissive materials become
    NEE lights (skipping spheres would make a diffuse-reached emissive
    sphere silently lose energy). Sampling is uniform by area over the union: triangle areas
    from the edge cross products, sphere areas 4*pi*r^2. Triangle
    lights come first in the cdf — light_rows (engine) and
    _sample_light (oracle) decode "sphere light" by cdf position.
    """
    emission = np.asarray(materials.emission)
    tri_mat = np.asarray(geom.tri_mat)
    emissive = emission.sum(-1) > 0.0
    mask = emissive[tri_mat]
    idx = np.nonzero(mask)[0].astype(np.int32)
    sph_mat = np.asarray(geom.sph_mat)
    sidx = (np.nonzero(emissive[sph_mat])[0].astype(np.int32)
            if sph_mat.size else np.zeros((0,), np.int32))
    t_areas = (triangle_areas(geom)[idx] if idx.size
               else np.zeros((0,), np.float64))
    s_areas = (4.0 * np.pi * np.asarray(geom.sph_r)[sidx] ** 2
               if sidx.size else np.zeros((0,), np.float64))
    areas = np.concatenate([t_areas, s_areas])
    if areas.size == 0:
        return Lights(
            tri_idx=np.zeros((0,), np.int32),
            sph_idx=np.zeros((0,), np.int32),
            cdf=np.zeros((0,), np.float32),
            total_area=np.float32(0.0),
            background=np.asarray(background, np.float32),
        )
    total = float(areas.sum())
    cdf = np.cumsum(areas / total).astype(np.float32)
    cdf[-1] = 1.0
    return Lights(
        tri_idx=idx,
        sph_idx=sidx,
        cdf=cdf,
        total_area=np.float32(total),
        background=np.asarray(background, np.float32),
    )


def scene_to_device(scene: Scene, sharding=None) -> Scene:
    """device_put the whole scene pytree (replicated unless told otherwise).

    Mirrors the reference's one-time cudaMemcpy upload of scene arrays
    (SURVEY.md §3.2) — one host→device transfer, then every render reuses
    the committed buffers.
    """
    if sharding is None:
        return jax.device_put(scene)
    return jax.device_put(scene, sharding)
