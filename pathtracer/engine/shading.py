"""Diffuse shading + sampling (jnp mirror of the oracle; reference R4).

Everything here is elementwise over the ray batch — XLA fuses the whole
shade/sample stage into the surrounding bounce iteration, which is exactly
the fusion the reference gets for free inside its megakernel
(SURVEY.md §3.1) without the divergence cost.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def onb(n):
    """Branchless Duff/Frisvad orthonormal basis; n: (R,3) unit normals."""
    s = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = jnp.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], axis=-1
    )
    bt = jnp.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=-1)
    return t, bt


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about unit normal n (pdf = cos/pi)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    t, b = onb(n)
    d = x[:, None] * t + y[:, None] * b + z[:, None] * n
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def reflect(d, n_shade, cos_o):
    """Mirror reflection of d about unit normal n_shade; cos_o = dot(n,-d)."""
    return d + 2.0 * cos_o[:, None] * n_shade


def refract_dir(d, n_shade, cos_o, eta):
    """Snell refraction of d through n_shade (normal toward the ray side).

    Returns (t_dir, tir): the unit transmitted direction (garbage when tir
    is True — caller must select the reflection there) and the
    total-internal-reflection mask.
    """
    k = 1.0 - eta * eta * (1.0 - cos_o * cos_o)
    tir = k < 0.0
    t = eta[:, None] * d + (
        eta * cos_o - jnp.sqrt(jnp.maximum(k, 0.0))
    )[:, None] * n_shade
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-20)
    return t, tir


def schlick(cos_x, ior):
    """Schlick Fresnel reflectance for a dielectric of index ior."""
    r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    return r0 + (1.0 - r0) * (1.0 - jnp.clip(cos_x, 0.0, 1.0)) ** 5


def sample_light(lights, geom, u_sel, u1, u2, emission=None):
    """Uniform-by-area point on emissive surfaces (oracle _sample_light).

    Triangles use the standard sqrt-barycentric warp; sphere lights
    (round 5) use uniform-on-the-sphere surface sampling (z = 1-2*u1,
    phi = 2*pi*u2) with the sampled normal as the light normal. Both
    decode from the same pre-joined row table; the sphere branch is
    SKIPPED STATICALLY when the scene has no sphere lights
    (lights.sph_idx.shape[0] == 0), so triangle-only scenes trace the
    exact pre-sphere program.

    Returns (x_l, n_l, mat_l) — or (x_l, n_l, mat_l, emis_l) when the
    differentiable `emission` table (M, 3) is passed: the sampled
    light's emission then rides the SAME pre-joined row gather (the
    rows' pad columns), replacing the engine's separate (N, 16)
    material-row gather per NEE stage. Bit-identical values:
    emission passes through concat -> two row gathers -> slice, all
    movement-only; grads flow through the concat (transpose = slice).
    Caller must only use this when the scene has a non-empty light
    table (static shape check at trace time).
    """
    su = jnp.sqrt(u1)
    rows = gather_light_rows(light_rows(lights, geom, emission),
                             lights.cdf, u_sel)
    x_l = rows[:, 0:3] + (1.0 - su)[:, None] * rows[:, 3:6] \
        + (u2 * su)[:, None] * rows[:, 6:9]
    n_l = rows[:, 9:12]
    mat_f = rows[:, 12]
    if int(lights.sph_idx.shape[0]) > 0:
        # Sphere rows carry mat encoded as -(mat+1) (see light_rows).
        is_sph = mat_f < 0.0
        z = 1.0 - 2.0 * u1
        phi = 2.0 * jnp.pi * u2
        s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
        n_sph = jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], axis=1)
        x_sph = rows[:, 0:3] + rows[:, 3:4] * n_sph
        x_l = jnp.where(is_sph[:, None], x_sph, x_l)
        n_l = jnp.where(is_sph[:, None], n_sph, n_l)
        mat_f = jnp.where(is_sph, -mat_f - 1.0, mat_f)
    mat_l = mat_f.astype(jnp.int32)
    if emission is None:
        return x_l, n_l, mat_l
    return x_l, n_l, mat_l, rows[:, 13:16]


def light_rows(lights, geom, emission=None):
    """(L, 16) pre-joined light rows, triangle lights then sphere lights.

    Triangle rows: [v0, e1, e2, n, mat, emis|pad]. Sphere rows:
    [center, (r,0,0), 0(3), 0(3), -(mat+1), emis|pad] — the negated
    material id is the type flag sample_light branches on (exact: ids
    are < 2^24, accel/clusters.py:slot_nm_table guard). Row order must
    match the make_lights cdf (triangles first).

    The winner-decode idea applied to NEE: ONE well-shaped 16-f32 row
    gather instead of five narrow per-array gathers of v0/e1/e2/n/mat.
    The join itself
    is (L,)-sized, traced once per program and CSE'd across bounces.
    """
    lt = lights.tri_idx
    L = lt.shape[0]
    mat_l = geom.tri_mat[lt]
    tail = (jnp.zeros((L, 3), jnp.float32) if emission is None
            else emission[mat_l])
    tri_rows = jnp.concatenate([
        geom.tri_v0[lt], geom.tri_e1[lt], geom.tri_e2[lt],
        geom.tri_n[lt],
        mat_l.astype(jnp.float32)[:, None],
        tail,
    ], axis=1)
    Ls = int(lights.sph_idx.shape[0])
    if Ls == 0:
        return tri_rows
    si = lights.sph_idx
    smat = geom.sph_mat[si]
    stail = (jnp.zeros((Ls, 3), jnp.float32) if emission is None
             else emission[smat])
    sph_rows = jnp.concatenate([
        geom.sph_c[si],
        geom.sph_r[si][:, None],
        jnp.zeros((Ls, 8), jnp.float32),
        (-(smat.astype(jnp.float32) + 1.0))[:, None],
        stail,
    ], axis=1)
    return jnp.concatenate([tri_rows, sph_rows], axis=0)


def take_small_rows(rows, idx):
    """rows[idx] for SMALL differentiable row tables, scatter-free.

    The backward of a plain row gather is a scatter-add of N cotangent
    rows into L destinations, which serializes at small L (L=2 for the
    light table). This custom_vjp keeps the cheap gather as the primal
    and transposes via L masked dense REDUCTIONS — no scatter. Falls back
    to the plain gather (default AD) for larger tables, where the
    L-term reduction chain would cost more than the scatter it avoids.
    """
    if rows.shape[0] > 32:
        return rows[idx]
    return _take_small_rows(rows, idx)


@jax.custom_vjp
def _take_small_rows(rows, idx):
    return rows[idx]


def _take_small_fwd(rows, idx):
    return rows[idx], (idx, rows.shape[0])


def _take_small_bwd(res, g):
    idx, L = res
    # Mirror plain `rows[idx]` AD exactly so the two take_small_rows
    # paths (this custom_vjp and the >32-row fallback) produce
    # identical gradients for ANY index: jax wraps negative indices in
    # both directions, but its gather transpose DROPS cotangents of
    # clamped out-of-range indices (scatter drop semantics — verified
    # by probe: fwd clamps idx=L+2 to the last row, bwd contributes
    # nothing). Wrapping without clipping reproduces that: wrapped
    # indices match their row, out-of-range ones match nothing.
    eff = jnp.where(idx < 0, idx + L, idx)
    d_rows = jnp.stack([
        jnp.sum(jnp.where((eff == m)[:, None], g, 0.0), axis=0)
        for m in range(L)
    ])
    return d_rows, np.zeros(idx.shape, jax.dtypes.float0)


_take_small_rows.defvjp(_take_small_fwd, _take_small_bwd)


def gather_light_rows(rows, cdf, u_sel):
    """(N, 16) sampled light rows: CDF inversion + one row lookup."""
    idx = jnp.minimum(
        jnp.searchsorted(cdf, u_sel, side="right"), cdf.shape[0] - 1
    )
    return take_small_rows(rows, idx)
