"""CPU reference tracer: vectorized numpy, brute-force, obviously correct.

This is the allclose ORACLE for the whole framework (SURVEY.md §0.3): the
reference checkout at /root/reference was empty (mount failure, SURVEY.md
§0), so the acceptance criterion "pixel+grad allclose vs reference"
(BASELINE.json:2) is satisfied transitively through this module — a slow,
straightforward numpy implementation of exactly the estimator the reference
implements in tracer.cu (SURVEY.md §3.1: camera ray → bounce loop →
Möller–Trumbore / sphere hits → emissive + NEE + cosine sampling + Russian
roulette → accumulate). Every engine path (jnp, Pallas, sharded) validates
against it at fixed seeds.

Design rules for this file:
  * numpy only for the math; no acceleration structure (brute force over
    all primitives, chunked over rays to bound memory);
  * randomness comes from sampling/rng.py evaluated on the JAX CPU backend,
    so the oracle consumes bit-identical threefry draws as the JAX tracer;
  * structure mirrors the estimator definition, not the JAX implementation.

Estimator (shared contract, see also engine/wavefront.py):
  * emission is added on front-face hits reached via the camera ray or a
    delta (SPEC/REFR) scatter; hits reached via a diffuse scatter rely on
    next-event estimation for their direct light (no double counting);
  * materials scatter by Geometry.mat_type: MAT_DIFF cosine-sampled
    Lambertian with NEE, MAT_SPEC perfect mirror, MAT_REFR smooth
    dielectric with Schlick-Fresnel reflect/refract selection (TIR
    reflects); all three tint throughput by albedo;
  * on a miss, background radiance weighted by throughput is added and the
    path ends;
  * diffuse BRDF albedo/pi, cosine-weighted hemisphere sampling (pdf
    cos/pi, so throughput *= albedo per bounce);
  * NEE: one uniform-by-area sample over emissive triangles per vertex,
    contribution T * albedo/pi * Le * cos_s * cos_l * A_total / d^2 when
    both cosines are positive and the shadow ray is unoccluded;
  * Russian roulette from bounce index `rr_start`, continuation probability
    clamp(max(throughput), RR_CLAMP_LO, RR_CLAMP_HI);
  * optional MIS (cfg.mis, SURVEY.md §3.1 "+MIS/NEE bookkeeping"): at
    diffuse vertices BOTH strategies estimate direct light — the NEE
    sample weighted by the power heuristic against the cosine-BSDF pdf,
    and an emissive hit reached via a diffuse scatter weighted by the
    power heuristic against the NEE pdf of that same light point
    (solid-angle pdf d^2 / (cos_l * A_total)). Weights sum to 1 per
    transport term, so the estimator stays unbiased; the last path vertex
    keeps full NEE weight because its BSDF-hit counterpart is truncated
    by max_depth. Delta (SPEC/REFR) chains keep weight 1 — NEE cannot
    sample through them. Emissive *spheres* are in the NEE light table
    too (round 5, uniform-by-area over 4*pi*r^2): both the NEE pdf and
    the BSDF-hit MIS counterweight use the same 1/A_total area measure,
    so the weighting is exact for either light type.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..config import RenderConfig
from ..sampling import rng as rng_mod
from ..scene.model import Scene

_RAY_CHUNK = 8192  # rays per brute-force intersection chunk (memory bound)


def _np_uniforms(fn, *args):
    """Evaluate a sampling/rng.py function on the JAX CPU backend → numpy."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(fn(*args))


def camera_rays(camera, width, height, jitter):
    """Primary rays for every pixel, row-major pixel order.

    jitter: (N, 2) sub-pixel offsets in [0,1). Returns (origins, dirs),
    each (N, 3). The formula here is the contract; engine/camera.py is the
    jnp mirror and is tested for exact agreement.
    """
    pos = np.asarray(camera.position, np.float32)
    w = np.asarray(camera.look_at, np.float32) - pos
    w = w / np.linalg.norm(w)
    up = np.asarray(camera.up, np.float32)
    # Right-handed basis with screen-right = up x forward: for the Cornell
    # camera (forward +z, up +y) this puts +x on screen right, i.e. the
    # canonical view (red wall on image left).
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    half_h = np.tan(np.float32(camera.fov_y) / 2.0)
    half_w = half_h * (width / height)

    ys, xs = np.divmod(np.arange(width * height, dtype=np.int32), width)
    sx = ((xs + jitter[:, 0]) / width) * 2.0 - 1.0
    sy = 1.0 - ((ys + jitter[:, 1]) / height) * 2.0
    d = (
        w[None, :]
        + sx[:, None] * (half_w * u)[None, :]
        + sy[:, None] * (half_h * v)[None, :]
    )
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(pos, d.shape).copy()
    return o.astype(np.float32), d.astype(np.float32)


def _intersect_tris(o, d, v0, e1, e2):
    """Möller–Trumbore for every (ray, triangle) pair.

    o, d: (R, 3); v0/e1/e2: (T, 3). Returns t (R, T) with T_FAR on miss.
    """
    pvec = np.cross(d[:, None, :], e2[None, :, :])  # (R,T,3)
    det = np.einsum("tk,rtk->rt", e1, pvec)
    inv = np.where(np.abs(det) > C.DET_EPS, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    uu = np.einsum("rtk,rtk->rt", tvec, pvec) * inv
    qvec = np.cross(tvec, e1[None, :, :])
    vv = np.einsum("rk,rtk->rt", d, qvec) * inv
    t = np.einsum("tk,rtk->rt", e2, qvec) * inv
    ok = (
        (np.abs(det) > C.DET_EPS)
        & (uu >= 0.0)
        & (vv >= 0.0)
        & (uu + vv <= 1.0)
        & (t > C.T_MIN)
        & (t < C.T_FAR)
    )
    return np.where(ok, t, C.T_FAR).astype(np.float32)


def _intersect_spheres(o, d, c, r):
    """Analytic sphere hits. o, d: (R,3); c: (S,3); r: (S,). t (R,S)."""
    oc = o[:, None, :] - c[None, :, :]  # (R,S,3)
    b = np.einsum("rsk,rk->rs", oc, d)
    c0 = np.einsum("rsk,rsk->rs", oc, oc) - (r**2)[None, :]
    disc = b * b - c0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = np.where(t0 > C.T_MIN, t0, t1)
    ok = (disc > 0.0) & (t > C.T_MIN) & (t < C.T_FAR)
    return np.where(ok, t, C.T_FAR).astype(np.float32)


def intersect_closest(geom, o, d):
    """Closest hit over all triangles + spheres, chunked over rays.

    Returns (t, n_geom, mat): (R,), (R,3), (R,) with t == T_FAR on miss
    (then n_geom/mat are arbitrary but valid indices).
    """
    R = o.shape[0]
    t_out = np.full((R,), C.T_FAR, np.float32)
    n_out = np.zeros((R, 3), np.float32)
    m_out = np.zeros((R,), np.int32)
    v0 = np.asarray(geom.tri_v0)
    e1 = np.asarray(geom.tri_e1)
    e2 = np.asarray(geom.tri_e2)
    tn = np.asarray(geom.tri_n)
    tm = np.asarray(geom.tri_mat)
    sc = np.asarray(geom.sph_c)
    sr = np.asarray(geom.sph_r)
    sm = np.asarray(geom.sph_mat)
    for s in range(0, R, _RAY_CHUNK):
        sl = slice(s, min(s + _RAY_CHUNK, R))
        oo, dd = o[sl], d[sl]
        t_best = np.full((oo.shape[0],), C.T_FAR, np.float32)
        n_best = np.zeros((oo.shape[0], 3), np.float32)
        m_best = np.zeros((oo.shape[0],), np.int32)
        if len(v0):
            tt = _intersect_tris(oo, dd, v0, e1, e2)  # (r,T)
            ti = np.argmin(tt, axis=1)
            tv = tt[np.arange(len(ti)), ti]
            better = tv < t_best
            t_best = np.where(better, tv, t_best)
            n_best = np.where(better[:, None], tn[ti], n_best)
            m_best = np.where(better, tm[ti], m_best)
        if len(sc):
            ts = _intersect_spheres(oo, dd, sc, sr)  # (r,S)
            si = np.argmin(ts, axis=1)
            sv = ts[np.arange(len(si)), si]
            better = sv < t_best
            p = oo + sv[:, None] * dd
            ns = (p - sc[si]) / sr[si][:, None]
            t_best = np.where(better, sv, t_best)
            n_best = np.where(better[:, None], ns.astype(np.float32), n_best)
            m_best = np.where(better, sm[si], m_best)
        t_out[sl] = t_best
        n_out[sl] = n_best
        m_out[sl] = m_best
    return t_out, n_out, m_out


def _onb(n):
    """Branchless Duff/Frisvad orthonormal basis around unit normal n (R,3).

    Returns (t, b) tangent/bitangent, each (R,3). Must match the jnp mirror
    in engine/shading.py bit-for-bit in structure.
    """
    s = np.where(n[:, 2] >= 0.0, 1.0, -1.0).astype(np.float32)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = np.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], axis=-1
    )
    bt = np.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=-1)
    return t.astype(np.float32), bt.astype(np.float32)


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about n. n: (R,3); u1,u2: (R,)."""
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    z = np.sqrt(np.maximum(0.0, 1.0 - u1))
    t, b = _onb(n)
    d = x[:, None] * t + y[:, None] * b + z[:, None] * n
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _sample_light(lights, geom, u_sel, u1, u2):
    """Uniform-by-area point on the emissive surfaces (tris + spheres).

    Returns (x_l, n_l, mat_l): sampled point, light normal, material id.
    Mirrors engine/shading.py:sample_light: cdf entries are triangle
    lights first, then sphere lights; triangles use the sqrt-barycentric
    warp, spheres uniform-on-the-sphere (z = 1-2*u1, phi = 2*pi*u2) with
    the sampled normal as n_l.
    """
    cdf = np.asarray(lights.cdf)
    idx = np.minimum(
        np.searchsorted(cdf, u_sel, side="right"), len(cdf) - 1
    )
    Lt = int(np.asarray(lights.tri_idx).shape[0])
    tri = np.asarray(lights.tri_idx)[np.minimum(idx, max(Lt - 1, 0))] \
        if Lt else np.zeros_like(idx)
    if Lt:
        v0 = np.asarray(geom.tri_v0)[tri]
        e1 = np.asarray(geom.tri_e1)[tri]
        e2 = np.asarray(geom.tri_e2)[tri]
        su = np.sqrt(u1)
        b1 = 1.0 - su
        b2 = u2 * su
        x_l = v0 + b1[:, None] * e1 + b2[:, None] * e2
        n_l = np.asarray(geom.tri_n)[tri].copy()
        mat_l = np.asarray(geom.tri_mat)[tri].copy()
    else:
        x_l = np.zeros((len(idx), 3), np.float32)
        n_l = np.zeros((len(idx), 3), np.float32)
        mat_l = np.zeros((len(idx),), np.int32)
    is_sph = idx >= Lt
    if is_sph.any():
        si = np.asarray(lights.sph_idx)[
            np.minimum(np.maximum(idx - Lt, 0),
                       len(np.asarray(lights.sph_idx)) - 1)]
        c = np.asarray(geom.sph_c)[si]
        r = np.asarray(geom.sph_r)[si]
        z = 1.0 - 2.0 * u1
        phi = 2.0 * np.pi * u2
        s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        n_sph = np.stack(
            [s * np.cos(phi), s * np.sin(phi), z], axis=1
        ).astype(np.float32)
        x_sph = c + r[:, None] * n_sph
        x_l = np.where(is_sph[:, None], x_sph, x_l)
        n_l = np.where(is_sph[:, None], n_sph, n_l)
        mat_l = np.where(is_sph, np.asarray(geom.sph_mat)[si], mat_l)
    return x_l.astype(np.float32), n_l.astype(np.float32), mat_l


def render_sample(scene: Scene, cfg: RenderConfig, spp_idx: int) -> np.ndarray:
    """One sample per pixel; returns (N, 3) radiance, row-major pixels."""
    N = cfg.n_pixels
    geom = scene.geometry
    albedo = np.asarray(scene.materials.albedo)
    emission = np.asarray(scene.materials.emission)
    bg = np.asarray(scene.lights.background, np.float32)
    n_lights = int(np.asarray(scene.lights.tri_idx).shape[0]) + int(
        np.asarray(scene.lights.sph_idx).shape[0])

    pixel_ids = np.arange(N, dtype=np.uint32)
    jitter = _np_uniforms(rng_mod.pixel_jitter, cfg.seed, spp_idx, pixel_ids)
    o, d = camera_rays(scene.camera, cfg.width, cfg.height, jitter)

    mtype = np.asarray(geom.mat_type)
    mior = np.asarray(geom.mat_ior)

    radiance = np.zeros((N, 3), np.float32)
    throughput = np.ones((N, 3), np.float32)
    alive = np.ones((N,), bool)
    # True when the *previous* scatter was a delta lobe (specular or
    # refractive) or this is the camera ray: such hits see emission
    # directly, because NEE cannot sample through a delta lobe. Diffuse
    # scatters switch it off for the next hit (their direct light arrives
    # via NEE alone — or, with cfg.mis, via the power-heuristic-weighted
    # pair of strategies), but a later delta scatter switches it back on,
    # so mirror/glass images of lights survive.
    spec_chain = np.ones((N,), bool)
    # Solid-angle pdf of the previous diffuse scatter (cos/pi); 0 when the
    # previous event was the camera or a delta lobe. MIS bookkeeping only.
    prev_pdf = np.zeros((N,), np.float32)
    total_area = float(np.asarray(scene.lights.total_area))

    for bounce in range(cfg.max_depth):
        U = _np_uniforms(
            rng_mod.bounce_uniforms, cfg.seed, spp_idx, bounce, pixel_ids
        )
        t, n_geom, mat = intersect_closest(geom, o, d)
        hit = t < C.T_FAR

        # Miss → environment radiance, path ends.
        miss = alive & ~hit
        radiance[miss] += throughput[miss] * bg

        # Front-face hits reached via the camera or a delta scatter see
        # emission directly; hits reached via a diffuse scatter get their
        # direct light from NEE instead (no double counting).
        cos_in = -(n_geom * d).sum(-1)  # dot(n_geom, -d)
        if cfg.mis and n_lights > 0:
            # Emissive hits count on every front-face hit; those reached
            # via a diffuse scatter carry the power-heuristic weight
            # against the NEE pdf of the same light point.
            # Miss lanes carry t == T_FAR whose square overflows f32;
            # their weight is never used (prim requires a hit).
            t_eff = np.where(hit, t, 1.0)
            p_nee = (t_eff * t_eff) / np.maximum(cos_in * total_area, 1e-12)
            w_b = (prev_pdf * prev_pdf) / np.maximum(
                prev_pdf * prev_pdf + p_nee * p_nee, 1e-20
            )
            w_emit = np.where(spec_chain, 1.0, w_b).astype(np.float32)
            prim = alive & hit & (cos_in > 0.0)
            radiance[prim] += (
                throughput[prim] * emission[mat[prim]] * w_emit[prim, None]
            )
        else:
            prim = alive & hit & (cos_in > 0.0) & spec_chain
            radiance[prim] += throughput[prim] * emission[mat[prim]]

        alive = alive & hit
        if not alive.any():
            break

        p = o + t[:, None] * d
        n_shade = n_geom * np.where(cos_in > 0.0, 1.0, -1.0)[:, None]
        mt = mtype[mat]
        is_diff = mt == C.MAT_DIFF
        is_refr = mt == C.MAT_REFR

        # --- Next-event estimation (diffuse vertices only: delta lobes
        # have zero probability of the NEE direction) -------------------
        if n_lights > 0:
            x_l, n_l, mat_l = _sample_light(
                scene.lights, geom, U[:, rng_mod.LIGHT_SEL],
                U[:, rng_mod.LIGHT_U1], U[:, rng_mod.LIGHT_U2],
            )
            o_sh = p + n_shade * C.RAY_OFFSET
            dvec = x_l - o_sh
            dist = np.linalg.norm(dvec, axis=-1)
            wi = dvec / np.maximum(dist[:, None], 1e-20)
            cos_s = (n_shade * wi).sum(-1)
            cos_l = -(n_l * wi).sum(-1)
            cand = alive & is_diff & (cos_s > 0.0) & (cos_l > 0.0)
            if cand.any():
                t_sh, _, _ = intersect_closest(geom, o_sh[cand], wi[cand])
                vis = t_sh >= dist[cand] * (1.0 - C.SHADOW_REL_EPS)
                if cfg.mis and bounce + 1 < cfg.max_depth:
                    # Power heuristic vs the cosine-BSDF pdf of wi; the
                    # LAST vertex keeps w=1 (its BSDF-hit counterpart is
                    # truncated by max_depth — weight 1 keeps the
                    # estimator unbiased at finite depth).
                    p_l = (dist**2) / np.maximum(
                        cos_l * total_area, 1e-12
                    )
                    p_b = cos_s / np.pi
                    w_nee = (p_l * p_l) / np.maximum(
                        p_l * p_l + p_b * p_b, 1e-20
                    )
                else:
                    w_nee = np.ones_like(dist)
                contrib = (
                    throughput[cand]
                    * (albedo[mat[cand]] / np.pi)
                    * emission[mat_l[cand]]
                    * (
                        w_nee[cand]
                        * cos_s[cand]
                        * cos_l[cand]
                        * float(scene.lights.total_area)
                        / np.maximum(dist[cand] ** 2, 1e-12)
                    )[:, None]
                )
                idx_cand = np.nonzero(cand)[0]
                radiance[idx_cand[vis]] += contrib[vis]

        if bounce + 1 >= cfg.max_depth:
            break

        # --- Scatter ---------------------------------------------------
        # DIFF: cosine-weighted hemisphere (pdf cos/pi → throughput *=
        # albedo). SPEC: perfect mirror (delta). REFR: smooth dielectric —
        # Schlick Fresnel picks reflect vs refract with probability R
        # (weight 1/R and R cancel), total internal reflection reflects.
        d_diff = cosine_hemisphere(
            n_shade, U[:, rng_mod.BSDF_U1], U[:, rng_mod.BSDF_U2]
        )
        cos_o = np.maximum(cos_in * np.where(cos_in > 0.0, 1.0, -1.0), 0.0)
        d_refl = d + 2.0 * cos_o[:, None] * n_shade

        entering = cos_in > 0.0
        ior = mior[mat]
        eta = np.where(entering, 1.0 / ior, ior).astype(np.float32)
        k = 1.0 - eta * eta * (1.0 - cos_o * cos_o)
        tir = k < 0.0
        d_refr = eta[:, None] * d + (
            eta * cos_o - np.sqrt(np.maximum(k, 0.0))
        )[:, None] * n_shade
        d_refr /= np.maximum(
            np.linalg.norm(d_refr, axis=-1, keepdims=True), 1e-20
        )
        r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        cos_x = np.where(entering, cos_o, (d_refr * n_geom).sum(-1))
        fres = r0 + (1.0 - r0) * (1.0 - np.clip(cos_x, 0.0, 1.0)) ** 5
        reflect = tir | (U[:, rng_mod.FRESNEL_U] < fres)
        d_glass = np.where(reflect[:, None], d_refl, d_refr)
        transmit = is_refr & ~reflect

        new_d = np.where(
            is_diff[:, None],
            d_diff,
            np.where(is_refr[:, None], d_glass, d_refl),
        ).astype(np.float32)
        throughput = throughput * albedo[mat]
        off = np.where(transmit, -C.RAY_OFFSET, C.RAY_OFFSET)
        o = (p + n_shade * off[:, None]).astype(np.float32)
        d = new_d
        spec_chain = ~is_diff
        # MIS bookkeeping: solid-angle pdf of the diffuse scatter.
        prev_pdf = np.where(
            is_diff,
            np.maximum((n_shade * d).sum(-1), 0.0) / np.pi,
            0.0,
        ).astype(np.float32)

        # --- Russian roulette -----------------------------------------
        if bounce >= cfg.rr_start:
            pcont = np.clip(
                throughput.max(-1), C.RR_CLAMP_LO, C.RR_CLAMP_HI
            ).astype(np.float32)
            kill = U[:, rng_mod.RR_U] >= pcont
            alive = alive & ~kill
            throughput = np.where(
                alive[:, None], throughput / pcont[:, None], throughput
            )

    return radiance


def render(scene: Scene, cfg: RenderConfig) -> np.ndarray:
    """Full render: (height, width, 3) linear-radiance image."""
    acc = np.zeros((cfg.n_pixels, 3), np.float32)
    for s in range(cfg.spp):
        acc += render_sample(scene, cfg, s)
    img = acc / np.float32(cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)
