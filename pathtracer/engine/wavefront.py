"""The jit-compiled wavefront render loop — the heart of the tracer.

This replaces the reference's CUDA megakernel bounce loop in tracer.cu
(SURVEY.md §3.1): instead of one divergent per-thread loop, the whole ray
batch advances bounce-by-bounce in lockstep vectorized stages — intersect,
shade, NEE shadow batch, sample, roulette — the wavefront formulation
(PAPERS.md "Megakernel vs Wavefront GPU Path Tracing"; BASELINE.json:5
"megakernel bounce loop → wavefront compaction"). Every stage is a fused
XLA op over the batch; the bounce loop is unrolled at trace time (static
max_depth), the spp loop is a `lax.fori_loop`, and there are NO host
round-trips inside a render call (SURVEY.md §3.3).

The semantics mirror oracle/tracer.py statement-for-statement; equality at
fixed seeds is enforced by tests/oracle/test_engine.py.

`trace_sample` is deliberately shardable: it takes explicit absolute
pixel ids, and all randomness keys off those ids, so parallel/mesh.py can
`shard_map` it over image tiles and reproduce the single-device image
bit-for-bit.

Materials follow the smallpt-style DIFF/SPEC/REFR palette of the
reference's class of CUDA Cornell tracers (constants.MAT_*): Lambertian
vertices use NEE + cosine sampling; mirror and dielectric vertices are
delta lobes — no NEE, the next emissive hit is credited directly
(spec_chain), dielectrics pick reflect/refract by Schlick Fresnel with
total internal reflection. All lanes compute all three lobes and select
by material type — the branchless wavefront formulation of the
reference's per-thread switch.

Differentiability contract (SURVEY.md §7 hard part 3): geometry outputs of
intersection (t, normal) and the RR continuation probability are wrapped in
`stop_gradient`; pixel radiance stays differentiable w.r.t. the material
pytree (albedo/emission) through the multiplicative throughput chain and
the NEE terms.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants as C
from ..accel.auto import dense_route
from ..config import RenderConfig
from ..sampling import rng as rng_mod
from ..scene.model import Scene
from . import intersect as isect
from .camera import camera_rays
from .shading import (
    cosine_hemisphere,
    reflect,
    refract_dir,
    sample_light,
    schlick,
    take_small_rows,
)


def _intersector(geom, cfg: RenderConfig):
    """Pick the closest-hit implementation for this scene/config.

    backend="cluster" (the bench default) routes by scene size
    (accel/auto.py:dense_route): scenes with cluster tables within the
    dense route's size take the dense cluster kernel
    (ops/intersect_cluster.py), larger ones the BVH walk. "jnp" is the
    plain BVH walk (accel/traverse.py); without a BVH, brute force.
    """
    # All intersectors share the signature hit(g, o, d, t_max=None).
    # t_max is the shadow-query upper bound: implementations MAY report
    # hits at t >= t_max[i] as misses (the cluster kernel exploits it to
    # stop its ordered walk at the light distance); implementations that
    # ignore it are equally correct.
    n_clusters = int(geom.cl_lo.shape[0])
    has_bvh = cfg.use_bvh and geom.bvh_lo.shape[0] > 0
    if cfg.backend == "cluster" and n_clusters > 0 and (
            dense_route(n_clusters) or not has_bvh):
        if not dense_route(n_clusters):
            # Too large for the dense route and no BVH to walk (caller
            # bypassed accel/auto.py:prepare_accel): the cluster kernel
            # stays exact at any size, only slower.
            import warnings

            warnings.warn(
                "cluster tables exceed the dense route's size and the "
                "scene has no BVH; using the dense cluster kernel. Build "
                "the scene with accel.auto.prepare_accel to get the BVH "
                "walk.",
                stacklevel=2,
            )
        from ..ops.intersect_cluster import closest_hit_cluster

        def hit(g, o, d, t_max=None):
            return closest_hit_cluster(g, o, d, t_max=t_max)

        hit.impl = "cluster"
        return hit
    if has_bvh:
        from ..accel.traverse import closest_hit

        def hit(g, o, d, t_max=None):
            return closest_hit(g, o, d)

        hit.impl = "bvh"
        return hit

    def hit(g, o, d, t_max=None):
        return isect.brute(g, o, d)

    hit.impl = "brute"
    return hit


# Canonical direction for masked-out lanes (see trace_sample): any unit
# vector works; the point (o=0, d=z, t_max=T_MIN) ray does zero walk work.
_CANON_DIR = (0.0, 0.0, 1.0)


def _coherence_key(o, d, alive, scene_lo, scene_hi):
    """Sort key for stream compaction + ray coherence (SURVEY.md §7.1).

    Dead rays sort to the tail; live rays group by a 64-bin DIRECTION
    morton (2 bits/axis of d) then a 4096-cell position morton (4
    bits/axis of o), so neighbouring lanes (the cluster kernel's ray
    tiles) see directionally AND spatially coherent packets — the
    batched answer to wavefront compaction (BASELINE.json:5 "megakernel
    bounce loop → wavefront compaction").

    Direction granularity matters: the per-ray cluster cull takes each
    tile's candidate list to the exact union of its rays' line needs,
    and that union is only as tight as this sort's cones (64 direction
    bins here; not yet tuned on the GPU). Any key choice is perf-only:
    compaction is pure data movement and the final unscramble restores
    caller order bit-exactly.
    """
    q = jnp.clip(
        (o - scene_lo[None, :]) / (scene_hi - scene_lo)[None, :], 0.0, 0.999
    )
    # Position: 4 bits per axis, bit-interleaved (true morton): the
    # cluster cull's per-tile intervals are only as tight as this sort
    # makes them.
    cell = (q * 16.0).astype(jnp.int32)  # (N, 3), 4 bits per axis
    morton = jnp.zeros_like(cell[:, 0])
    for b in range(4):
        for ax in range(3):
            morton = morton | (
                ((cell[:, ax] >> b) & 1) << (3 * b + ax)
            )
    # Direction: 2 bits per axis of d in [-1, 1], bit-interleaved —
    # 64 bins ~ 28-degree cones (direction-major: within one bin the
    # position morton still orders ~16k rays of a 1M-ray buffer).
    dq = jnp.clip(((d + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    dmort = jnp.zeros_like(dq[:, 0])
    for b in range(2):
        for ax in range(3):
            dmort = dmort | (((dq[:, ax] >> b) & 1) << (3 * b + ax))
    key = (dmort << 12) | morton
    return jnp.where(alive, key, jnp.int32(1 << 30))


def trace_sample(geometry, materials, camera, lights, cfg: RenderConfig,
                 pixel_ids, spp_idx, with_stats: bool = False):
    """Trace one path per pixel id; returns (N, 3) radiance.

    Mirrors oracle/tracer.py:render_sample. All inputs are arrays except
    the static cfg; safe under jit/grad/shard_map/vmap.

    with_stats=True additionally returns the number of *useful* rays
    traced (live path segments + candidate shadow rays) as an int32
    scalar — the honest numerator of the rays/s benchmark metric
    (BASELINE.json:2), excluding dead SIMD lanes.
    """
    intersect = _intersector(geometry, cfg)
    albedo = materials.albedo
    emission = materials.emission
    # Pre-joined per-material rows [albedo(3), emission(3), mat_type,
    # ior, pad(8)]: the winner-decode trick applied to the shading
    # tables — one 16-f32 row gather per bounce instead of five narrow
    # per-array gathers. Differentiable: albedo/emission flow through
    # the concat, whose transpose is an exact slice.
    M = albedo.shape[0]
    mt_tab = jnp.asarray(geometry.mat_type, jnp.float32)
    ior_tab = jnp.asarray(geometry.mat_ior, jnp.float32)
    # The structural tables are sized by the ids geometry references;
    # Materials may carry more (or fewer) rows. The joined table spans
    # the LARGER count: truncating mat_type/ior to M would silently
    # demote e.g. a MAT_SPEC id >= M to the clamped row's
    # type, where per-array lookups read the full structural tables.
    # Missing structural rows get the make_geometry defaults (MAT_DIFF,
    # ior 1.5); missing Materials rows replicate the last row — exactly
    # the clamp semantics albedo[mat] had before the join. Static
    # shapes only.
    n_rows = max(M, int(mt_tab.shape[0]), int(ior_tab.shape[0]))
    if mt_tab.shape[0] < n_rows:
        mt_tab = jnp.concatenate([
            mt_tab, jnp.zeros((n_rows - mt_tab.shape[0],), jnp.float32)])
    if ior_tab.shape[0] < n_rows:
        ior_tab = jnp.concatenate([
            ior_tab,
            jnp.full((n_rows - ior_tab.shape[0],), 1.5, jnp.float32)])
    if M < n_rows:
        albedo_t = jnp.concatenate([
            albedo, jnp.tile(albedo[-1:], (n_rows - M, 1))])
        emission_t = jnp.concatenate([
            emission, jnp.tile(emission[-1:], (n_rows - M, 1))])
    else:
        albedo_t, emission_t = albedo, emission
    mat_rows = jnp.concatenate([
        albedo_t, emission_t, mt_tab[:, None], ior_tab[:, None],
        jnp.zeros((n_rows, 8), jnp.float32),
    ], axis=1)
    bg = lights.background
    n_lights = lights.tri_idx.shape[0] + lights.sph_idx.shape[0]
    N = pixel_ids.shape[0]

    jitter = rng_mod.pixel_jitter(cfg.seed, spp_idx, pixel_ids)
    o, d = camera_rays(camera, cfg.width, cfg.height, jitter, pixel_ids)

    radiance = jnp.zeros((N, 3), jnp.float32)
    throughput = jnp.ones((N, 3), jnp.float32)
    alive = jnp.ones((N,), bool)
    # True when the previous scatter was a delta lobe (or the camera ray):
    # such hits see emission directly; diffuse-scattered hits rely on NEE
    # (oracle/tracer.py spec_chain — same no-double-counting rule).
    spec_chain = jnp.ones((N,), bool)
    # Solid-angle pdf of the previous diffuse scatter (cos/pi); 0 for the
    # camera ray and delta lobes. MIS bookkeeping (mirrors oracle).
    prev_pdf = jnp.zeros((N,), jnp.float32)
    total_area = lights.total_area
    n_rays = jnp.int32(0)
    # Original buffer slot of each ray (for unscrambling after compaction).
    slot = jnp.arange(N, dtype=jnp.int32)
    if cfg.compact:
        if geometry.bvh_lo.shape[0] > 0:
            scene_lo = geometry.bvh_lo[0]
            scene_hi = geometry.bvh_hi[0]
        else:
            scene_lo = jnp.min(geometry.tri_v0, axis=0)
            scene_hi = jnp.max(geometry.tri_v0, axis=0)

    for bounce in range(cfg.max_depth):
        n_rays = n_rays + jnp.sum(alive.astype(jnp.int32))
        U = rng_mod.bounce_uniforms(cfg.seed, spp_idx, bounce, pixel_ids)
        # Dead lanes carry stale rays that (a) widen the cluster cull's
        # per-tile intervals and (b) pin the ordered-walk early exit at
        # T_FAR. Canonicalize them to a zero-work point ray;
        # their intersection results are never used (all radiance terms
        # are masked by `alive`), so the image is bit-unchanged.
        o_q = jnp.where(alive[:, None], o, 0.0)
        d_q = jnp.where(alive[:, None], d, jnp.asarray(_CANON_DIR))
        t_cap = jnp.where(alive, C.T_FAR, C.T_MIN)
        t, n_geom, mat = intersect(geometry, o_q, d_q, t_max=t_cap)
        # Detach geometry: grads flow only through the shading chain.
        t = jax.lax.stop_gradient(t)
        n_geom = jax.lax.stop_gradient(n_geom)
        hit = t < C.T_FAR
        # One material-row lookup serves albedo/emission/type/ior below
        # (scatter-free transpose for the tiny table — the row-gather
        # backward scatter-add was a top grad-band fusion, see
        # shading.take_small_rows).
        mrow = take_small_rows(mat_rows, mat)
        alb_m = mrow[:, 0:3]
        emis_m = mrow[:, 3:6]

        miss = alive & ~hit
        radiance = radiance + jnp.where(
            miss[:, None], throughput * bg[None, :], 0.0
        )

        cos_in = -jnp.sum(n_geom * d, -1)
        if cfg.mis and n_lights > 0:
            # MIS: every front-face emissive hit counts; diffuse-reached
            # ones carry the power-heuristic weight vs the NEE pdf of the
            # same light point (oracle/tracer.py lockstep). Weights are
            # sampling bookkeeping — detached from gradients.
            # Miss lanes carry t == T_FAR whose square overflows f32;
            # their weight is never used (prim requires a hit).
            t_eff = jnp.where(hit, t, 1.0)
            p_nee = (t_eff * t_eff) / jnp.maximum(
                cos_in * total_area, 1e-12
            )
            w_b = (prev_pdf * prev_pdf) / jnp.maximum(
                prev_pdf * prev_pdf + p_nee * p_nee, 1e-20
            )
            w_emit = jax.lax.stop_gradient(
                jnp.where(spec_chain, 1.0, w_b)
            )
            prim = alive & hit & (cos_in > 0.0)
            radiance = radiance + jnp.where(
                prim[:, None],
                throughput * emis_m * w_emit[:, None], 0.0,
            )
        else:
            prim = alive & hit & (cos_in > 0.0) & spec_chain
            radiance = radiance + jnp.where(
                prim[:, None], throughput * emis_m, 0.0
            )

        alive = alive & hit
        p = o + t[:, None] * d
        n_shade = n_geom * jnp.where(cos_in > 0.0, 1.0, -1.0)[:, None]
        mt = mrow[:, 6].astype(jnp.int32)
        is_diff = mt == C.MAT_DIFF
        is_refr = mt == C.MAT_REFR

        # --- Next-event estimation (one shadow ray per path vertex) ----
        if n_lights > 0:
            x_l, n_l, _, emis_l = sample_light(
                lights, geometry, U[:, rng_mod.LIGHT_SEL],
                U[:, rng_mod.LIGHT_U1], U[:, rng_mod.LIGHT_U2],
                emission=emission,
            )
            o_sh = p + n_shade * C.RAY_OFFSET
            dvec = x_l - o_sh
            dist = jnp.linalg.norm(dvec, axis=-1)
            wi = dvec / jnp.maximum(dist[:, None], 1e-20)
            cos_s = jnp.sum(n_shade * wi, -1)
            cos_l = -jnp.sum(n_l * wi, -1)
            cand = alive & is_diff & (cos_s > 0.0) & (cos_l > 0.0)
            n_rays = n_rays + jnp.sum(cand.astype(jnp.int32))
            # Shadow query carries its distance bound: occluders beyond
            # the light are irrelevant, so the cluster kernels stop the
            # ordered walk at the light. Non-candidate lanes (dead,
            # specular, backfacing) become zero-work point rays — their
            # visibility is never read (`cand & vis` mask below).
            o_shq = jnp.where(cand[:, None], o_sh, 0.0)
            wi_q = jnp.where(cand[:, None], wi, jnp.asarray(_CANON_DIR))
            t_sh_cap = jnp.where(cand, dist, C.T_MIN)
            t_sh, _, _ = intersect(geometry, o_shq, wi_q, t_max=t_sh_cap)
            vis = t_sh >= dist * (1.0 - C.SHADOW_REL_EPS)
            geo_term = (
                cos_s * cos_l * lights.total_area
                / jnp.maximum(dist * dist, 1e-12)
            )
            if cfg.mis and bounce + 1 < cfg.max_depth:
                # Power heuristic vs the cosine-BSDF pdf; the last vertex
                # keeps w=1 (BSDF counterpart truncated by max_depth).
                p_l = (dist * dist) / jnp.maximum(
                    cos_l * total_area, 1e-12
                )
                p_b = cos_s / jnp.pi
                w_nee = (p_l * p_l) / jnp.maximum(
                    p_l * p_l + p_b * p_b, 1e-20
                )
                geo_term = geo_term * w_nee
            # emis_l rides sample_light's pre-joined row gather — no
            # separate (N, 16) mat_rows gather per NEE stage.
            contrib = (
                throughput
                * (alb_m / jnp.pi)
                * emis_l
                * jax.lax.stop_gradient(geo_term)[:, None]
            )
            radiance = radiance + jnp.where(
                (cand & vis)[:, None], contrib, 0.0
            )

        if bounce + 1 >= cfg.max_depth:
            break

        # --- Scatter (mirrors oracle/tracer.py exactly) ----------------
        # DIFF cosine hemisphere; SPEC mirror; REFR Schlick-Fresnel
        # reflect/refract with TIR. All directions derive from detached
        # geometry, so no grads leak through them; throughput keeps the
        # differentiable albedo chain for every lobe.
        d_diff = cosine_hemisphere(
            n_shade, U[:, rng_mod.BSDF_U1], U[:, rng_mod.BSDF_U2]
        )
        cos_o = jnp.maximum(
            cos_in * jnp.where(cos_in > 0.0, 1.0, -1.0), 0.0
        )
        d_refl = reflect(d, n_shade, cos_o)
        entering = cos_in > 0.0
        ior = mrow[:, 7]
        eta = jnp.where(entering, 1.0 / ior, ior)
        d_refr, tir = refract_dir(d, n_shade, cos_o, eta)
        cos_x = jnp.where(entering, cos_o, jnp.sum(d_refr * n_geom, -1))
        fres = schlick(cos_x, ior)
        do_reflect = tir | (U[:, rng_mod.FRESNEL_U] < fres)
        d_glass = jnp.where(do_reflect[:, None], d_refl, d_refr)
        transmit = is_refr & ~do_reflect

        new_d = jnp.where(
            is_diff[:, None],
            d_diff,
            jnp.where(is_refr[:, None], d_glass, d_refl),
        )
        throughput = throughput * alb_m
        off = jnp.where(transmit, -C.RAY_OFFSET, C.RAY_OFFSET)
        o = p + n_shade * off[:, None]
        d = new_d
        spec_chain = ~is_diff
        prev_pdf = jnp.where(
            is_diff,
            jnp.maximum(jnp.sum(n_shade * d, -1), 0.0) / jnp.pi,
            0.0,
        )

        # --- Russian roulette ------------------------------------------
        if bounce >= cfg.rr_start:
            pcont = jnp.clip(
                jnp.max(throughput, -1), C.RR_CLAMP_LO, C.RR_CLAMP_HI
            )
            pcont = jax.lax.stop_gradient(pcont)
            kill = U[:, rng_mod.RR_U] >= pcont
            alive = alive & ~kill
            throughput = jnp.where(
                alive[:, None], throughput / pcont[:, None], throughput
            )

        # --- Stream compaction / coherence sort ------------------------
        if cfg.compact:
            key = _coherence_key(o, d, alive, scene_lo, scene_hi)
            perm = jnp.argsort(key, stable=True)
            # Apply the permutation as ONE (N, 16) ROW gather of packed
            # state instead of seven per-array gathers. Pure data
            # movement either way — the permuted values are
            # bit-identical (ints/bools ride as bitcast f32 columns;
            # gather/concat/slice never touch the bits).
            bc = jax.lax.bitcast_convert_type
            flags = (alive.astype(jnp.float32) * 2.0
                     + spec_chain.astype(jnp.float32))
            state = jnp.concatenate([
                o, d, radiance, throughput,
                bc(pixel_ids, jnp.float32)[:, None],
                bc(slot, jnp.float32)[:, None],
                flags[:, None], prev_pdf[:, None],
            ], axis=1)  # (N, 16)
            state = state[perm]
            o = state[:, 0:3]
            d = state[:, 3:6]
            radiance = state[:, 6:9]
            throughput = state[:, 9:12]
            pixel_ids = bc(state[:, 12], jnp.uint32)
            slot = bc(state[:, 13], jnp.int32)
            fl = state[:, 14]
            alive = fl >= 2.0
            spec_chain = (fl == 1.0) | (fl == 3.0)
            prev_pdf = state[:, 15]

    if cfg.compact and cfg.max_depth > 1:
        # Unscramble back to the caller's ray order: `slot` is a
        # permutation of arange(N), so sorting by it with the radiance
        # columns as sort payloads is EXACTLY the inverse permutation —
        # same rows, same bits, pure data movement, and no scatter:
        # payload operands ride the key sort.
        _, r0, r1, r2 = jax.lax.sort(
            (slot, radiance[:, 0], radiance[:, 1], radiance[:, 2]),
            num_keys=1,
        )
        radiance = jnp.stack([r0, r1, r2], axis=1)

    if with_stats:
        return radiance, n_rays
    return radiance


@partial(jax.jit, static_argnames=("cfg", "n_spp"))
def _render_jit(geometry, materials, camera, lights, cfg: RenderConfig,
                spp_start, n_spp: int):
    """Accumulate n_spp samples for the full image inside one XLA program.

    Returns (radiance sum (N, 3), useful rays traced) — the count is a
    few reductions, so every render carries it."""
    pixel_ids = jnp.arange(cfg.n_pixels, dtype=jnp.uint32)

    def body(i, carry):
        acc, n = carry
        rad, n_i = trace_sample(
            geometry, materials, camera, lights, cfg, pixel_ids,
            spp_start + i, with_stats=True,
        )
        return acc + rad, n + n_i

    init = (jnp.zeros((cfg.n_pixels, 3), jnp.float32), jnp.int32(0))
    if n_spp == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, n_spp, body, init)


def render_accumulate(scene: Scene, cfg: RenderConfig, materials=None,
                      spp_start: int = 0, n_spp: int | None = None):
    """Sum of n_spp samples starting at spp_start, as a flat (N, 3) array.

    The building block for spp-chunked accumulation and resumable renders
    (SURVEY.md §5.4/§5.7): chunks at different spp_start values add up to
    exactly the all-at-once render because samples are keyed by spp index.
    """
    return _accumulate(scene, cfg, materials, spp_start, n_spp)[0]


def _accumulate(scene, cfg, materials, spp_start, n_spp):
    mats = materials if materials is not None else scene.materials
    if n_spp is None:
        n_spp = cfg.spp
    return _render_jit(
        scene.geometry, mats, scene.camera, scene.lights, cfg,
        jnp.uint32(spp_start), n_spp,
    )


def render(scene: Scene, cfg: RenderConfig, materials=None,
           with_stats: bool = False):
    """Full render → (height, width, 3) float32 linear-radiance image.

    with_stats=True returns (image, useful rays traced) — the count of
    trace_sample(with_stats=True) summed over all samples.
    """
    chunk = cfg.spp_chunk if cfg.spp_chunk > 0 else cfg.spp
    chunk = min(chunk, cfg.spp)
    acc = None
    n_rays = jnp.int32(0)
    s = 0
    while s < cfg.spp:
        n = min(chunk, cfg.spp - s)
        part, n_part = _accumulate(scene, cfg, materials, s, n)
        acc = part if acc is None else acc + part
        n_rays = n_rays + n_part
        s += n
    img = (acc / jnp.float32(cfg.spp)).reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, n_rays
    return img
