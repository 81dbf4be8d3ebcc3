"""Smoke test of the render and grad paths on one NVIDIA GPU.

Drives the system's main path through its public entry points at the
bench sizes, with every hit-query kernel compiled for the card, and
checks the results against the repo's plain references:

  1. device   — card name and power limit (nvidia-smi), JAX device info;
  2. kernels  — the cluster kernel (cornell_mesh, 1M primary rays plus
                the bounce and t_max-capped shadow batches built from
                them) against the jnp BVH walk (accel/traverse.py) and
                brute force (engine/intersect.py:brute); the large-scene
                route (the BVH walk on big_mesh) against brute force;
  3. render   — pt.render of the bench preset (cluster kernel) and of
                config5 (big_mesh, BVH walk) at 1024x1024, depth 4;
                useful rays from
                trace_sample(with_stats=True); engine vs the numpy oracle
                at a small size;
  4. grad     — pt.grad_render on cornell_mesh at the bench size, and the
                kernel route's grads vs the jnp route's at a small size.

With --chips 4 it runs only the sharded path of parallel/mesh.py over
four cards (render_sharded of config5, then make_train_step on
cornell_mesh) and compares each with the one-card result.

Run from the repo root:  python chip_smoke.py [--chips 4]
The last stdout line is one JSON object {"ok": true, "device": {...}};
any failed phase, or a platform other than "gpu", exits non-zero with no
such line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

# Kernel-vs-reference tolerances (phase 2). Both sides are f32: the
# kernel evaluates the Möller-Trumbore predicate as multiply-adds over
# precomputed triangle features, the references as cross products, so t
# differs by rounding and grazing edge hits may flip.
HIT_MISMATCH_MAX = 1e-4  # fraction of rays whose hit/visibility differs
T_RTOL, T_ATOL = 1e-4, 1e-5  # |t_k - t_r| <= T_ATOL + T_RTOL * |t_r| ...
T_OUTLIER_MAX = 1e-4  # ... for all but this fraction of both-hit rays
MAT_AGREE_MIN = 0.9999  # material agreement over both-hit rays
BRUTE_RAYS = 65536  # rays checked against brute force per batch
BIG_BRUTE_RAYS = 4096  # the same on big_mesh (2M triangles per ray)
# Engine vs numpy oracle (phase 3): the tolerances of
# tests/oracle/test_engine.py:test_config3_gi_allclose.
ORACLE_ATOL, ORACLE_RTOL = 1e-3, 2e-3
# Kernel-route grads vs jnp-route grads at a small size (phase 4):
# a grazing hit resolved to the other triangle flips one path.
GRAD_RTOL, GRAD_ATOL = 1e-2, 1e-4
SMALL = 64  # image side of the small-size comparisons
# Sharded vs one-card config5 render (--chips 4): per-pixel rounding
# bounds and the fraction of pixels allowed beyond them.
SHARD_ATOL, SHARD_RTOL, SHARD_PIXEL_MAX = 1e-6, 1e-5, 1e-4


class Phases:
    """Runs named phases, keeps going after a failure, reports all."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # report every phase, fail at the end
            traceback.print_exc()
            print(f"!! phase {name} FAILED", flush=True)
            self.failed.append(name)
            return None
        print(f"== phase {name} ok ({time.perf_counter() - t0:.1f}s)",
              flush=True)
        return out


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _prepared(cfg, scene_name=None):
    """Scene with the tables cfg.backend needs, on the device."""
    from pathtracer import build_scene
    from pathtracer.accel.auto import prepare_accel
    from pathtracer.accel.build import with_bvh
    from pathtracer.scene.model import scene_to_device

    scene = build_scene(scene_name or cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    return scene_to_device(prepare_accel(scene, cfg))


def phase_device():
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"card: {card}")
    devs = jax.devices()
    print(f"jax {jax.__version__}: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}")
    return card


def _compare(name, t_k, m_k, t_r, m_r, t_max):
    """Kernel vs reference agreement of one query batch (numpy arrays)."""
    import numpy as np

    from pathtracer import constants as C

    # A hit counts when it is nearer than the query's t bound (the
    # engine's shadow-visibility rule; T_FAR for unbounded queries).
    cut = t_max * (1.0 - C.SHADOW_REL_EPS)
    hit_k = t_k < cut
    hit_r = t_r < cut
    mism = float(np.mean(hit_k != hit_r))
    both = hit_k & hit_r
    err = np.abs(t_k[both] - t_r[both])
    out = err > T_ATOL + T_RTOL * np.abs(t_r[both])
    outl = float(out.mean()) if both.any() else 0.0
    rel = float((err / np.maximum(np.abs(t_r[both]), 1e-6)).max()) \
        if both.any() else 0.0
    mat = float(np.mean(m_k[both] == m_r[both])) if both.any() else 1.0
    print(f"  {name}: rays={len(t_k)} hits={int(hit_r.sum())} "
          f"hit_mismatch={mism:.2e} t_outliers={outl:.2e} "
          f"t_max_rel_err={rel:.2e} mat_agree={mat:.6f}")
    _check(mism <= HIT_MISMATCH_MAX, f"{name}: hit mismatch {mism}")
    _check(outl <= T_OUTLIER_MAX, f"{name}: t outliers {outl}")
    _check(mat >= MAT_AGREE_MIN, f"{name}: material agreement {mat}")


def _query_batches(scene, cfg, ref):
    """Primary rays of the bench frame, plus the bounce and NEE shadow
    batches built from their reference hits (dead lanes canonicalized
    the way engine/wavefront.py does)."""
    import jax
    import jax.numpy as jnp

    from pathtracer import constants as C
    from pathtracer.engine.camera import camera_rays, tiled_pixel_ids
    from pathtracer.engine.shading import cosine_hemisphere, \
        sample_light
    from pathtracer.sampling import rng as rng_mod

    @jax.jit
    def build(geom, camera, lights, materials):
        ids = tiled_pixel_ids(jnp.uint32(0), cfg.n_pixels, cfg.width)
        jit_ = rng_mod.pixel_jitter(cfg.seed, 0, ids)
        o, d = camera_rays(camera, cfg.width, cfg.height, jit_, ids)
        t, n, _ = ref(geom, o, d)
        hit = t < C.T_FAR
        p = o + jnp.where(hit, t, 0.0)[:, None] * d
        n_s = n * jnp.where(jnp.sum(n * d, -1) < 0.0, 1.0, -1.0)[:, None]
        U = rng_mod.bounce_uniforms(cfg.seed, 0, 0, ids)
        o2 = jnp.where(hit[:, None], p + n_s * C.RAY_OFFSET, 0.0)
        d2 = jnp.where(hit[:, None], cosine_hemisphere(
            n_s, U[:, rng_mod.BSDF_U1], U[:, rng_mod.BSDF_U2]),
            jnp.asarray([0.0, 0.0, 1.0]))
        t1 = jnp.full(t.shape, C.T_FAR, jnp.float32)
        t2 = jnp.where(hit, t1, jnp.float32(C.T_MIN))
        x_l, _, _, _ = sample_light(
            lights, geom, U[:, rng_mod.LIGHT_SEL], U[:, rng_mod.LIGHT_U1],
            U[:, rng_mod.LIGHT_U2], emission=materials.emission)
        dv = x_l - o2
        dist = jnp.linalg.norm(dv, axis=-1)
        wi = jnp.where(hit[:, None], dv / jnp.maximum(dist, 1e-20)[:, None],
                       jnp.asarray([0.0, 0.0, 1.0]))
        t3 = jnp.where(hit, dist, jnp.float32(C.T_MIN))
        return (o, d, t1), (o2, d2, t2), (o2, wi, t3)

    return build(scene.geometry, scene.camera, scene.lights,
                 scene.materials)


def _walk(g, o, d, t_max=None):
    from pathtracer.accel.traverse import closest_hit

    return closest_hit(g, o, d)


def _query_ms(fn, *args):
    """Median of 5 timed calls of a compiled hit query, in ms."""
    import jax

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[2] * 1e3


def _route_check(label, scene, cfg, route, vs_walk, brute_rays,
                 brute_chunk):
    """Compile `route` for the bench-shaped batches and compare it with
    the BVH walk (all rays, when vs_walk) and with brute force (the
    first brute_rays rays, brute_chunk rays at a time)."""
    import jax
    import numpy as np

    from pathtracer.engine import intersect as isect

    with jax.default_matmul_precision("highest"):
        batches = _query_batches(scene, cfg, _walk)
        kern = jax.jit(route)
        refj = jax.jit(_walk)

        @jax.jit
        def brute(g, o, d):
            c = min(brute_chunk, o.shape[0])
            n = o.shape[0] // c
            t, _, m = jax.lax.map(
                lambda od: isect.brute(g, od[0], od[1]),
                (o.reshape(n, c, 3), d.reshape(n, c, 3)))
            return t.reshape(-1), m.reshape(-1)

        g = scene.geometry
        for bname, (o, d, t_max) in zip(
                ("primary", "bounce", "shadow"), batches):
            t0 = time.perf_counter()
            tk, _, mk = jax.block_until_ready(kern(g, o, d, t_max))
            secs = time.perf_counter() - t0
            tm = np.asarray(t_max)
            if vs_walk:
                tr, _, mr = refj(g, o, d)
                _compare(f"{label} {bname} vs BVH walk", np.asarray(tk),
                         np.asarray(mk), np.asarray(tr), np.asarray(mr),
                         tm)
                print(f"  {label} {bname}: query ms, median of 5: kernel "
                      f"{_query_ms(kern, g, o, d, t_max):.3f}, BVH walk "
                      f"{_query_ms(refj, g, o, d, t_max):.3f}")
            sub = slice(0, brute_rays)
            tb, mb = brute(g, o[sub], d[sub])
            _compare(f"{label} {bname} vs brute",
                     np.asarray(tk)[sub], np.asarray(mk)[sub],
                     np.asarray(tb), np.asarray(mb), tm[sub])
            print(f"  {label} {bname}: first call incl. compile "
                  f"{secs:.1f}s")


def phase_kernels():
    from pathtracer.config import PRESETS
    from pathtracer.ops.intersect_cluster import closest_hit_cluster

    cfg = PRESETS["bench"]
    scene = _prepared(cfg)
    print(f"  cornell_mesh: {int(scene.geometry.tri_v0.shape[0])} tris, "
          f"{int(scene.geometry.cl_lo.shape[0])} clusters")
    _route_check("cornell cluster", scene, cfg,
                 lambda g, o, d, tm: closest_hit_cluster(g, o, d, t_max=tm),
                 vs_walk=True, brute_rays=BRUTE_RAYS, brute_chunk=4096)
    big = _prepared(PRESETS["config5"])
    _check(big.geometry.cl_lo.shape[0] == 0, "big_mesh got cluster tables")
    print(f"  big_mesh: {int(big.geometry.tri_v0.shape[0])} tris, "
          "routed to the BVH walk")
    _route_check("big_mesh BVH walk", big, cfg.replace(scene="big_mesh"),
                 _walk, vs_walk=False, brute_rays=BIG_BRUTE_RAYS,
                 brute_chunk=32)


def _render_checks(label, scene, cfg, card):
    """pt.render image checks, useful rays/s and the step's memory."""
    import jax
    import numpy as np

    import pathtracer as pt
    from pathtracer.engine import wavefront

    t0 = time.perf_counter()
    img, n = jax.block_until_ready(pt.render(scene, cfg, with_stats=True))
    first = time.perf_counter() - t0
    img = np.asarray(img)
    _check(img.shape == (cfg.height, cfg.width, 3), img.shape)
    _check(np.isfinite(img).all(), f"{label}: non-finite pixels")
    _check(img.mean() > 0, f"{label}: black image")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(pt.render(scene, cfg, with_stats=True))
        times.append(time.perf_counter() - t0)
    secs = sorted(times)[1]
    print(f"  {label}: pt.render {img.shape} mean={img.mean():.5f}; first "
          f"call incl. compile {first:.1f}s; useful rays {int(n)}, frame "
          f"{secs * 1e3:.1f} ms, {int(n) / secs:.4g} rays/s (median of 3, "
          f"{card}; information, not a benchmark)")
    compiled = wavefront._render_jit.lower(
        scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
        np.uint32(0), cfg.spp_chunk or cfg.spp).compile()
    print(f"  {label}: render step memory_analysis: "
          f"{compiled.memory_analysis()}")
    return img


def _oracle_check(label, scene, cfg):
    import numpy as np

    from pathtracer.engine import wavefront
    from pathtracer.oracle import tracer as oracle

    img_o = oracle.render(scene, cfg)
    img_j = np.asarray(wavefront.render(scene, cfg))
    err = np.abs(img_j - img_o)
    print(f"  {label} vs numpy oracle ({cfg.width}x{cfg.height}, "
          f"{cfg.spp}spp, depth {cfg.max_depth}): max abs err "
          f"{err.max():.2e}")
    np.testing.assert_allclose(img_j, img_o, atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


def phase_render(card):
    from pathtracer.config import PRESETS

    bench = PRESETS["bench"]
    _render_checks("bench cornell_mesh (cluster kernel)", _prepared(bench),
                   bench, card)
    small = bench.replace(width=24, height=24, spp=2)
    _oracle_check("cluster route", _prepared(small), small)
    cfg5 = PRESETS["config5"]
    _render_checks("config5 big_mesh (BVH walk)", _prepared(cfg5), cfg5,
                   card)


def _fit_target(scene, cfg):
    """A reachable inverse-rendering target: the scene's own render,
    darkened (shared by the grad phase and the sharded train step)."""
    import numpy as np

    import pathtracer as pt

    return np.asarray(pt.render(scene, cfg)) * np.float32(0.9)


def phase_grad():
    import jax
    import numpy as np

    import pathtracer as pt
    from pathtracer.config import PRESETS
    from pathtracer.scene.builder import GREEN, LIGHT, MESH, RED, WHITE

    cfg = PRESETS["bench"]
    scene = _prepared(cfg)
    target = _fit_target(scene, cfg)
    t0 = time.perf_counter()
    loss, grads = jax.block_until_ready(
        pt.grad_render(scene, cfg, target=target))
    print(f"  bench grad_render: loss {float(loss):.6e} "
          f"({time.perf_counter() - t0:.1f}s incl. compile)")
    ga = np.asarray(grads.albedo)
    ge = np.asarray(grads.emission)
    _check(np.isfinite(ga).all() and np.isfinite(ge).all(), "non-finite")
    for m in (WHITE, RED, GREEN, MESH):
        _check(np.abs(ga[m]).sum() > 0, f"zero albedo grad for material {m}")
    _check(np.abs(ge[LIGHT]).sum() > 0, "zero emission grad for the light")
    small = cfg.replace(width=SMALL, height=SMALL)
    _, g_k = pt.grad_render(_prepared(small), small)
    jnp_cfg = small.replace(backend="jnp")
    _, g_j = pt.grad_render(_prepared(jnp_cfg), jnp_cfg)
    for name in ("albedo", "emission"):
        a = np.asarray(getattr(g_k, name))
        b = np.asarray(getattr(g_j, name))
        print(f"  {SMALL}x{SMALL} {name} grads, kernel vs jnp route: max "
              f"abs diff {np.abs(a - b).max():.2e}")
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def phase_sharded():
    """parallel/mesh.py over four cards vs the one-card public path."""
    import jax
    import numpy as np
    import optax

    import pathtracer as pt
    from pathtracer.config import PRESETS
    from pathtracer.parallel import mesh as pmesh

    _check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    m4 = pmesh.make_mesh(4)

    cfg5 = PRESETS["config5"]
    big = _prepared(cfg5)
    img1 = np.asarray(pt.render(big, cfg5, with_stats=True)[0])
    img4 = pmesh.render_sharded(big, cfg5, m4)
    devs = sorted(d.id for d in img4.sharding.device_set)
    print(f"  render_sharded output on devices {devs}")
    _check(len(devs) == 4, f"sharded output spans {devs}")
    img4 = np.asarray(img4)
    diff = np.abs(img4 - img1)
    print(f"  config5 {cfg5.width}x{cfg5.height} sharded x4 vs one card: "
          f"bit-exact {bool((diff == 0).all())}, max abs diff "
          f"{diff.max():.3e}, differing pixels "
          f"{float(np.mean(diff.max(-1) > 0)):.2e}", flush=True)
    # Each pixel's path is traced by one card either way, but a card's
    # program is compiled for a quarter of the rays, and XLA may contract
    # that program's arithmetic differently (tests/dist/test_sharding.py
    # shows the same for odd shard shapes): a grazing hit can flip one
    # path. So: all but SHARD_PIXEL_MAX of the pixels within rounding.
    off = (diff > SHARD_ATOL + SHARD_RTOL * np.abs(img1)).any(-1).mean()
    _check(off <= SHARD_PIXEL_MAX, f"sharded render: {off:.2e} of pixels "
           "differ beyond rounding")

    cfg = PRESETS["bench"]
    scene = _prepared(cfg)
    target = _fit_target(scene, cfg)
    loss1, g1 = pt.grad_render(scene, cfg, target=target)
    opt = optax.adam(0.01)
    state = opt.init(scene.materials)
    upd, _ = opt.update(g1, state, scene.materials)
    mats1 = optax.apply_updates(scene.materials, upd)
    step = pmesh.make_train_step(scene, cfg, target, m4, opt)
    loss4, mats4, _ = step(scene.materials, state)
    print(f"  train step loss x4 {float(loss4):.8e} vs one card "
          f"{float(loss1):.8e}", flush=True)
    # Each card's partial sums of the loss and grads are psum'ed, in
    # another order than the one-card sums: f32 association, not bits.
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-5)
    for name in ("albedo", "emission"):
        a = np.asarray(getattr(mats4, name))
        b = np.asarray(getattr(mats1, name))
        print(f"  updated {name} x4 vs one card: max abs diff "
              f"{np.abs(a - b).max():.2e}", flush=True)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path over four cards")
    args = ap.parse_args(argv)
    try:
        import pathtracer  # noqa: F401
    except ImportError:
        print("chip_smoke: the pathtracer package is not importable; "
              "run from the repo root", file=sys.stderr)
        return 2
    import jax

    from pathtracer.utils.cache import enable

    enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    ph = Phases()
    card = ph.run("device", phase_device)
    if args.chips == 4:
        ph.run("sharded x4", phase_sharded)
    else:
        ph.run("kernels", phase_kernels)
        ph.run("render", phase_render, card)
        ph.run("grad", phase_grad)
    if ph.failed:
        print(f"chip_smoke: FAILED phases: {', '.join(ph.failed)}",
              file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
