"""Primary benchmark: useful rays/s per GPU, 1spp 1024x1024 Cornell-mesh.

Prints ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "rays/s", "device": {...}}

Metric definition (BASELINE.json:2): useful rays traced per second per
device on the Cornell-mesh scene at 1spp 1024x1024 (4-bounce path with
NEE shadow rays; ray count measured exactly by the instrumented engine,
dead lanes excluded). The line names the device it ran on: platform,
device_kind, device count and the card's power limit (nvidia-smi).

The measurement is TIME-BOXED (--budget seconds, default 60): whole
frames are rendered and timed to completion until the budget is
exhausted. rays/s = sum(frame rays) / sum(frame seconds).

Without a GPU it exits non-zero, unless --smoke (a tiny CPU-friendly run
whose number is not a device measurement).

Usage: python bench.py [--smoke] [--scene cornell_mesh] [--depth 4]
                       [--backend jnp|cluster] [--budget 60]
                       [--compact] [--grad]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny size, CPU-friendly smoke run")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--budget", type=float, default=60.0,
                    help="wall-clock seconds of timed measurement")
    ap.add_argument("--backend", default=None,
                    choices=["jnp", "cluster"],
                    help="override cfg.backend")
    ap.add_argument("--compact", action="store_true",
                    help="enable stream compaction between bounces")
    ap.add_argument("--grad", action="store_true",
                    help="measure the BACKWARD pass: each timed frame is "
                    "a jitted value_and_grad of an image loss w.r.t. the "
                    "material pytree (forward + reverse through the "
                    "shading chain and the kernels' custom_vjp). rays/s "
                    "then counts forward rays per wall-second of the "
                    "full fwd+bwd step (BASELINE.json:5 'forward+"
                    "backward kernels').")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pathtracer.utils.cache import enable as enable_cache

    enable_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.smoke:
        print(f"bench: needs a GPU, JAX found {dev.platform!r} "
              "(use --smoke for a CPU run)", file=sys.stderr)
        return 2

    from pathtracer.config import PRESETS
    from pathtracer.engine.wavefront import trace_sample
    from pathtracer.scene.builder import build_scene
    from pathtracer.scene.model import scene_to_device
    from pathtracer.utils.logging import log

    cfg = PRESETS["bench"]
    if args.smoke:
        cfg = cfg.replace(width=128, height=128)
        args.budget = min(args.budget, 20.0)
    for field, flag in [("width", "width"), ("height", "height"),
                        ("max_depth", "depth"), ("scene", "scene"),
                        ("backend", "backend"), ("spp", "spp")]:
        v = getattr(args, flag)
        if v is not None:
            cfg = cfg.replace(**{field: v})
    if args.compact:
        cfg = cfg.replace(compact=True)

    from pathtracer.accel.auto import prepare_accel
    from pathtracer.accel.build import with_bvh

    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    # Backend-aware table build + scene-size route (accel/auto.py).
    scene = prepare_accel(scene, cfg)
    scene = scene_to_device(scene)

    from pathtracer.engine.camera import tiled_pixel_ids

    if args.grad:
        # Backward-pass measurement: one full value_and_grad per frame —
        # forward wavefront render + reverse-mode grads of a scalar image
        # loss w.r.t. the material pytree (the differentiable path's
        # honest unit of work; geometry kernels contribute their
        # custom_vjp zero-cotangent backward). The aux ray count is the
        # same useful-ray numerator as the forward metric, so
        # grad rays/s is directly comparable to forward rays/s.
        @jax.jit
        def run(geometry, materials, camera, lights):
            pixel_ids = tiled_pixel_ids(jnp.uint32(0), cfg.n_pixels,
                                        cfg.width)

            def loss_fn(mats):
                rad, n = trace_sample(
                    geometry, mats, camera, lights, cfg, pixel_ids,
                    jnp.uint32(0), with_stats=True,
                )
                return jnp.mean(rad * rad), n

            (loss, n), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(materials)
            # Return a reduction over every grad leaf (plus the loss) so
            # no part of the backward pass can be dead-code-eliminated.
            gsum = loss + sum(jnp.sum(jnp.abs(g))
                              for g in jax.tree.leaves(grads))
            return gsum, n
    else:
        @jax.jit
        def run(geometry, materials, camera, lights):
            # Tile-ordered pixel ids give the cluster intersector's
            # per-tile cull tight primary-ray frustums (ray tiles = pixel
            # tiles, not scanline strips).
            pixel_ids = tiled_pixel_ids(jnp.uint32(0), cfg.n_pixels,
                                        cfg.width)
            return trace_sample(
                geometry, materials, camera, lights, cfg, pixel_ids,
                jnp.uint32(0), with_stats=True,
            )

    sargs = (scene.geometry, scene.materials, scene.camera, scene.lights)

    # Warm-up: compile once.
    t0 = time.perf_counter()
    jax.block_until_ready(run(*sargs))
    log("bench compiled", secs=round(time.perf_counter() - t0, 1),
        cfg=cfg.scene, backend=cfg.backend)

    # Time-boxed measurement: time whole frames, stop at budget.
    samples = []  # (secs, rays) per frame
    deadline = time.perf_counter() + args.budget
    while not samples or time.perf_counter() < deadline:
        t0 = time.perf_counter()
        _, n = jax.block_until_ready(run(*sargs))
        samples.append((time.perf_counter() - t0, int(n)))
        if len(samples) >= 10_000:
            break
    total_secs = sum(s for s, _ in samples)
    total_rays = sum(n for _, n in samples)
    rays_per_s = total_rays / max(total_secs, 1e-12)
    log("bench measured", frames=len(samples), secs=round(total_secs, 3),
        rays=total_rays)

    print(json.dumps({
        "metric": (
            f"{'grad-step ' if args.grad else ''}useful rays/s per device "
            f"({cfg.scene} {cfg.width}x{cfg.height} "
            f"{cfg.spp}spp depth{cfg.max_depth} backend={cfg.backend})"
        ),
        "value": rays_per_s,
        "unit": "rays/s",
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count(), "power_limit": _power_limit(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
