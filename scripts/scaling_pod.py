"""Multi-device / multi-host scaling benchmark — the config-5 entry
(SURVEY.md §3.5; BASELINE.json:11: "2M-triangle scene, tiles+rays
sharded, grads allreduced").

The image's pixel space is sharded over every device via shard_map
(parallel/mesh.py), and process 0 reports rays/s per device plus the
scaling efficiency against a supplied single-device reference:

    # one host, all its GPUs:
    python scripts/scaling_pod.py --scene big_mesh --grad \
        --single-chip-ref <rays/s of one GPU>

    # several hosts: one copy per host, with explicit process-group flags
    # (jax.distributed needs the coordinator, count and id):
    python scripts/scaling_pod.py --coordinator host0:8476 \
        --num-processes 2 --process-id $ID ...

    # smoke test without hardware (8 virtual CPU devices, one process):
    python scripts/scaling_pod.py --cpu-virtual 8 --scene cornell_spheres \
        --width 64 --height 64 --budget 5

Determinism contract: sampling keys off absolute pixel ids, so the
sharded render equals the single-device render bit-for-bit at fixed
seeds regardless of N (tests/dist/).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="big_mesh")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--backend", default=None,
                    help="default: the bench preset's (auto-routed)")
    ap.add_argument("--budget", type=float, default=60.0)
    ap.add_argument("--grad", action="store_true",
                    help="time sharded train steps (fwd+bwd+psum+update) "
                    "instead of forward renders")
    ap.add_argument("--single-chip-ref", type=float, default=None,
                    help="single-device rays/s to compute scaling_eff "
                    "against (bench.py on one GPU)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cpu-virtual", type=int, default=0,
                    help="smoke mode: N virtual CPU devices, one process")
    args = ap.parse_args()

    if args.cpu_virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        if "--xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{args.cpu_virtual}"
            ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    if args.cpu_virtual:
        jax.config.update("jax_platforms", "cpu")

    from pathtracer.utils.cache import enable as enable_cache

    enable_cache()

    import numpy as np

    from pathtracer.accel.auto import prepare_accel
    from pathtracer.accel.build import with_bvh
    from pathtracer.config import PRESETS
    from pathtracer.parallel import mesh as pmesh
    from pathtracer.scene.builder import build_scene
    from pathtracer.scene.model import scene_to_device
    from pathtracer.utils.logging import log

    # Join the process group BEFORE any jax computation; single host /
    # smoke mode skips it.
    if args.num_processes and args.num_processes > 1:
        pmesh.initialize_distributed(args.coordinator, args.num_processes,
                                     args.process_id)

    n_chips = jax.device_count()
    n_hosts = jax.process_count()
    host0 = jax.process_index() == 0

    cfg = PRESETS["bench"].replace(
        scene=args.scene, width=args.width, height=args.height,
        max_depth=args.depth,
    )
    if args.backend:
        cfg = cfg.replace(backend=args.backend)

    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    scene = scene_to_device(prepare_accel(scene, cfg))
    mesh = pmesh.make_mesh(n_chips)

    if args.grad:
        import optax

        target = np.zeros((cfg.height, cfg.width, 3), np.float32)
        optimizer = optax.adam(1e-2)
        step = pmesh.make_train_step(scene, cfg, target, mesh, optimizer)
        opt_state = optimizer.init(scene.materials)
        mats = scene.materials

        def run_once():
            nonlocal mats, opt_state
            loss, mats, opt_state = step(mats, opt_state)
            return float(loss)  # host fetch = completion barrier
    else:
        def run_once():
            img = pmesh.render_sharded(scene, cfg, mesh)
            return float(img[0, 0, 0])

    t0 = time.perf_counter()
    run_once()
    if host0:
        log("scaling_pod compiled", secs=round(time.perf_counter() - t0, 1),
            chips=n_chips, hosts=n_hosts, scene=cfg.scene,
            backend=cfg.backend, grad=args.grad)

    # Frames are identical, so time whole frames and multiply by the
    # engine's exact useful-ray count of one frame (counted below).
    samples = []
    deadline = time.perf_counter() + args.budget
    while not samples or time.perf_counter() < deadline:
        t0 = time.perf_counter()
        run_once()
        samples.append(time.perf_counter() - t0)
        if len(samples) >= 10_000:
            break
    secs = sum(samples)
    frames = len(samples)

    # Count useful rays exactly, once, with the instrumented engine on
    # the same pixel ids (single-device; ray counts are sharding-
    # independent by the determinism contract).
    import jax.numpy as jnp

    from pathtracer.engine.wavefront import trace_sample

    @jax.jit
    def count_rays():
        ids = jnp.arange(cfg.n_pixels, dtype=jnp.uint32)
        _, n = trace_sample(scene.geometry, scene.materials, scene.camera,
                            scene.lights, cfg, ids, jnp.uint32(0),
                            with_stats=True)
        return n

    rays_per_frame = int(count_rays())
    rays_per_s = rays_per_frame * frames / max(secs, 1e-12)
    per_chip = rays_per_s / n_chips
    eff = (per_chip / args.single_chip_ref
           if args.single_chip_ref else None)

    if host0:
        log("scaling_pod measured", frames=frames,
            secs=round(secs, 2), rays_per_frame=rays_per_frame)
        import json

        dev = jax.devices()[0]
        print(json.dumps({
            "metric": f"rays/s per device sharded ({cfg.scene} {n_chips} "
                      f"devices {n_hosts} hosts"
                      f"{' grad' if args.grad else ''})",
            "value": per_chip,
            "unit": "rays/s",
            "scaling_eff": eff,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": n_chips},
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
