"""Command-line interface (SURVEY.md T13).

Replaces the reference's Qt front-end (SURVEY.md §2.1 R10) with a headless
CLI: render to PNG/npy, resume long renders from accumulator checkpoints,
and fit materials to a target image (inverse rendering). The benchmark is
bench.py at the repo root.

    python -m pathtracer.cli render --preset config3 --out img.png
    python -m pathtracer.cli render --width 512 --spp 256 \
        --checkpoint ck.npz --checkpoint-every 64
    python -m pathtracer.cli fit --target target.npy --steps 100
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_cfg_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default=None,
                   choices=["config1", "config2", "config3", "config4",
                            "config5", "bench"])
    p.add_argument("--scene", default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backend", default=None,
                   choices=["jnp", "cluster"])
    p.add_argument("--compact", action="store_true")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--config-json", default=None,
                   help="path to a RenderConfig JSON (configs/*.json)")
    # Camera overrides: the reference's interactive fly-camera (SURVEY.md
    # §2.1 R9/R10) maps to explicit camera flags; accumulation restarts
    # naturally because a new camera is a new render.
    p.add_argument("--cam-pos", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-look", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-fov", type=float, default=None,
                   help="vertical field of view in degrees")


def _build_cfg(args):
    from .config import PRESETS, RenderConfig

    if args.config_json:
        with open(args.config_json) as f:
            cfg = RenderConfig(**json.load(f))
    elif args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = RenderConfig(width=256, height=256, spp=4, max_depth=4,
                           scene="cornell_mesh")
    over = {}
    for field, flag in [("scene", "scene"), ("width", "width"),
                        ("height", "height"), ("spp", "spp"),
                        ("max_depth", "depth"), ("seed", "seed"),
                        ("backend", "backend")]:
        v = getattr(args, flag)
        if v is not None:
            over[field] = v
    if args.compact:
        over["compact"] = True
    if args.no_bvh:
        over["use_bvh"] = False
    return cfg.replace(**over)


def _prepare_scene(cfg, args=None):
    import dataclasses
    import math

    import numpy as np

    from .accel.build import with_bvh
    from .scene.builder import build_scene
    from .scene.model import Camera, scene_to_device

    scene = build_scene(cfg.scene)
    if args is not None and (args.cam_pos or args.cam_look or args.cam_fov):
        cam = scene.camera
        scene = dataclasses.replace(
            scene,
            camera=Camera(
                position=np.asarray(
                    args.cam_pos or np.asarray(cam.position), np.float32
                ),
                look_at=np.asarray(
                    args.cam_look or np.asarray(cam.look_at), np.float32
                ),
                up=np.asarray(cam.up, np.float32),
                fov_y=np.float32(
                    math.radians(args.cam_fov) if args.cam_fov
                    else np.asarray(cam.fov_y)
                ),
            ),
        )
    if cfg.use_bvh:
        scene = with_bvh(scene)
    # Backend-aware table build + scene-size route (accel/auto.py:
    # backend="cluster" on a large scene walks the BVH).
    from .accel.auto import prepare_accel

    scene = prepare_accel(scene, cfg)
    return scene_to_device(scene)


def cmd_render(args) -> int:
    import numpy as np

    from .engine import wavefront
    from .io import framebuffer as fb

    cfg = _build_cfg(args)
    scene = _prepare_scene(cfg, args)
    t0 = time.time()

    spp_done = 0
    acc = np.zeros((cfg.n_pixels, 3), np.float32)
    if args.resume and os.path.exists(args.resume):
        acc, spp_done, meta = fb.load_accumulator(args.resume)
        acc = acc.reshape(-1, 3).copy()
        print(f"resumed at {spp_done}/{cfg.spp} spp from {args.resume}")

    out = args.out or "render.png"
    # Progressive preview (the headless analogue of the reference's
    # interactive progressive display, SURVEY.md §2.1 R7/R10): every
    # --preview-every spp, overwrite <out>.preview.png with the running
    # average — a long render can be watched converging, and samples are
    # keyed by absolute spp index so previews never perturb the final
    # image (chunked accumulation is exact, engine/wavefront.py).
    preview_path = None
    if args.preview_every:
        stem, ext = os.path.splitext(out)
        preview_path = stem + ".preview" + (ext if ext == ".npy" else ".png")

    # Per-feature due thresholds (fire when spp_done reaches the next
    # multiple, then advance it) rather than exact-modulo gates: with
    # e.g. --checkpoint-every 10 --preview-every 3 the loop advances in
    # chunks of 3 and spp_done % 10 == 0 would only fire at multiples of
    # 30. Chunks also shrink to land exactly on the nearest
    # upcoming threshold, so firings stay on their own multiples.
    def _next_due(every, spp_done):
        return ((spp_done // every) + 1) * every if every else None

    next_ckpt = _next_due(args.checkpoint_every, spp_done)
    next_prev = _next_due(args.preview_every, spp_done)
    base_chunk = cfg.spp_chunk or cfg.spp
    while spp_done < cfg.spp:
        n = min(base_chunk, cfg.spp - spp_done)
        for due in (next_ckpt, next_prev):
            if due is not None and due > spp_done:
                n = min(n, due - spp_done)
        part = np.asarray(
            wavefront.render_accumulate(scene, cfg, spp_start=spp_done,
                                        n_spp=n)
        )
        acc += part
        spp_done += n
        done = spp_done >= cfg.spp
        if args.checkpoint and (
            done or not args.checkpoint_every
            or (next_ckpt is not None and spp_done >= next_ckpt)
        ):
            fb.save_accumulator(args.checkpoint, acc, spp_done,
                                {"cfg": cfg.to_json()})
            print(f"checkpointed {spp_done}/{cfg.spp} spp")
            next_ckpt = _next_due(args.checkpoint_every, spp_done)
        if preview_path and (
            done or (next_prev is not None and spp_done >= next_prev)
        ):
            next_prev = _next_due(args.preview_every, spp_done)
            pimg = (acc / spp_done).reshape(cfg.height, cfg.width, 3)
            if preview_path.endswith(".npy"):
                fb.write_npy(preview_path, pimg)
            else:
                fb.write_png(preview_path, pimg)
            print(f"preview {spp_done}/{cfg.spp} spp -> {preview_path} "
                  f"({time.time() - t0:.1f}s)")
    img = (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
    dt = time.time() - t0
    print(f"rendered {cfg.width}x{cfg.height} {cfg.spp}spp "
          f"depth{cfg.max_depth} in {dt:.2f}s")

    if out.endswith(".npy"):
        fb.write_npy(out, img)
    else:
        fb.write_png(out, img)
    print(f"wrote {out}")
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering: optimize materials to match a target image."""
    import numpy as np
    import optax

    from .diff import render as dr
    from .io import framebuffer as fb

    cfg = _build_cfg(args)
    scene = _prepare_scene(cfg, args)
    if args.target:
        target = np.load(args.target)
    else:
        # Self-calibration demo: render the target with true materials,
        # start from a perturbed guess, recover.
        target = np.asarray(dr.render_image(scene, cfg, scene.materials))
        print("no --target given: using self-render as target (demo mode)")

    mats = scene.materials
    if args.perturb:
        import dataclasses

        rng = np.random.default_rng(0)
        albedo = np.clip(
            np.asarray(mats.albedo)
            + rng.normal(0, 0.15, np.asarray(mats.albedo).shape), 0.05, 0.95
        ).astype(np.float32)
        mats = dataclasses.replace(mats, albedo=albedo)

    opt = optax.adam(args.lr)
    state = opt.init(mats)
    for step in range(args.steps):
        loss, grads = dr.loss_and_grad(scene, cfg, mats, target)
        updates, state = opt.update(grads, state, mats)
        mats = optax.apply_updates(mats, updates)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}")
        if args.fit_checkpoint and step % 20 == 19:
            np.savez(
                args.fit_checkpoint,
                albedo=np.asarray(mats.albedo),
                emission=np.asarray(mats.emission),
                step=step,
            )
    img = np.asarray(dr.render_image(scene, cfg, mats))
    if args.out:
        fb.write_png(args.out, img)
        print(f"wrote {args.out}")
    print("final albedo:", np.asarray(mats.albedo).round(3).tolist())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pathtracer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG/npy")
    _add_cfg_flags(pr)
    pr.add_argument("--out", default=None)
    pr.add_argument("--checkpoint", default=None,
                    help="accumulator checkpoint path (.npz)")
    pr.add_argument("--checkpoint-every", type=int, default=None,
                    help="spp per checkpointed chunk")
    pr.add_argument("--resume", default=None,
                    help="resume from an accumulator checkpoint")
    pr.add_argument("--preview-every", type=int, default=None,
                    help="dump a converging <out>.preview image every N "
                    "spp (progressive-display analogue)")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse rendering: fit materials")
    _add_cfg_flags(pf)
    pf.add_argument("--target", default=None, help=".npy target image")
    pf.add_argument("--steps", type=int, default=50)
    pf.add_argument("--lr", type=float, default=0.03)
    pf.add_argument("--perturb", action="store_true",
                    help="perturb start materials (demo)")
    pf.add_argument("--out", default=None)
    pf.add_argument("--fit-checkpoint", default=None)
    pf.set_defaults(fn=cmd_fit)

    args = ap.parse_args(argv)
    from .utils.cache import enable

    enable()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
