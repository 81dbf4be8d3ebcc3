"""End-to-end comparison of the hit-query routes on the GPU.

Renders one frame of each scene with each closest-hit route through
pt.render(with_stats=True) and prints one JSON line per (scene, route):
compile seconds (first call), frame milliseconds (median of the timed
frames), useful rays per frame and useful rays/s, beside the card's name
and power limit. cornell_mesh renders the bench preset, big_mesh config5
(both 1024x1024, 1 spp, depth 4). "big_mesh:N" is big_mesh cut to about
N triangles, rendered at the bench preset's shape: the mid-size scenes
that place the routing threshold of accel/auto.py.

Routes:
  cluster     dense cluster kernel (ops/intersect_cluster.py), whatever
              the scene's size
  jnp         skip-link BVH walk (accel/traverse.py)

Usage: python scripts/route_compare.py [--scenes cornell_mesh,big_mesh:102400]
           [--routes cluster,jnp] [--frames 3]
           [--out route_compare.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PRESET = {"cornell_mesh": "bench", "big_mesh": "config5"}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "not reported"


def _scene(route, cfg, kw):
    from pathtracer.accel.build import with_bvh
    from pathtracer.accel.clusters import with_clusters
    from pathtracer.scene.builder import build_scene
    from pathtracer.scene.model import scene_to_device

    scene = with_bvh(build_scene(cfg.scene, **kw))
    if route == "cluster":
        scene = with_clusters(scene)
    return scene_to_device(scene)


def measure(spec, route, frames):
    import jax

    import pathtracer as pt
    from pathtracer.config import PRESETS

    name, _, n_tris = spec.partition(":")
    preset = "bench" if n_tris else PRESET[name]
    kw = {"n_target": int(n_tris)} if n_tris else {}
    # use_bvh=False keeps the engine on the cluster kernel above the
    # dense route's size (the BVH stays built for the compaction key).
    cfg = PRESETS[preset].replace(backend=route, scene=name,
                                  use_bvh=route == "jnp")
    scene = _scene(route, cfg, kw)
    t0 = time.perf_counter()
    _, n = jax.block_until_ready(pt.render(scene, cfg, with_stats=True))
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(pt.render(scene, cfg, with_stats=True))
        times.append(time.perf_counter() - t0)
    secs = sorted(times)[len(times) // 2]
    return {
        "scene": spec, "preset": preset, "route": route,
        "triangles": int(scene.geometry.tri_v0.shape[0]),
        "clusters": int(scene.geometry.cl_lo.shape[0]),
        "compact": cfg.compact, "first_call_s": first_s,
        "frame_ms": secs * 1e3, "frame_ms_all": [t * 1e3 for t in times],
        "useful_rays": int(n), "rays_per_s": int(n) / secs,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="cornell_mesh,big_mesh")
    ap.add_argument("--routes", default="cluster,jnp")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default=None, help="also append rows here")
    args = ap.parse_args()

    import jax

    from pathtracer.utils.cache import enable

    enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"route_compare: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    card = _card()
    rc = 0
    for name in args.scenes.split(","):
        for route in args.routes.split(","):
            try:
                row = measure(name, route, args.frames)
            except Exception as e:  # keep measuring the other cells
                row = {"scene": name, "route": route, "error": repr(e)}
                rc = 1
            row.update(card=card, device_kind=dev.device_kind,
                       platform=dev.platform)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
