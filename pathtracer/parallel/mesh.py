"""Distributed rendering: ray/tile sharding over a device mesh.

The reference is a single-GPU desktop app — its only parallelism is the
CUDA grid (SURVEY.md §2.2). This framework's central scaling strategy is
data parallelism over rays/pixels: the image's pixel space is sharded
across every device of a mesh via `shard_map`, the scene/BVH pytree is
replicated (BASELINE.json:5,11), and material gradients are all-reduced
with `psum` inside the sharded backward pass — XLA schedules the
collective (NCCL over NVLink between the GPUs of a host) with the
remaining backward computation (SURVEY.md §2.2, §3.4/3.5).

Determinism contract: all sampling keys off absolute pixel ids
(sampling/rng.py), so the sharded render equals the single-device render
bit-for-bit at fixed seeds — asserted in tests/dist/test_sharding.py.

Multi-host usage (config 5, BASELINE.json:11): each host calls
`jax.distributed.initialize(...)` (see initialize_distributed), after which
`jax.devices()` spans every host's devices and the same code below shards
over all of them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..engine.wavefront import trace_sample
from ..scene.model import Scene

AXIS = "rays"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join a multi-host process group (no-op for single host).

    Per-host entry for multi-host runs (SURVEY.md §3.5): call before any
    jax computation; afterwards jax.devices() spans all hosts' devices.
    jax.distributed needs the coordinator address ("host:port"), the
    process count and this process's id spelled out.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the ray/pixel axis.

    A single flat axis deliberately: the workload is embarrassingly data
    parallel over rays, and the GPUs of a host reach each other all to
    all over NVLink, so the mesh follows the algorithm alone. (No TP/PP
    axes — there are no weight matrices to shard; SURVEY.md §2.2.)
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _padded_ids(cfg: RenderConfig, n_shards: int):
    """Row-major pixel ids padded to a multiple of the shard count.

    Padding rays trace pixel 0 redundantly (their radiance is dropped on
    the host side); wasted lanes are < n_shards pixels total.
    """
    n = cfg.n_pixels
    pad = (-n) % n_shards
    ids = np.arange(n + pad, dtype=np.uint32)
    ids[n:] = 0
    return ids, pad


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh | None = None,
                   materials=None):
    """Full render with pixels sharded over the mesh → (H, W, 3) image."""
    if mesh is None:
        mesh = make_mesh()
    mats = materials if materials is not None else scene.materials
    n_shards = mesh.devices.size
    ids, pad = _padded_ids(cfg, n_shards)

    out = _render_sharded_jit(
        scene.geometry, mats, scene.camera, scene.lights, jnp.asarray(ids),
        cfg, mesh,
    )
    img = out[: cfg.n_pixels] / jnp.float32(cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_sharded_jit(geometry, materials, camera, lights, pixel_ids,
                        cfg: RenderConfig, mesh: Mesh):
    # check_vma=False: the Pallas hit-query kernel's out_shapes do
    # not declare varying-manual-axes metadata, which the vma checker
    # requires inside shard_map; correctness of the sharded render is
    # asserted bit-exactly against the single-device render instead
    # (tests/dist/test_sharding.py).
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    def tile(geometry, materials, camera, lights, ids):
        def body(i, acc):
            return acc + trace_sample(
                geometry, materials, camera, lights, cfg, ids, jnp.uint32(i)
            )

        init = jnp.zeros((ids.shape[0], 3), jnp.float32)
        if cfg.spp == 1:
            return body(0, init)
        # The carry varies over the manual mesh axis (it accumulates
        # per-shard radiance); mark the zero init accordingly.
        init = jax.lax.pcast(init, (AXIS,), to="varying")
        return jax.lax.fori_loop(0, cfg.spp, body, init)

    return tile(geometry, materials, camera, lights, pixel_ids)


def loss_and_grad_sharded(scene: Scene, cfg: RenderConfig, materials, target,
                          mesh: Mesh | None = None):
    """Sharded forward+backward: mean-squared image loss vs `target`,
    gradients w.r.t. the material pytree psum'ed inside the
    sharded backward (SURVEY.md §3.4). Returns (loss, grads), replicated.
    """
    if mesh is None:
        mesh = make_mesh()
    n_shards = mesh.devices.size
    ids, pad = _padded_ids(cfg, n_shards)
    tgt = np.asarray(target, np.float32).reshape(-1, 3)
    if pad:
        tgt = np.concatenate([tgt, np.zeros((pad, 3), np.float32)])
    # Padding rays are masked out of the loss; divide by true pixel count.
    w = np.ones((len(ids), 1), np.float32)
    if pad:
        w[cfg.n_pixels:] = 0.0
    return _loss_grad_jit(
        scene.geometry, materials, scene.camera, scene.lights,
        jnp.asarray(ids), jnp.asarray(tgt), jnp.asarray(w), cfg, mesh,
    )


def _loss_grad_core(geometry, materials, camera, lights, pixel_ids, target,
                    weight, cfg: RenderConfig, mesh: Mesh):
    n_total = cfg.n_pixels * 3

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(geometry, materials, camera, lights, ids, tgt, w):
        def loss_fn(mats):
            def body(i, acc):
                return acc + trace_sample(
                    geometry, mats, camera, lights, cfg, ids, jnp.uint32(i)
                )

            init = jnp.zeros((ids.shape[0], 3), jnp.float32)
            if cfg.spp == 1:
                acc = body(0, init)
            else:
                init = jax.lax.pcast(init, (AXIS,), to="varying")
                acc = jax.lax.fori_loop(0, cfg.spp, body, init)
            img = acc / jnp.float32(cfg.spp)
            # Local sum of squared error; global mean after psum.
            return jnp.sum(w * (img - tgt) ** 2) / n_total

        loss, grads = jax.value_and_grad(loss_fn)(materials)
        # The all-reduce. With vma tracking ON, shard_map AD inserts
        # this psum automatically when transposing the unvarying-materials
        # broadcast — but vma is disabled here (check_vma=False above, for
        # the Pallas kernels), so the transpose yields SHARD-LOCAL grads
        # and both the loss and the grads need the explicit psum.
        loss = jax.lax.psum(loss, AXIS)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, AXIS), grads)
        return loss, grads

    return step(geometry, materials, camera, lights, pixel_ids, target, weight)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _loss_grad_jit(geometry, materials, camera, lights, pixel_ids, target,
                   weight, cfg: RenderConfig, mesh: Mesh):
    return _loss_grad_core(
        geometry, materials, camera, lights, pixel_ids, target, weight, cfg,
        mesh,
    )


def make_train_step(scene: Scene, cfg: RenderConfig, target, mesh: Mesh,
                    optimizer):
    """One fully jitted inverse-rendering training step over the mesh.

    The flagship "training" workload (driver config 4/5 combined): fit the
    material pytree so the rendered image matches `target`. Forward +
    backward run sharded over rays; grads psum inside the sharded
    region; the optax update runs on the replicated params — all one XLA
    program per step.

    Returns step(materials, opt_state) -> (loss, materials, opt_state).
    """
    import optax

    n_shards = mesh.devices.size
    ids, pad = _padded_ids(cfg, n_shards)
    tgt = np.asarray(target, np.float32).reshape(-1, 3)
    if pad:
        tgt = np.concatenate([tgt, np.zeros((pad, 3), np.float32)])
    w = np.ones((len(ids), 1), np.float32)
    if pad:
        w[cfg.n_pixels:] = 0.0
    ids_j, tgt_j, w_j = jnp.asarray(ids), jnp.asarray(tgt), jnp.asarray(w)
    geometry, camera, lights = scene.geometry, scene.camera, scene.lights

    @jax.jit
    def step(materials, opt_state):
        loss, grads = _loss_grad_core(
            geometry, materials, camera, lights, ids_j, tgt_j, w_j, cfg, mesh
        )
        updates, opt_state = optimizer.update(grads, opt_state, materials)
        materials = optax.apply_updates(materials, updates)
        return loss, materials, opt_state

    return step
