"""Differentiable rendering: grads of pixel radiance w.r.t. materials.

The reference is entirely non-differentiable (SURVEY.md §1.3 T0 "replaces:
nothing"); this module is the capability the JAX rebuild adds on top of
parity: reverse-mode gradients of the rendered image w.r.t. the material
pytree (albedo, emission) and, through it, light brightness — the exact
scope of BASELINE.json:5.

Detach policy (SURVEY.md §7 hard part 3), implemented inside
engine/wavefront.py:trace_sample and re-stated here as the contract:

  * intersection outputs (t, normal, hit id) are `stop_gradient`ed —
    geometry is piecewise-constant w.r.t. materials anyway;
  * the NEE geometric term (cosines, 1/d^2, area) is detached;
  * Russian-roulette continuation probabilities are detached (the
    estimator stays unbiased; grads flow through the surviving paths'
    1/p weights as constants);
  * grads flow through: emission gathers on primary hits, the
    multiplicative albedo throughput chain, and the NEE product
    albedo * emission_light.

Gradients are validated against central finite differences of the oracle
and of the engine itself in tests/grad/test_grad.py (config 4,
BASELINE.json:10).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..engine.wavefront import trace_sample
from ..scene.model import Materials, Scene


def render_image(scene: Scene, cfg: RenderConfig, materials: Materials):
    """Differentiable full render → (H, W, 3); jit-cached per cfg."""
    return _render_image_jit(
        scene.geometry, materials, scene.camera, scene.lights, cfg
    )


@partial(jax.jit, static_argnames=("cfg",))
def _render_image_jit(geometry, materials, camera, lights, cfg):
    ids = jnp.arange(cfg.n_pixels, dtype=jnp.uint32)

    def body(i, acc):
        return acc + trace_sample(
            geometry, materials, camera, lights, cfg, ids, jnp.uint32(i)
        )

    if cfg.spp == 1:
        acc = body(0, jnp.zeros((cfg.n_pixels, 3), jnp.float32))
    else:
        # Remat each sample in the backward pass: memory stays O(1 spp)
        # instead of O(spp) residuals (SURVEY.md §5.7).
        acc = jax.lax.fori_loop(
            0, cfg.spp, jax.checkpoint(body),
            jnp.zeros((cfg.n_pixels, 3), jnp.float32),
        )
    return (acc / jnp.float32(cfg.spp)).reshape(cfg.height, cfg.width, 3)


def default_loss(img, target):
    return jnp.mean((img - target) ** 2)


def loss_and_grad(scene: Scene, cfg: RenderConfig, materials: Materials,
                  target, loss_fn=default_loss):
    """(loss, grads-w.r.t.-materials) for an image loss against target."""

    def f(mats):
        return loss_fn(render_image(scene, cfg, mats), target)

    return jax.value_and_grad(f)(materials)


def grad_render(scene: Scene, cfg: RenderConfig, loss_fn=None, target=None):
    """Convenience API: grads of the scene's own materials.

    With no target, differentiates the mean pixel radiance (a scalar probe
    of d(image)/d(materials)); with a target, an MSE inverse-rendering
    loss.
    """
    if target is None:
        def f(mats):
            img = render_image(scene, cfg, mats)
            return jnp.mean(img) if loss_fn is None else loss_fn(img)

        return jax.value_and_grad(f)(scene.materials)
    return loss_and_grad(
        scene, cfg, scene.materials, target,
        loss_fn or default_loss,
    )
