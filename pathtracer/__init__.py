"""pathtracer: a differentiable wavefront path tracer for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Ashish424/G.P.U-PathTracer (a CUDA/Qt megakernel path tracer): flat SoA
BVH + Möller–Trumbore intersection, a jit-compiled wavefront bounce loop,
stateless threefry sampling, reverse-mode gradients of pixel radiance
w.r.t. materials, and ray/tile sharding over a device mesh. See
SURVEY.md for the full architecture map.
"""

from .config import PRESETS, RenderConfig
from .scene.builder import build_scene

__all__ = [
    "PRESETS",
    "RenderConfig",
    "build_scene",
    "render",
    "grad_render",
]


def render(scene, cfg, materials=None, with_stats=False):
    """Render a scene with the wavefront engine → (H, W, 3) array, or
    (image, useful rays traced) with with_stats=True."""
    from .engine.wavefront import render as _render

    return _render(scene, cfg, materials=materials, with_stats=with_stats)


def grad_render(scene, cfg, loss_fn=None, target=None):
    """Gradients of an image loss w.r.t. the material pytree."""
    from .diff.render import grad_render as _grad_render

    return _grad_render(scene, cfg, loss_fn=loss_fn, target=target)
