"""Gradient tests (SURVEY.md §4.3, driver config 4 / BASELINE.json:10):
jax.grad of image loss w.r.t. albedo/emission vs central finite
differences, on both the engine and the oracle."""

import dataclasses

import jax
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.diff import render as dr
from pathtracer.oracle import tracer as oracle
from pathtracer.scene import builder
from pathtracer.scene.model import Materials


@pytest.fixture(scope="module")
def scene():
    return builder.cornell_spheres()


def _cfg(**kw):
    base = dict(
        width=24, height=24, spp=2, max_depth=2, scene="cornell_spheres",
        use_bvh=False, rr_start=99,  # RR off: finite differences of the
        # estimator stay smooth (kill decisions don't flip with params)
    )
    base.update(kw)
    return RenderConfig(**base)


def _perturb(mats, field, idx, ch, eps):
    arr = np.asarray(getattr(mats, field)).copy()
    arr[idx, ch] += eps
    return dataclasses.replace(mats, **{field: arr})


def _fd_grad_engine(scene, cfg, field, idx, ch, eps=2e-3):
    lo = dr.render_image(scene, cfg, _perturb(scene.materials, field, idx, ch, -eps))
    hi = dr.render_image(scene, cfg, _perturb(scene.materials, field, idx, ch, +eps))
    return (np.asarray(hi).mean() - np.asarray(lo).mean()) / (2 * eps)


def _fd_grad_oracle(scene, cfg, field, idx, ch, eps=2e-3):
    s_lo = dataclasses.replace(
        scene, materials=_perturb(scene.materials, field, idx, ch, -eps)
    )
    s_hi = dataclasses.replace(
        scene, materials=_perturb(scene.materials, field, idx, ch, +eps)
    )
    return (
        oracle.render(s_hi, cfg).mean() - oracle.render(s_lo, cfg).mean()
    ) / (2 * eps)


def test_albedo_grad_matches_finite_diff(scene):
    cfg = _cfg()
    _, grads = dr.grad_render(scene, cfg)  # d(mean image)/d(materials)
    g = np.asarray(grads.albedo)
    for idx, ch in [(builder.WHITE, 0), (builder.RED, 0), (builder.GREEN, 1)]:
        fd = _fd_grad_engine(scene, cfg, "albedo", idx, ch)
        np.testing.assert_allclose(g[idx, ch], fd, rtol=2e-2, atol=1e-5)


def test_emission_grad_matches_finite_diff(scene):
    cfg = _cfg(max_depth=1)
    _, grads = dr.grad_render(scene, cfg)
    g = np.asarray(grads.emission)
    for ch in range(3):
        fd = _fd_grad_engine(scene, cfg, "emission", builder.LIGHT, ch)
        np.testing.assert_allclose(g[builder.LIGHT, ch], fd, rtol=2e-2,
                                   atol=1e-6)


def test_grad_matches_oracle_finite_diff(scene):
    """Close the loop to the oracle: engine autodiff == oracle finite
    differences (the two implementations share only the semantics)."""
    cfg = _cfg(width=16, height=16, spp=1)
    _, grads = dr.grad_render(scene, cfg)
    fd = _fd_grad_oracle(scene, cfg, "albedo", builder.WHITE, 1)
    np.testing.assert_allclose(
        np.asarray(grads.albedo)[builder.WHITE, 1], fd, rtol=3e-2, atol=1e-5
    )


def test_geometry_receives_no_grad(scene):
    """Detach policy: grads w.r.t. geometry arrays are identically zero."""
    cfg = _cfg(width=8, height=8, spp=1)

    float_fields = ("tri_v0", "tri_e1", "tri_e2", "tri_n", "sph_c", "sph_r")

    def f(*float_leaves):
        from pathtracer.engine.wavefront import trace_sample
        import jax.numpy as jnp

        geom = dataclasses.replace(
            scene.geometry, **dict(zip(float_fields, float_leaves))
        )
        ids = jnp.arange(cfg.n_pixels, dtype=jnp.uint32)
        out = trace_sample(
            geom, scene.materials, scene.camera, scene.lights, cfg, ids,
            jnp.uint32(0),
        )
        return jnp.mean(out)

    leaves = [np.asarray(getattr(scene.geometry, n)) for n in float_fields]
    grads = jax.grad(f, argnums=tuple(range(len(leaves))))(*leaves)
    for name, g in zip(float_fields, grads):
        assert np.all(np.asarray(g) == 0.0), name


def test_unseen_material_gets_zero_grad(scene):
    cfg = _cfg(width=16, height=16, spp=1, max_depth=1)
    mats = scene.materials
    extended = Materials(
        albedo=np.concatenate(
            [np.asarray(mats.albedo), [[0.5, 0.5, 0.5]]]
        ).astype(np.float32),
        emission=np.concatenate(
            [np.asarray(mats.emission), [[0, 0, 0]]]
        ).astype(np.float32),
    )
    s2 = dataclasses.replace(scene, materials=extended)
    _, grads = dr.grad_render(s2, cfg)
    assert np.all(np.asarray(grads.albedo)[-1] == 0.0)
    assert np.all(np.asarray(grads.emission)[-1] == 0.0)


def test_inverse_rendering_converges(scene):
    """End-to-end optimization: recover a perturbed albedo by gradient
    descent on the image loss (the flagship differentiable use case)."""
    import optax

    cfg = _cfg(width=16, height=16, spp=2, max_depth=2)
    target = np.asarray(dr.render_image(scene, cfg, scene.materials))

    start = _perturb(
        _perturb(scene.materials, "albedo", builder.WHITE, 0, -0.25),
        "albedo", builder.RED, 0, 0.2,
    )
    opt = optax.adam(0.05)
    state = opt.init(start)
    mats = start
    loss0 = None
    loss30 = None
    for it in range(45):
        loss, grads = dr.loss_and_grad(scene, cfg, mats, target)
        if loss0 is None:
            loss0 = float(loss)
        if it == 30:
            loss30 = float(loss)
        updates, state = opt.update(grads, state, mats)
        mats = optax.apply_updates(mats, updates)
    # Early-progress guard: the extra iterations must not
    # mask a convergence-speed regression — by iter 30 the loss has to be
    # well on its way, not just under the final bound at iter 45.
    assert loss30 < 0.30 * loss0, (loss0, loss30)
    assert float(loss) < 0.05 * loss0, (loss0, float(loss))
    np.testing.assert_allclose(
        np.asarray(mats.albedo)[builder.WHITE],
        np.asarray(scene.materials.albedo)[builder.WHITE],
        atol=0.05,
    )
