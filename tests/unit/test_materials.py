"""Material scatter math (SURVEY.md §2.1 R4: the smallpt-style
DIFF/SPEC/REFR palette): mirror reflection, Snell refraction with total
internal reflection, and Schlick Fresnel — jnp helpers vs closed forms,
and the oracle's numpy mirror of the same math."""

import numpy as np

from pathtracer.engine import shading


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def test_reflect_known_vectors():
    # 45-degree incidence on the y=0 plane.
    d = np.array([[1.0, -1.0, 0.0]], np.float32) / np.sqrt(2)
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    cos_o = -np.sum(d * n, -1)
    r = np.asarray(shading.reflect(d, n, cos_o))
    np.testing.assert_allclose(
        r, np.array([[1.0, 1.0, 0.0]]) / np.sqrt(2), atol=1e-6
    )
    # Normal incidence reflects straight back.
    d = np.array([[0.0, -1.0, 0.0]], np.float32)
    r = np.asarray(shading.reflect(d, n, -np.sum(d * n, -1)))
    np.testing.assert_allclose(r, [[0.0, 1.0, 0.0]], atol=1e-6)


def test_refract_snell_law():
    """Exit angle obeys sin(t) = eta * sin(i) below the critical angle."""
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    eta = np.array([1.0 / 1.5], np.float32)  # air -> glass
    for deg in (0.0, 20.0, 45.0, 70.0):
        th = np.radians(deg)
        d = np.array(
            [[np.sin(th), -np.cos(th), 0.0]], np.float32
        )
        cos_o = -np.sum(d * n, -1)
        t, tir = shading.refract_dir(d, n, cos_o, eta)
        t = np.asarray(t)
        assert not bool(np.asarray(tir)[0])
        sin_t = np.linalg.norm(np.cross(t[0], n[0]))
        np.testing.assert_allclose(
            sin_t, float(eta[0]) * np.sin(th), atol=1e-6
        )
        np.testing.assert_allclose(np.linalg.norm(t[0]), 1.0, atol=1e-6)
        assert t[0, 1] < 0.0  # continues into the surface


def test_total_internal_reflection():
    """Glass -> air beyond the ~41.8 degree critical angle flags TIR."""
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    eta = np.array([1.5], np.float32)  # glass -> air
    th = np.radians(60.0)
    d = np.array([[np.sin(th), -np.cos(th), 0.0]], np.float32)
    cos_o = -np.sum(d * n, -1)
    _, tir = shading.refract_dir(d, n, cos_o, eta)
    assert bool(np.asarray(tir)[0])
    # Below critical angle: no TIR.
    th = np.radians(30.0)
    d = np.array([[np.sin(th), -np.cos(th), 0.0]], np.float32)
    _, tir = shading.refract_dir(d, n, -np.sum(d * n, -1), eta)
    assert not bool(np.asarray(tir)[0])


def test_schlick_limits():
    ior = np.float32(1.5)
    r0 = ((1.5 - 1.0) / (1.5 + 1.0)) ** 2
    # Normal incidence -> R0; grazing -> 1.
    np.testing.assert_allclose(
        float(shading.schlick(np.float32(1.0), ior)), r0, rtol=1e-6
    )
    np.testing.assert_allclose(
        float(shading.schlick(np.float32(0.0), ior)), 1.0, rtol=1e-6
    )
    # Monotone decreasing in cos.
    cs = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    vals = np.asarray(shading.schlick(cs, ior))
    assert np.all(np.diff(vals) <= 1e-7)


def test_mirror_image_of_light_present():
    """spec_chain rule: a mirror sphere must show the light's reflection
    (a diffuse->specular->light path), which plain NEE cannot produce."""
    from pathtracer.config import RenderConfig
    from pathtracer.engine import wavefront
    from pathtracer.scene import builder

    scene = builder.cornell_specular()
    cfg = RenderConfig(
        width=48, height=48, spp=1, max_depth=3, rr_start=99,
        scene="cornell_specular", use_bvh=False,
    )
    img = np.asarray(wavefront.render(scene, cfg))
    assert np.isfinite(img).all()
    # The mirror sphere occupies the lower-left of the frame; the bright
    # ceiling light (radiance ~13) must reflect somewhere in it: some
    # pixel well above any diffuse wall radiance.
    assert img.max() > 5.0


def test_take_small_rows_matches_gather_and_grads():
    """take_small_rows (the scatter-free small-table lookup) must be
    forward-bit-identical to rows[idx] and produce the same gradients —
    its transpose is masked dense reductions instead of a scatter-add."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(7)
    rows = jnp.asarray(rng.normal(size=(5, 16)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, 5, size=333).astype(np.int32))

    out = shading.take_small_rows(rows, idx)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(rows[idx]))

    cot = jnp.asarray(rng.normal(size=(333, 16)).astype(np.float32))

    def f_sel(r):
        return jnp.sum(shading.take_small_rows(r, idx) * cot)

    def f_gat(r):
        return jnp.sum(r[idx] * cot)

    g_sel = np.asarray(jax.grad(f_sel)(rows))
    g_gat = np.asarray(jax.grad(f_gat)(rows))
    np.testing.assert_allclose(g_sel, g_gat, rtol=1e-6, atol=1e-6)

    # Large tables fall back to the plain gather (identical results).
    big = jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32))
    bidx = jnp.asarray(rng.integers(0, 64, size=100).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(shading.take_small_rows(big, bidx)),
        np.asarray(big[bidx]))

    # Edge indices (negative: the engine's miss-lane mat=-1; out of
    # range): both paths must agree in FORWARD (jax wraps negatives,
    # clamps OOB) and in GRADIENT (jax's gather transpose accumulates
    # wrapped indices but DROPS clamped-OOB cotangents — the custom bwd
    # mirrors that, code-review r5).
    for pattern in ([0, 2, -1, 5], [-5, -3, 7, 1]):
        eidx = jnp.asarray(np.array(pattern, np.int32))
        np.testing.assert_array_equal(
            np.asarray(shading.take_small_rows(rows, eidx)),
            np.asarray(rows[eidx]))
        w = cot[: len(pattern)]
        ge_sel = np.asarray(jax.grad(
            lambda r: jnp.sum(shading.take_small_rows(r, eidx) * w))(rows))
        ge_gat = np.asarray(jax.grad(
            lambda r: jnp.sum(r[eidx] * w))(rows))
        np.testing.assert_array_equal(ge_sel, ge_gat)
