"""Threefry sampler tests: determinism, stream decorrelation, distribution
(SURVEY.md §4.1). Bit-exactness across backends is what makes the CPU
oracle comparable to GPU renders; determinism and pixel-id keying here
underwrite that and the sharding contract."""

import numpy as np

from pathtracer.sampling import rng


def _ids(n, start=0):
    return np.arange(start, start + n, dtype=np.uint32)


def test_deterministic():
    a = np.asarray(rng.bounce_uniforms(7, 0, 1, _ids(64)))
    b = np.asarray(rng.bounce_uniforms(7, 0, 1, _ids(64)))
    np.testing.assert_array_equal(a, b)


def test_keyed_by_absolute_pixel_id():
    # A tile's draws equal the corresponding rows of the full-image draws:
    # this is the property that makes sharded == single-device renders.
    full = np.asarray(rng.bounce_uniforms(3, 1, 2, _ids(256)))
    tile = np.asarray(rng.bounce_uniforms(3, 1, 2, _ids(64, start=128)))
    np.testing.assert_array_equal(full[128:192], tile)
    jf = np.asarray(rng.pixel_jitter(3, 1, _ids(256)))
    jt = np.asarray(rng.pixel_jitter(3, 1, _ids(64, start=128)))
    np.testing.assert_array_equal(jf[128:192], jt)


def test_streams_distinct():
    base = np.asarray(rng.bounce_uniforms(0, 0, 0, _ids(256)))
    for seed, spp, bounce in [(1, 0, 0), (0, 1, 0), (0, 0, 1)]:
        other = np.asarray(rng.bounce_uniforms(seed, spp, bounce, _ids(256)))
        assert np.abs(base - other).max() > 1e-3


def test_jitter_stream_distinct_from_bounces():
    jit = np.asarray(rng.pixel_jitter(0, 0, _ids(256)))
    for bounce in range(8):
        b = np.asarray(rng.bounce_uniforms(0, 0, bounce, _ids(256)))
        assert np.abs(jit - b[:, :2]).max() > 1e-3


def test_uniform_distribution():
    u = np.asarray(rng.bounce_uniforms(0, 0, 0, _ids(4096))).ravel()
    assert 0.0 <= u.min() and u.max() < 1.0
    np.testing.assert_allclose(u.mean(), 0.5, atol=0.01)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, atol=0.005)
    c = np.corrcoef(u[:-1], u[1:])[0, 1]
    assert abs(c) < 0.05


def test_draw_layout_stable():
    # The slot layout is part of the oracle/engine contract; freezing it here
    # turns silent renumbering into a test failure.
    assert (
        rng.LIGHT_SEL,
        rng.LIGHT_U1,
        rng.LIGHT_U2,
        rng.BSDF_U1,
        rng.BSDF_U2,
        rng.RR_U,
        rng.FRESNEL_U,
    ) == (0, 1, 2, 3, 4, 5, 6)
    assert rng.N_DRAWS == 7
