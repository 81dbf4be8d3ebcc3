"""MIS (power heuristic NEE<->BSDF) tests — oracle/engine lockstep,
unbiasedness, and the variance reduction that justifies it
(SURVEY.md §3.1 "+MIS/NEE bookkeeping").
"""

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.engine import wavefront
from pathtracer.oracle import tracer as oracle
from pathtracer.scene import builder


@pytest.fixture(scope="module")
def biglight():
    return builder.cornell_biglight()


def test_engine_matches_oracle_with_mis(biglight):
    """Fixed seed: jnp engine == numpy oracle with cfg.mis on."""
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=3,
                       rr_start=99, scene="cornell_biglight",
                       use_bvh=False, mis=True)
    img_o = oracle.render(biglight, cfg)
    img_e = np.asarray(wavefront.render(biglight, cfg))
    np.testing.assert_allclose(img_e, img_o, rtol=1e-3, atol=5e-4)


def test_mis_unbiased(biglight):
    """MIS and the base estimator agree in expectation (same transport
    terms, weights summing to 1): means over many spp must match."""
    cfg = RenderConfig(width=24, height=24, spp=512, max_depth=3,
                       rr_start=99, scene="cornell_biglight",
                       use_bvh=False)
    img_base = np.asarray(wavefront.render(biglight, cfg))
    img_mis = np.asarray(wavefront.render(biglight, cfg.replace(mis=True)))
    # Mean radiance tight; per-pixel quantile-based (Monte Carlo noise at
    # 512 spp leaves a few spike-pixel outliers in the base estimator).
    assert abs(img_base.mean() - img_mis.mean()) < 0.01 * img_base.mean()
    dev = np.abs(img_mis - img_base) / (np.abs(img_base) + 0.05)
    assert (dev < 0.25).mean() > 0.99, (dev.max(), (dev >= 0.25).sum())


def test_mis_reduces_variance(biglight):
    """On the big-light scene MIS must cut pixel variance at equal spp."""
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=3,
                       rr_start=99, scene="cornell_biglight",
                       use_bvh=False)
    K = 48
    base = np.stack([
        np.asarray(wavefront.render_accumulate(
            biglight, cfg, spp_start=s, n_spp=1))
        for s in range(K)
    ])
    mis = np.stack([
        np.asarray(wavefront.render_accumulate(
            biglight, cfg.replace(mis=True), spp_start=s, n_spp=1))
        for s in range(K)
    ])
    var_base = base.var(axis=0).mean()
    var_mis = mis.var(axis=0).mean()
    assert var_mis < 0.75 * var_base, (var_mis, var_base)


def test_mis_noop_without_lights():
    """Scene with no emissive triangles: mis flag must not change images."""
    scene = builder.cornell_spheres(background=(1.0, 1.0, 1.0))
    import dataclasses

    mats = dataclasses.replace(
        scene.materials,
        emission=np.zeros_like(np.asarray(scene.materials.emission)),
    )
    from pathtracer.scene.model import make_lights

    scene = dataclasses.replace(
        scene, materials=mats,
        lights=make_lights(scene.geometry, mats, (1.0, 1.0, 1.0)),
    )
    cfg = RenderConfig(width=24, height=24, spp=2, max_depth=2,
                       use_bvh=False)
    a = np.asarray(wavefront.render(scene, cfg))
    b = np.asarray(wavefront.render(scene, cfg.replace(mis=True)))
    np.testing.assert_array_equal(a, b)
