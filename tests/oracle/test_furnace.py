"""Furnace tests (SURVEY.md §4.4): a uniform emissive environment must
produce a constant image — the classic unbiasedness check for the cosine
BRDF/pdf normalization and for Russian roulette.

Scene: a single diffuse sphere floating in a uniform background of
radiance 1. The sphere is convex, so any cosine-sampled bounce direction
escapes immediately; with albedo a, every camera ray therefore returns
exactly a*bg (sphere pixels) or bg (miss pixels) at depth >= 2 — a
*deterministic* identity, so sphere-pixel error must be at fp32 level.
With Russian roulette enabled from bounce 0 the per-sample value becomes
random, but its expectation is unchanged; the multi-spp mean must converge
to the same identity (statistical tolerance).
"""

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.engine import wavefront
from pathtracer.oracle import tracer as oracle
from pathtracer.scene import builder, model


def _furnace_scene(albedo: float):
    geom = model.make_geometry(
        tri_verts=np.zeros((0, 3, 3), np.float32),
        tri_mat=np.zeros((0,), np.int32),
        sph_c=np.array([[0.0, 0.0, 2.5]], np.float32),
        sph_r=np.array([1.0], np.float32),
        sph_mat=np.array([0], np.int32),
    )
    mats = model.Materials(
        albedo=np.full((1, 3), albedo, np.float32),
        emission=np.zeros((1, 3), np.float32),
    )
    cam = builder.default_camera()
    lights = model.make_lights(geom, mats, background=(1.0, 1.0, 1.0))
    return model.Scene(geometry=geom, materials=mats, camera=cam,
                       lights=lights)


@pytest.mark.parametrize("albedo", [1.0, 0.5])
def test_furnace_deterministic(albedo):
    """Depth-2, no RR: image == albedo*bg on the sphere, bg elsewhere."""
    scene = _furnace_scene(albedo)
    cfg = RenderConfig(width=32, height=32, spp=1, max_depth=2,
                       rr_start=8, scene="furnace", use_bvh=False)
    img = np.asarray(wavefront.render(scene, cfg))
    ref = oracle.render(scene, cfg)
    np.testing.assert_allclose(img, ref, atol=1e-5)
    # Every pixel is either a miss (== 1) or a sphere hit (== albedo).
    flat = img.reshape(-1, 3)
    is_bg = np.all(np.abs(flat - 1.0) < 1e-5, axis=-1)
    is_srf = np.all(np.abs(flat - albedo) < 1e-5, axis=-1)
    assert np.all(is_bg | is_srf)
    assert is_srf.any() and is_bg.any()


def test_furnace_russian_roulette_unbiased():
    """RR from bounce 0 keeps the furnace expectation.

    The no-RR render is the exact per-sample conditional expectation of
    the RR render (both consume identical jitter streams, and RR only
    randomizes termination with the compensating 1/pcont weight), so the
    two image means must agree within Monte-Carlo noise of the RR
    Bernoulli: std(mean) ~ 0.5/sqrt(n_samples) << 0.01."""
    albedo = 0.5
    scene = _furnace_scene(albedo)
    cfg = RenderConfig(width=16, height=16, spp=256, max_depth=3,
                       rr_start=0, scene="furnace", use_bvh=False)
    img_rr = np.asarray(wavefront.render(scene, cfg))
    img_ex = np.asarray(wavefront.render(scene, cfg.replace(rr_start=8)))
    assert abs(img_rr.mean() - img_ex.mean()) < 0.01
