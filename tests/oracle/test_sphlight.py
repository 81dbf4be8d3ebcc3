"""Sphere-light NEE tests.

Emissive analytic spheres are first-class NEE lights: uniform-by-area
surface sampling over 4*pi*r^2, mixed into the same area-measure cdf as
triangle lights. These tests pin (1) engine/oracle lockstep on a
mixed-light scene, (2) estimator consistency between the sphere light
and an equivalent finely-triangulated sphere, (3) MIS agreement with
the base estimator (both unbiased) — which exercises the sphere pdf in
BOTH directions of the power heuristic, and (4) gradients flowing
through the sphere light's emission.
"""

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.engine import wavefront
from pathtracer.oracle import tracer as oracle
from pathtracer.scene import builder
from pathtracer.scene.model import (
    Materials,
    Scene,
    make_geometry,
    make_lights,
)


@pytest.fixture(scope="module")
def sphlight():
    return builder.cornell_sphlight()


def test_engine_matches_oracle_sphere_lights(sphlight):
    """Fixed seed, mixed tri+sphere light table: engine == oracle."""
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=3,
                       rr_start=99, scene="cornell_sphlight",
                       use_bvh=False)
    img_o = oracle.render(sphlight, cfg)
    img_e = np.asarray(wavefront.render(sphlight, cfg))
    np.testing.assert_allclose(img_e, img_o, rtol=1e-3, atol=5e-4)


def test_engine_matches_oracle_sphere_lights_mis(sphlight):
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=3,
                       rr_start=99, scene="cornell_sphlight",
                       use_bvh=False, mis=True)
    img_o = oracle.render(sphlight, cfg)
    img_e = np.asarray(wavefront.render(sphlight, cfg))
    np.testing.assert_allclose(img_e, img_o, rtol=1e-3, atol=5e-4)


def _box_with_light(sph: bool) -> Scene:
    """Cornell walls (no quad light) lit ONLY by a sphere — analytic
    (sph=True) or a subdiv-3 triangulated icosphere of the same center,
    radius, and radiance (sph=False)."""
    c = np.array([0.5, 0.72, 0.5], np.float32)
    r = np.float32(0.12)
    tris, mats = builder._cornell_walls()
    if sph:
        geom = make_geometry(
            tris, mats,
            sph_c=c[None, :], sph_r=np.array([r], np.float32),
            sph_mat=np.array([builder.SPHERE_B], np.int32),
        )
    else:
        ico = builder._icosphere(3).astype(np.float32) * r + c
        all_tris = np.concatenate([tris, ico])
        all_mats = np.concatenate([
            mats, np.full(len(ico), builder.SPHERE_B, np.int32)])
        geom = make_geometry(all_tris, all_mats)
    base = builder.default_materials()
    emission = np.asarray(base.emission).copy()
    emission[builder.LIGHT] = 0.0  # quad light off
    emission[builder.SPHERE_B] = [10.0, 10.0, 10.0]
    materials = Materials(albedo=base.albedo, emission=emission)
    return Scene(
        geometry=geom,
        materials=materials,
        camera=builder.default_camera(),
        lights=make_lights(geom, materials),
    )


def test_sphere_light_consistent_with_triangulated():
    """The analytic sphere light and a triangulated sphere of the same
    radius/radiance must produce the same illumination (the icosphere is
    inscribed, so its area — and total power — is ~2% lower at subdiv 3;
    5% tolerance covers that plus Monte Carlo noise)."""
    cfg = RenderConfig(width=32, height=32, spp=48, max_depth=2,
                       rr_start=99, scene="cornell_spheres",
                       use_bvh=False)
    img_s = np.asarray(wavefront.render(_box_with_light(True), cfg))
    img_t = np.asarray(wavefront.render(_box_with_light(False), cfg))
    m_s, m_t = float(img_s.mean()), float(img_t.mean())
    assert abs(m_s - m_t) < 0.05 * max(m_s, m_t), (m_s, m_t)


def test_sphere_light_mis_unbiased(sphlight):
    """Base estimator (NEE covers diffuse-reached sphere emission) and
    MIS (splits it between NEE and BSDF hits by the area-measure power
    heuristic) must agree in expectation — this breaks if either the
    sphere NEE pdf or the BSDF-hit counterweight is wrong."""
    cfg = RenderConfig(width=24, height=24, spp=384, max_depth=3,
                       rr_start=99, scene="cornell_sphlight",
                       use_bvh=False)
    img_base = np.asarray(wavefront.render(sphlight, cfg))
    img_mis = np.asarray(wavefront.render(sphlight, cfg.replace(mis=True)))
    assert abs(img_base.mean() - img_mis.mean()) < 0.015 * img_base.mean()


def test_sphere_light_emission_grads(sphlight):
    """d(image)/d(emission) through the sphere light's NEE contribution:
    finite differences vs reverse mode on the mean-radiance probe."""
    import jax

    from pathtracer.diff.render import render_image

    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2,
                       rr_start=99, scene="cornell_sphlight",
                       use_bvh=False)

    def probe(mats):
        return render_image(sphlight, cfg, mats).mean()

    g = jax.grad(probe)(sphlight.materials)
    g_em = np.asarray(g.emission)
    assert np.isfinite(g_em).all()
    # The emissive sphere's material row must receive gradient.
    assert abs(g_em[builder.SPHERE_B]).sum() > 0
    eps = 5e-2
    mats = sphlight.materials
    em = np.asarray(mats.emission).copy()
    em_p = em.copy()
    em_p[builder.SPHERE_B, 0] += eps
    em_m = em.copy()
    em_m[builder.SPHERE_B, 0] -= eps
    f_p = float(probe(Materials(albedo=mats.albedo, emission=em_p)))
    f_m = float(probe(Materials(albedo=mats.albedo, emission=em_m)))
    fd = (f_p - f_m) / (2 * eps)
    np.testing.assert_allclose(g_em[builder.SPHERE_B, 0], fd,
                               rtol=2e-2, atol=1e-6)
