"""Engine-vs-oracle allclose tests (SURVEY.md §4.2) — the core acceptance
criterion: at fixed seeds, the jit-compiled wavefront engine must
reproduce the numpy oracle pixel-for-pixel (fp32 tolerances)."""

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.engine import wavefront
from pathtracer.engine.camera import camera_rays as jnp_camera_rays
from pathtracer.engine.shading import cosine_hemisphere as jnp_cosine
from pathtracer.oracle import tracer as oracle
from pathtracer.scene import builder


@pytest.fixture(scope="module")
def scene():
    return builder.cornell_spheres()


def _cfg(**kw):
    base = dict(
        width=64, height=64, spp=1, max_depth=1, scene="cornell_spheres",
        use_bvh=False,
    )
    base.update(kw)
    return RenderConfig(**base)


def test_camera_rays_match(scene):
    n = 64 * 64
    jitter = np.asarray(
        __import__("pathtracer.sampling.rng", fromlist=["rng"]).pixel_jitter(
            0, 0, np.arange(n, dtype=np.uint32)
        )
    )
    o_np, d_np = oracle.camera_rays(scene.camera, 64, 64, jitter)
    o_j, d_j = jnp_camera_rays(
        scene.camera, 64, 64, jitter, np.arange(n, dtype=np.int32)
    )
    np.testing.assert_allclose(np.asarray(o_j), o_np, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d_j), d_np, atol=1e-6)


def test_cosine_hemisphere_matches():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u1 = rng.random(512).astype(np.float32)
    u2 = rng.random(512).astype(np.float32)
    d_np = oracle.cosine_hemisphere(n, u1, u2)
    d_j = np.asarray(jnp_cosine(n, u1, u2))
    np.testing.assert_allclose(d_j, d_np, atol=2e-6)
    # All directions in the upper hemisphere around n.
    assert ((d_np * n).sum(-1) >= -1e-6).all()


def test_config1_image_allclose(scene):
    """Driver config 1 (BASELINE.json:7): jnp engine == oracle."""
    cfg = _cfg()
    img_o = oracle.render(scene, cfg)
    img_j = np.asarray(wavefront.render(scene, cfg))
    np.testing.assert_allclose(img_j, img_o, atol=5e-4, rtol=1e-3)


def test_multibounce_rr_allclose(scene):
    cfg = _cfg(width=32, height=32, spp=2, max_depth=4, rr_start=1)
    img_o = oracle.render(scene, cfg)
    img_j = np.asarray(wavefront.render(scene, cfg))
    np.testing.assert_allclose(img_j, img_o, atol=1e-3, rtol=1e-3)


def test_spp_chunking_exact(scene):
    """Chunked accumulation must equal the all-at-once render exactly
    (samples keyed by spp index, SURVEY.md §5.7)."""
    cfg = _cfg(width=32, height=32, spp=4)
    full = np.asarray(wavefront.render(scene, cfg))
    chunked = np.asarray(wavefront.render(scene, cfg.replace(spp_chunk=1)))
    # Chunked and fori-loop accumulation sum in the same order; remaining
    # differences are XLA FMA-fusion ulps between the two programs.
    np.testing.assert_allclose(chunked, full, atol=1e-5)


def test_resume_matches_fresh(scene):
    """A render resumed from a checkpointed accumulator equals the
    uninterrupted render (deterministic spp streams)."""
    cfg = _cfg(width=16, height=16, spp=4)
    acc01 = np.asarray(
        wavefront.render_accumulate(scene, cfg, spp_start=0, n_spp=2)
    )
    acc23 = np.asarray(
        wavefront.render_accumulate(scene, cfg, spp_start=2, n_spp=2)
    )
    full = np.asarray(wavefront.render(scene, cfg)).reshape(-1, 3)
    np.testing.assert_allclose((acc01 + acc23) / 4.0, full, atol=1e-5)


def test_config2_mesh_bvh_allclose():
    """Driver config 2 (BASELINE.json:8): mesh Cornell + flat BVH traversal,
    direct lighting — engine(BVH) == oracle(brute force)."""
    from pathtracer.accel.build import with_bvh

    scene = with_bvh(builder.cornell_mesh())
    cfg = RenderConfig(
        width=48, height=48, spp=1, max_depth=1, scene="cornell_mesh",
        use_bvh=True,
    )
    img_o = oracle.render(scene, cfg)
    img_j = np.asarray(wavefront.render(scene, cfg))
    np.testing.assert_allclose(img_j, img_o, atol=5e-4, rtol=1e-3)


def test_config3_gi_allclose():
    """Driver config 3 (BASELINE.json:9): 4-bounce GI + NEE + RR — scaled
    down to 24x24/2spp for CI; the estimator is identical at any size."""
    from pathtracer.accel.build import with_bvh

    scene = with_bvh(builder.cornell_mesh())
    cfg = RenderConfig(
        width=24, height=24, spp=2, max_depth=4, rr_start=2,
        scene="cornell_mesh", use_bvh=True,
    )
    img_o = oracle.render(scene, cfg)
    img_j = np.asarray(wavefront.render(scene, cfg))
    np.testing.assert_allclose(img_j, img_o, atol=1e-3, rtol=2e-3)


def test_specular_materials_allclose():
    """Mirror + glass spheres (MAT_SPEC/MAT_REFR): full delta-lobe path —
    Fresnel select, TIR, spec_chain emission rule — engine == oracle."""
    scene = builder.cornell_specular()
    cfg = RenderConfig(
        width=24, height=24, spp=2, max_depth=5, rr_start=2,
        scene="cornell_specular", use_bvh=False,
    )
    img_o = oracle.render(scene, cfg)
    img_j = np.asarray(wavefront.render(scene, cfg))
    np.testing.assert_allclose(img_j, img_o, atol=1e-3, rtol=2e-3)


def test_compaction_exact_equality(scene):
    """Stream compaction (coherence sort) must not change a single bit:
    draws are keyed by pixel id and the final unscramble is an exact
    permutation."""
    cfg = _cfg(width=32, height=32, spp=2, max_depth=4, rr_start=1)
    plain = np.asarray(wavefront.render(scene, cfg))
    compact = np.asarray(wavefront.render(scene, cfg.replace(compact=True)))
    np.testing.assert_array_equal(compact, plain)


def test_compaction_with_bvh_mesh():
    from pathtracer.accel.build import with_bvh

    mesh = with_bvh(builder.cornell_mesh(mesh_tris=builder.procedural_bunny(2)))
    cfg = RenderConfig(
        width=24, height=24, spp=1, max_depth=3, rr_start=1,
        scene="cornell_mesh", use_bvh=True, compact=True,
    )
    a = np.asarray(wavefront.render(mesh, cfg))
    b = np.asarray(wavefront.render(mesh, cfg.replace(compact=False)))
    np.testing.assert_array_equal(a, b)
