"""Distributed tests on 8 virtual CPU devices (SURVEY.md §4.5):
sharded render == single-device render bit-for-bit; psum'ed sharded grads
== single-device grads."""

import jax
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.engine import wavefront
from pathtracer.parallel import mesh as pmesh
from pathtracer.scene import builder


@pytest.fixture(scope="module")
def scene():
    return builder.cornell_spheres()


def _cfg(**kw):
    base = dict(
        width=32, height=32, spp=2, max_depth=2, scene="cornell_spheres",
        use_bvh=False,
    )
    base.update(kw)
    return RenderConfig(**base)


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8, (
        "conftest.py must provide 8 virtual CPU devices"
    )


def test_sharded_render_equals_single(scene):
    cfg = _cfg()
    single = np.asarray(wavefront.render(scene, cfg))
    m = pmesh.make_mesh(8)
    sharded = np.asarray(pmesh.render_sharded(scene, cfg, m))
    np.testing.assert_array_equal(sharded, single)


def test_sharded_render_odd_pixel_count(scene):
    # 30*18 = 540 pixels, not divisible by 8 → exercises padding. Different
    # per-shard shapes let XLA fuse/contract FMAs differently, so this case
    # is 1-ulp-tolerant rather than bit-exact (the aligned case above IS
    # bit-exact).
    cfg = _cfg(width=30, height=18)
    single = np.asarray(wavefront.render(scene, cfg))
    sharded = np.asarray(pmesh.render_sharded(scene, cfg, pmesh.make_mesh(8)))
    np.testing.assert_allclose(sharded, single, atol=1e-6, rtol=1e-5)


def test_sharded_grads_match_single_device(scene):
    cfg = _cfg(spp=1)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)

    loss8, grads8 = pmesh.loss_and_grad_sharded(
        scene, cfg, scene.materials, target, pmesh.make_mesh(8)
    )
    loss1, grads1 = pmesh.loss_and_grad_sharded(
        scene, cfg, scene.materials, target, pmesh.make_mesh(1)
    )
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    for g8, g1 in zip(jax.tree.leaves(grads8), jax.tree.leaves(grads1)):
        np.testing.assert_allclose(
            np.asarray(g8), np.asarray(g1), rtol=1e-4, atol=1e-7
        )
    # Gradients are nonzero for materials visible in frame.
    assert float(jnp_abs_sum(grads8.albedo)) > 0


def jnp_abs_sum(x):
    return np.abs(np.asarray(x)).sum()


def test_grads_finite_and_emission_grad_nonzero(scene):
    cfg = _cfg(spp=1, max_depth=1)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    _, grads = pmesh.loss_and_grad_sharded(
        scene, cfg, scene.materials, target, pmesh.make_mesh(4)
    )
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()
    assert jnp_abs_sum(grads.emission) > 0


@pytest.fixture(scope="module")
def mesh_scene():
    from pathtracer.accel.build import with_bvh
    from pathtracer.accel.clusters import with_clusters

    return with_clusters(with_bvh(builder.cornell_mesh()))


def test_sharded_bvh_backend_equals_single(mesh_scene):
    """BVH-walk backend under shard_map — regression test for the
    while_loop carry varying-axes rule (an unvarying constant init is
    rejected once the body makes the carry varying; accel/traverse.py
    derives the init from the rays). The config-5 sharded large-scene
    path depends on this."""
    cfg = _cfg(scene="cornell_mesh", use_bvh=True, width=24, height=24,
               spp=1)
    single = np.asarray(wavefront.render(mesh_scene, cfg))
    sharded = np.asarray(
        pmesh.render_sharded(mesh_scene, cfg, pmesh.make_mesh())
    )
    np.testing.assert_array_equal(single, sharded)


def test_sharded_cluster_backend_equals_single(mesh_scene):
    """Cluster (Pallas, interpret on CPU) backend under shard_map."""
    cfg = _cfg(scene="cornell_mesh", use_bvh=True, backend="cluster",
               width=24, height=24, spp=1)
    single = np.asarray(wavefront.render(mesh_scene, cfg))
    sharded = np.asarray(
        pmesh.render_sharded(mesh_scene, cfg, pmesh.make_mesh())
    )
    np.testing.assert_array_equal(single, sharded)


@pytest.fixture(scope="module")
def walk_scene():
    """cornell_mesh as accel/auto.py prepares a large scene: BVH only."""
    from pathtracer.accel.build import with_bvh

    return with_bvh(builder.cornell_mesh())


def test_sharded_config5_route_equals_single(walk_scene):
    """Config 5 as DEFINED (backend="cluster", spp_chunk=1, compaction
    off), cut to 24x24: a scene without cluster tables routes to the BVH
    walk, which runs inside the manual sharding region bit-exact vs
    single device."""
    from pathtracer.config import PRESETS

    cfg = PRESETS["config5"].replace(scene="cornell_mesh", width=24,
                                     height=24, max_depth=3)
    assert wavefront._intersector(walk_scene.geometry, cfg).impl == "bvh"
    single = np.asarray(wavefront.render(walk_scene, cfg))
    sharded = np.asarray(
        pmesh.render_sharded(walk_scene, cfg, pmesh.make_mesh())
    )
    np.testing.assert_array_equal(single, sharded)


def test_sharded_walk_backend_grads(walk_scene):
    """Backward through the BVH walk under shard_map: the walk's
    stop_gradient'ed hits + psum'ed material grads, sharded ==
    single-mesh, finite and nonzero."""
    cfg = _cfg(scene="cornell_mesh", use_bvh=True, width=16, height=16,
               spp=1)
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    loss8, grads8 = pmesh.loss_and_grad_sharded(
        walk_scene, cfg, walk_scene.materials, target, pmesh.make_mesh(8)
    )
    loss1, grads1 = pmesh.loss_and_grad_sharded(
        walk_scene, cfg, walk_scene.materials, target, pmesh.make_mesh(1)
    )
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    for g8, g1 in zip(jax.tree.leaves(grads8), jax.tree.leaves(grads1)):
        np.testing.assert_allclose(
            np.asarray(g8), np.asarray(g1), rtol=1e-4, atol=1e-7
        )
    assert jnp_abs_sum(grads8.albedo) > 0


def test_sharded_walk_deep_compact_equals_single(walk_scene):
    """Depth 5 with compaction ON: every bounce runs the packed-row
    compaction permutation and the BVH walk on the sorted rays inside
    the manual sharding region. Bit-exact vs single device."""
    cfg = _cfg(scene="cornell_mesh", use_bvh=True, width=16, height=16,
               spp=1, max_depth=5, compact=True)
    single = np.asarray(wavefront.render(walk_scene, cfg))
    sharded = np.asarray(
        pmesh.render_sharded(walk_scene, cfg, pmesh.make_mesh())
    )
    np.testing.assert_array_equal(single, sharded)
