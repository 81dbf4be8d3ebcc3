"""Scene-size backend routing (accel/auto.py:dense_route).

backend="cluster" on a scene above the dense route's cluster limit must
land on the BVH walk. Most cases simulate the boundary by shrinking the
limit — the routing logic is what's under test, not a 2M-triangle build;
test_measured_scenes_route_as_measured builds the mid-size scenes the
limit was timed on.
"""

import numpy as np
import pytest

from pathtracer.accel.auto import prepare_accel
from pathtracer.accel.build import with_bvh
from pathtracer.config import PRESETS, RenderConfig
from pathtracer.engine import wavefront
from pathtracer.scene import builder


def _cfg(**kw):
    base = dict(width=16, height=16, spp=1, max_depth=2,
                scene="cornell_mesh", use_bvh=True, backend="cluster")
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def mesh_scene():
    return with_bvh(builder.cornell_mesh())


def test_small_scene_stays_on_cluster(mesh_scene):
    cfg = _cfg()
    scene = prepare_accel(mesh_scene, cfg)
    assert scene.geometry.cl_lo.shape[0] > 0
    hit = wavefront._intersector(scene.geometry, cfg)
    assert hit.impl == "cluster"


def test_overflow_scene_routes_to_walk(mesh_scene, monkeypatch):
    from pathtracer.accel import auto

    # Simulate a scene above the limit: every cluster count overflows.
    monkeypatch.setattr(auto, "DENSE_MAX_CLUSTERS", 0)
    cfg = _cfg()
    scene = prepare_accel(mesh_scene, cfg)
    # prepare_accel built no cluster tables for the default backend...
    assert scene.geometry.cl_lo.shape[0] == 0
    # ...and the engine routes the cluster backend onto the BVH walk.
    hit = wavefront._intersector(scene.geometry, cfg)
    assert hit.impl == "bvh"


def test_large_estimate_skips_cluster_build(mesh_scene, monkeypatch):
    """ceil(T/128) above the limit decides without building clusters."""
    from pathtracer.accel import auto, clusters

    monkeypatch.setattr(auto, "DENSE_MAX_CLUSTERS", 1)

    def no_build(scene):
        raise AssertionError("cluster tables built for a large scene")

    monkeypatch.setattr(clusters, "with_clusters", no_build)
    scene = prepare_accel(mesh_scene, _cfg())
    assert scene.geometry.cl_lo.shape[0] == 0


def test_overflow_tables_with_bvh_take_walk(mesh_scene, monkeypatch):
    """Cluster tables above the limit (caller built them directly) do
    not pull a scene with a BVH off the walk."""
    from pathtracer.accel import auto
    from pathtracer.accel.clusters import with_clusters

    scene = with_clusters(mesh_scene)
    monkeypatch.setattr(auto, "DENSE_MAX_CLUSTERS", 0)
    hit = wavefront._intersector(scene.geometry, _cfg())
    assert hit.impl == "bvh"


def test_overflow_without_bvh_warns_and_keeps_cluster(mesh_scene,
                                                      monkeypatch):
    """Above the limit with no BVH to walk: warn, and keep the dense
    cluster kernel (exact at any size, only slower)."""
    from pathtracer.accel import auto
    from pathtracer.accel.clusters import with_clusters

    scene = with_clusters(mesh_scene)
    monkeypatch.setattr(auto, "DENSE_MAX_CLUSTERS", 0)
    cfg = _cfg(use_bvh=False)
    with pytest.warns(UserWarning, match="no BVH"):
        hit = wavefront._intersector(scene.geometry, cfg)
    assert hit.impl == "cluster"


def test_jnp_backend_ignores_cluster_tables(mesh_scene):
    from pathtracer.accel.clusters import with_clusters

    scene = with_clusters(mesh_scene)
    hit = wavefront._intersector(scene.geometry, _cfg(backend="jnp"))
    assert hit.impl == "bvh"


def test_routed_render_equals_explicit_walk(mesh_scene, monkeypatch):
    """The auto-routed render is the BVH-walk render, bit for bit."""
    from pathtracer.accel import auto

    explicit = np.asarray(
        wavefront.render(mesh_scene, _cfg(backend="jnp"))
    )
    monkeypatch.setattr(auto, "DENSE_MAX_CLUSTERS", 0)
    routed_scene = prepare_accel(mesh_scene, _cfg())
    routed = np.asarray(wavefront.render(routed_scene, _cfg()))
    np.testing.assert_array_equal(routed, explicit)


@pytest.mark.parametrize("n_target,impl", [
    (25_600, "cluster"), (102_400, "bvh"),
])
def test_measured_scenes_route_as_measured(n_target, impl):
    """big_mesh cut to 256 clusters (dense measured 4.5x faster than the
    walk) stays dense; at 1,024 clusters (1.9x slower) it walks."""
    cfg = PRESETS["config5"]
    scene = with_bvh(builder.big_mesh(n_target=n_target))
    scene = prepare_accel(scene, cfg)
    assert wavefront._intersector(scene.geometry, cfg).impl == impl


@pytest.mark.parametrize("n_clusters,dense", [
    (1, True), (64, True), (256, True), (512, True), (513, False),
    (1024, False), (16340, False),
])
def test_dense_route_rule(n_clusters, dense):
    """The scene-size rule: up to 512 clusters (cornell_mesh has 64) take
    the dense kernel, larger tables (big_mesh: ~16k) the BVH walk."""
    from pathtracer.accel.auto import DENSE_MAX_CLUSTERS, dense_route

    assert DENSE_MAX_CLUSTERS == 512
    assert dense_route(n_clusters) is dense
