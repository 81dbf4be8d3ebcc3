"""Super-cluster per-ray line cull tests (accel/clusters.py:build_supers
+ ops/intersect_cluster.py:ray_super_mask), Pallas interpret mode on CPU.

The mask is the large-scene fix for block-level candidate collapse:
block-interval culls keep the block's CONE; the per-ray super slab test
keeps only the union of its rays' LINES at ~32-cluster granularity.
Contract: purely subtractive and SOUND — adding it must never change any
closest-hit result, for any super granularity, with or without per-ray
t_max bounds. The soup scenes here are small enough for the exact
per-cluster line mask, so the tests lower RAY_CULL_MAX_C to make the
dense kernel take the super mask instead.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer import constants as C
from pathtracer.accel.clusters import (
    build_clusters,
    build_supers,
    with_clusters,
)
from pathtracer.engine import intersect as isect
from pathtracer.ops import intersect_cluster
from pathtracer.ops.intersect_cluster import (
    closest_hit_cluster,
    ray_super_mask,
)
from pathtracer.scene import builder
from pathtracer.scene.model import make_geometry, make_lights, Scene
from pathtracer.scene.model import Materials


def _soup_scene(n_tris=900, seed=3, spread=4.0, tri_size=0.25):
    """Random triangle soup spread over a wide box: many clusters."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n_tris, 1, 3)) - 0.5) * spread
    verts = base + rng.normal(size=(n_tris, 3, 3)) * tri_size
    geom = make_geometry(verts.astype(np.float32),
                         np.zeros((n_tris,), np.int32))
    mats = Materials(albedo=np.full((1, 3), 0.5, np.float32),
                     emission=np.zeros((1, 3), np.float32))
    cam = builder.cornell_mesh().camera
    return Scene(geometry=geom, materials=mats, camera=cam,
                 lights=make_lights(geom, mats))


def _random_rays(n, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) - 0.5) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_build_supers_invariants():
    scene = _soup_scene()
    g = scene.geometry
    cs = build_clusters(np.asarray(g.tri_v0), np.asarray(g.tri_e1),
                        np.asarray(g.tri_e2), max_tris=16)
    assert len(cs.lo) >= 16, "want a many-cluster scene"
    su_lo, su_hi, cl_super = build_supers(cs.lo, cs.hi, group=4)
    S = len(su_lo)
    assert S >= 4
    assert cl_super.shape == (len(cs.lo),)
    assert cl_super.min() >= 0 and cl_super.max() == S - 1
    # Every super box strictly contains its member cluster boxes
    # (inflated, so containment is strict — rounding-safe).
    for s in range(S):
        m = cl_super == s
        assert m.any()
        assert (su_lo[s] < cs.lo[m].min(0) + 1e-12).all()
        assert (su_hi[s] > cs.hi[m].max(0) - 1e-12).all()


@pytest.fixture
def super_cull(monkeypatch):
    """Route the dense kernel's per-ray cull through the super mask."""
    monkeypatch.setattr(intersect_cluster, "RAY_CULL_MAX_C", 0)


@pytest.mark.parametrize("group", [2, 4, 16])
def test_super_mask_never_changes_results(group, super_cull):
    """closest-hit with the super mask (any granularity) == without."""
    scene = with_clusters(_soup_scene(), max_tris=16, super_group=group)
    g = scene.geometry
    assert g.su_lo.shape[0] > 1
    g_nosuper = dataclasses.replace(
        g, su_lo=np.zeros((0, 3), np.float32),
        su_hi=np.zeros((0, 3), np.float32),
        cl_super=np.zeros((0,), np.int32),
    )
    o, d = _random_rays(1024, seed=group)
    t_a, n_a, m_a = closest_hit_cluster(g, o, d, interpret=True)
    t_b, n_b, m_b = closest_hit_cluster(g_nosuper, o, d, interpret=True)
    np.testing.assert_array_equal(np.asarray(t_a), np.asarray(t_b))
    np.testing.assert_array_equal(np.asarray(m_a), np.asarray(m_b))
    np.testing.assert_array_equal(np.asarray(n_a), np.asarray(n_b))


def test_super_mask_with_shadow_tmax(super_cull):
    """Per-ray t_max interacts with the per-ray super crossing test:
    hits strictly nearer than t_max must all survive."""
    scene = with_clusters(_soup_scene(seed=8), max_tris=16, super_group=4)
    g = scene.geometry
    o, d = _random_rays(768, seed=21)
    t_ref, _, _ = isect.brute(g, o, d)
    t_ref = np.asarray(t_ref)
    rng = np.random.default_rng(5)
    t_max = np.where(
        rng.random(len(o)) < 0.5,
        t_ref * (1.0 + rng.random(len(o))),  # bound beyond the hit
        np.float32(C.T_FAR),
    ).astype(np.float32)
    t_s, _, _ = closest_hit_cluster(g, o, d, interpret=True, t_max=t_max)
    t_s = np.asarray(t_s)
    hit = t_ref < C.T_FAR * 0.5
    near = hit & (t_ref < t_max * 0.999)
    np.testing.assert_allclose(t_s[near], t_ref[near], rtol=1e-4,
                               atol=1e-5)


def test_stream_matches_brute_many_supers(super_cull):
    """End-to-end: the dense kernel under the super mask on a many-super
    scene equals brute force."""
    scene = with_clusters(_soup_scene(n_tris=1200, seed=12), max_tris=16,
                          super_group=4)
    g = scene.geometry
    o, d = _random_rays(1024, seed=2)
    t_b, _, m_b = isect.brute(g, o, d)
    t_s, _, m_s = closest_hit_cluster(g, o, d, interpret=True)
    t_b, t_s = np.asarray(t_b), np.asarray(t_s)
    hit_b = t_b < C.T_FAR * 0.5
    hit_s = t_s < C.T_FAR * 0.5
    np.testing.assert_array_equal(hit_b, hit_s)
    np.testing.assert_allclose(t_s[hit_b], t_b[hit_b], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_s)[hit_b],
                                  np.asarray(m_b)[hit_b])


def test_ray_super_mask_is_union_of_lines():
    """Directly: a cluster is kept iff >= 1 ray in the block crosses its
    super box — verified against a scalar numpy reference."""
    scene = with_clusters(_soup_scene(n_tris=400, seed=4), max_tris=16,
                          super_group=4)
    g = scene.geometry
    o, d = _random_rays(64, seed=9)
    t_max = np.full((64,), 3.0, np.float32)
    mask = np.asarray(ray_super_mask(
        jnp.asarray(g.su_lo), jnp.asarray(g.su_hi),
        jnp.asarray(g.cl_super), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), block=64,
    ))[0]
    su_lo, su_hi = np.asarray(g.su_lo), np.asarray(g.su_hi)
    crossed = np.zeros((len(su_lo),), bool)
    for s in range(len(su_lo)):
        for r in range(64):
            dd = np.where(np.abs(d[r]) < 1e-20,
                          np.where(d[r] < 0, -1e-20, 1e-20), d[r])
            t0 = (su_lo[s] - o[r]) / dd
            t1 = (su_hi[s] - o[r]) / dd
            t_in = np.minimum(t0, t1).max()
            t_out = np.maximum(t0, t1).min()
            if t_out >= max(t_in, C.T_MIN) and t_in <= t_max[r]:
                crossed[s] = True
                break
    np.testing.assert_array_equal(mask, crossed[np.asarray(g.cl_super)])
