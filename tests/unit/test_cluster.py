"""Dense cluster intersector tests (accel/clusters.py +
ops/intersect_cluster.py), all in Pallas interpret mode on CPU.

The cluster kernel is the dense route's hit query; its contract is
equality with engine/intersect.py:brute up to f32 tolerance (same
predicate in multiply form — see module docstrings). Tie-broken *indices*
may differ, so assertions pin t/material/normal agreement.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer import constants as C
from pathtracer.accel.clusters import (
    CLUSTER_TRIS,
    build_clusters,
    check_cluster_invariants,
    with_clusters,
)
from pathtracer.engine import intersect as isect
from pathtracer.ops.intersect_cluster import (
    closest_hit_cluster,
    cull_mask,
)
from pathtracer.scene import builder


@pytest.fixture(scope="module")
def mesh_scene():
    return with_clusters(builder.cornell_mesh())


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_cluster_invariants(mesh_scene):
    g = mesh_scene.geometry
    cs = build_clusters(
        np.asarray(g.tri_v0), np.asarray(g.tri_e1), np.asarray(g.tri_e2)
    )
    check_cluster_invariants(cs, int(g.tri_v0.shape[0]))
    # Every cluster box contains all its triangles' vertices.
    v0 = np.asarray(g.tri_v0)
    p1 = v0 + np.asarray(g.tri_e1)
    p2 = v0 + np.asarray(g.tri_e2)
    for ci in range(len(cs.lo)):
        ids = cs.tri_map[ci * CLUSTER_TRIS: (ci + 1) * CLUSTER_TRIS]
        ids = ids[ids >= 0]
        pts = np.concatenate([v0[ids], p1[ids], p2[ids]])
        assert (pts >= cs.lo[ci] - 1e-6).all()
        assert (pts <= cs.hi[ci] + 1e-6).all()


def test_cluster_matches_brute(mesh_scene):
    g = mesh_scene.geometry
    o, d = _random_rays(1500)
    t_b, n_b, m_b = isect.brute(g, o, d)
    t_c, n_c, m_c = closest_hit_cluster(g, o, d, interpret=True)
    t_b, t_c = np.asarray(t_b), np.asarray(t_c)
    hit_b = t_b < C.T_FAR * 0.5
    hit_c = t_c < C.T_FAR * 0.5
    np.testing.assert_array_equal(hit_b, hit_c)
    # f32 multiply-add dots in another association than brute's cross
    # products: grazing hits amplify the rounding, so the tail tolerance
    # is looser than the bulk (scene scale is ~1, RAY_OFFSET is 1e-3).
    err = np.abs(t_c[hit_b] - t_b[hit_b])
    assert np.quantile(err, 0.99) < 2e-6, np.quantile(err, 0.99)
    np.testing.assert_allclose(t_c[hit_b], t_b[hit_b], rtol=1e-4,
                               atol=1e-5)
    assert (np.asarray(m_b) == np.asarray(m_c)).mean() > 0.999
    close_n = np.abs(np.asarray(n_b) - np.asarray(n_c)).max(-1) < 1e-4
    assert close_n[hit_b].mean() > 0.999


def test_cull_is_conservative(mesh_scene):
    """Disabling the cull must not change any result (the mask is a pure
    performance filter: a cluster box contains its triangles)."""
    g = mesh_scene.geometry
    o, d = _random_rays(1024, seed=3)
    t_a, _, m_a = closest_hit_cluster(g, o, d, interpret=True,
                                      use_cull=True)
    t_b, _, m_b = closest_hit_cluster(g, o, d, interpret=True,
                                      use_cull=False)
    np.testing.assert_array_equal(np.asarray(t_a), np.asarray(t_b))
    np.testing.assert_array_equal(np.asarray(m_a), np.asarray(m_b))


def test_cull_mask_keeps_actual_hits(mesh_scene):
    """Every (block, cluster) pair where some ray actually hits a triangle
    of that cluster must be mask=1 (per-ray check via brute per cluster)."""
    g = mesh_scene.geometry
    o, d = _random_rays(512, seed=5)
    mask = np.asarray(
        cull_mask(jnp.asarray(g.cl_lo), jnp.asarray(g.cl_hi),
                  jnp.asarray(o), jnp.asarray(d), block=512)
    )
    assert mask.shape == (1, g.cl_lo.shape[0])
    # For every cluster, intersect rays against only that cluster's tris.
    cl_map = np.asarray(g.cl_map).reshape(-1, CLUSTER_TRIS)
    v0 = np.asarray(g.tri_v0)
    for ci in range(cl_map.shape[0]):
        if mask[0, ci]:
            continue
        ids = cl_map[ci][cl_map[ci] >= 0]
        sub = type(g)(
            **{
                **{f: getattr(g, f) for f in (
                    "sph_c", "sph_r", "sph_mat", "bvh_lo", "bvh_hi",
                    "bvh_first", "bvh_count", "bvh_skip", "mat_type",
                    "mat_ior", "cl_lo", "cl_hi", "cl_feat", "cl_map")},
                "tri_v0": v0[ids],
                "tri_e1": np.asarray(g.tri_e1)[ids],
                "tri_e2": np.asarray(g.tri_e2)[ids],
                "tri_n": np.asarray(g.tri_n)[ids],
                "tri_mat": np.asarray(g.tri_mat)[ids],
            }
        )
        t_sub, _, _ = isect.brute(sub, o, d)
        assert (np.asarray(t_sub) >= C.T_FAR * 0.5).all(), (
            f"cull dropped cluster {ci} that a ray hits"
        )


def test_cluster_in_engine_matches_jnp_backend(mesh_scene):
    """Full engine render with backend='cluster' == backend='jnp'."""
    from pathtracer.accel.build import with_bvh
    from pathtracer.config import RenderConfig
    from pathtracer.engine import wavefront

    scene = with_clusters(with_bvh(builder.cornell_mesh()))
    cfg = RenderConfig(width=64, height=64, spp=1, max_depth=2,
                       scene="cornell_mesh", backend="jnp")
    img_j = np.asarray(wavefront.render(scene, cfg))
    img_c = np.asarray(
        wavefront.render(scene, cfg.replace(backend="cluster"))
    )
    np.testing.assert_allclose(img_c, img_j, rtol=2e-3, atol=2e-3)


def test_spheres_merge(mesh_scene):
    """Sphere-containing scene: cluster backend must still see spheres."""
    scene = with_clusters(builder.cornell_spheres())
    g = scene.geometry
    o, d = _random_rays(512, seed=7)
    t_b, _, m_b = isect.brute(g, o, d)
    t_c, _, m_c = closest_hit_cluster(g, o, d, interpret=True)
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_b),
                               rtol=4e-3, atol=2e-4)
    assert (np.asarray(m_b) == np.asarray(m_c)).mean() > 0.999


def test_t_max_shadow_contract(mesh_scene):
    """Per-ray t_max: hits strictly nearer are always found; hits beyond
    may read as misses; visibility decisions are unchanged (the shadow
    query contract)."""
    g = mesh_scene.geometry
    o, d = _random_rays(1024, seed=13)
    t_ref, _, _ = closest_hit_cluster(g, o, d, interpret=True)
    t_ref = np.asarray(t_ref)
    hit = t_ref < C.T_FAR * 0.5
    # Bound strictly beyond each true hit: hit must still be found.
    above = np.where(hit, t_ref * 1.5, C.T_FAR).astype(np.float32)
    t_a, _, _ = closest_hit_cluster(g, o, d, interpret=True, t_max=above)
    np.testing.assert_allclose(np.asarray(t_a)[hit], t_ref[hit],
                               rtol=1e-6, atol=1e-6)
    # Bound strictly below each true hit: must read as a miss.
    below = np.where(hit, t_ref * 0.5, 1e-3).astype(np.float32)
    t_b, _, _ = closest_hit_cluster(g, o, d, interpret=True, t_max=below)
    assert (np.asarray(t_b) >= C.T_FAR * 0.5).all()
    # The bounded query agrees with brute force on every found hit.
    t_br = np.asarray(isect.brute(g, o, d)[0])
    np.testing.assert_allclose(np.asarray(t_a)[hit], t_br[hit],
                               rtol=1e-4, atol=1e-5)


def test_tiled_pixel_ids_bijection():
    from pathtracer.engine.camera import tiled_pixel_ids

    ids = np.asarray(tiled_pixel_ids(jnp.uint32(0), 1024 * 64, 1024))
    assert sorted(ids.tolist()) == list(range(1024 * 64))
    # Non-tile-aligned band falls back to arange.
    ids2 = np.asarray(tiled_pixel_ids(jnp.uint32(5), 100, 30))
    np.testing.assert_array_equal(ids2, 5 + np.arange(100))


def test_feature_table_dots_are_moller_trumbore():
    """The f32 feature table's dots with ray features give (det, u*det,
    v*det, t*det) of Möller-Trumbore for every triangle (f64 check of
    the algebra the kernel relies on, rows it skips included)."""
    from pathtracer.accel.clusters import FEAT_ROWS
    from pathtracer.ops.intersect_cluster import _ray_features

    rng = np.random.default_rng(1)
    n = 200
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    cs = build_clusters(v0, e1, e2)
    assert cs.feat.dtype == np.float32
    assert cs.feat.shape == (FEAT_ROWS, len(cs.lo) * 4 * CLUSTER_TRIS)
    o = rng.normal(size=(1, 3)).astype(np.float32)
    d = rng.normal(size=(1, 3)).astype(np.float32)
    f = np.asarray(_ray_features(jnp.asarray(o), jnp.asarray(d)),
                   np.float64)[:, 0]
    f[10] = 0.0  # the t-bound row pairs with all-zero table rows
    q = (f[:, None] * cs.feat.astype(np.float64)).sum(0)
    q = q.reshape(len(cs.lo), 4, CLUSTER_TRIS)
    slot = cs.tri_map.reshape(len(cs.lo), CLUSTER_TRIS)
    for c in range(len(cs.lo)):
        for s in range(CLUSTER_TRIS):
            t = slot[c, s]
            if t < 0:
                assert not q[c, :, s].any(), "padding slots are all-zero"
                continue
            a, b, v = (x.astype(np.float64) for x in (e1[t], e2[t], v0[t]))
            p = np.cross(d[0], b)
            det = a @ p
            tvec = o[0] - v
            qv = np.cross(tvec, a)
            want = [det, tvec @ p, d[0] @ qv, b @ qv]
            np.testing.assert_allclose(q[c, :, s], want, rtol=1e-5,
                                       atol=1e-5)
