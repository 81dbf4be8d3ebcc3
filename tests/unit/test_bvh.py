"""BVH build invariants + traversal-vs-brute equality (SURVEY.md §4.1/4.2)."""

import numpy as np
import pytest

from pathtracer import constants as C
from pathtracer.accel.build import build_bvh, check_invariants, with_bvh
from pathtracer.accel.traverse import closest_hit
from pathtracer.engine import intersect as isect
from pathtracer.scene import builder


@pytest.fixture(scope="module")
def mesh_scene():
    return with_bvh(builder.cornell_mesh())


def _geom_np(scene):
    g = scene.geometry
    return g


def test_build_invariants(mesh_scene):
    g = mesh_scene.geometry
    bvh = build_bvh(
        np.asarray(g.tri_v0), np.asarray(g.tri_e1), np.asarray(g.tri_e2)
    )
    check_invariants(bvh, np.asarray(g.tri_v0).shape[0])


def test_leaf_boxes_contain_triangles(mesh_scene):
    g = mesh_scene.geometry
    v0 = np.asarray(g.tri_v0)
    p1 = v0 + np.asarray(g.tri_e1)
    p2 = v0 + np.asarray(g.tri_e2)
    lo = np.asarray(g.bvh_lo)
    hi = np.asarray(g.bvh_hi)
    first = np.asarray(g.bvh_first)
    count = np.asarray(g.bvh_count)
    for i in np.nonzero(count > 0)[0][:200]:
        sl = slice(first[i], first[i] + count[i])
        tri_lo = np.minimum(np.minimum(v0[sl], p1[sl]), p2[sl]).min(0)
        tri_hi = np.maximum(np.maximum(v0[sl], p1[sl]), p2[sl]).max(0)
        assert (lo[i] <= tri_lo + 1e-6).all()
        assert (hi[i] >= tri_hi - 1e-6).all()


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    # Origins inside the Cornell box, random directions.
    o = rng.random((n, 3)).astype(np.float32) * 0.9 + 0.05
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_traversal_equals_brute_random_rays(mesh_scene):
    g = mesh_scene.geometry
    o, d = _random_rays(2048)
    t_b, n_b, m_b = isect.brute(g, o, d)
    t_t, n_t, m_t = closest_hit(g, o, d)
    np.testing.assert_allclose(np.asarray(t_t), np.asarray(t_b), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_t), np.asarray(m_b))
    np.testing.assert_allclose(np.asarray(n_t), np.asarray(n_b), atol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_traversal_any_batch_size(mesh_scene, n):
    """The walk is one batch-wide loop: any batch size, same shapes and
    hits as brute force."""
    g = mesh_scene.geometry
    o, d = _random_rays(n, seed=n)
    t_t, n_t, m_t = closest_hit(g, o, d)
    assert t_t.shape == (n,) and n_t.shape == (n, 3) and m_t.shape == (n,)
    t_b, _, m_b = isect.brute(g, o, d)
    np.testing.assert_allclose(np.asarray(t_t), np.asarray(t_b), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_t), np.asarray(m_b))


@pytest.mark.parametrize("n_target", [1280, 5120])
def test_traversal_equals_brute_instanced_mesh(n_target):
    """big_mesh's instanced layout (the large-scene route's scene), cut
    to a few instances: the walk finds brute force's hits."""
    g = with_bvh(builder.big_mesh(n_target=n_target)).geometry
    o, d = _random_rays(512, seed=n_target)
    t_b, _, m_b = isect.brute(g, o, d)
    t_t, _, m_t = closest_hit(g, o, d)
    np.testing.assert_allclose(np.asarray(t_t), np.asarray(t_b), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_t), np.asarray(m_b))


def test_traversal_with_spheres():
    scene = with_bvh(builder.cornell_spheres())
    g = scene.geometry
    o, d = _random_rays(1024, seed=2)
    t_b, n_b, m_b = isect.brute(g, o, d)
    t_t, n_t, m_t = closest_hit(g, o, d)
    np.testing.assert_allclose(np.asarray(t_t), np.asarray(t_b), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_t), np.asarray(m_b))


def test_axis_aligned_rays_no_nan(mesh_scene):
    # Rays with exact zero direction components stress the slab test.
    g = mesh_scene.geometry
    o = np.array(
        [[0.5, 0.5, -0.5], [0.5, 1.5, 0.5], [-0.5, 0.5, 0.5]], np.float32
    )
    d = np.array(
        [[0.0, 0.0, 1.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]], np.float32
    )
    t, n, m = closest_hit(g, o, d)
    t = np.asarray(t)
    assert np.isfinite(t).all()
    assert (t < C.T_FAR).all()  # all three enter the box and hit walls
    tb, _, mb = isect.brute(g, o, d)
    np.testing.assert_allclose(t, np.asarray(tb), atol=1e-6)


def test_light_indices_remapped(mesh_scene):
    g = mesh_scene.geometry
    mats = np.asarray(g.tri_mat)[np.asarray(mesh_scene.lights.tri_idx)]
    assert (mats == builder.LIGHT).all()


def test_obj_loader_roundtrip(tmp_path):
    from pathtracer.scene.obj import load_obj, normalize_to_unit

    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 2 0 0\nv 2 2 0\nv 0 2 0\n"
        "f 1 2 3 4\n"  # quad → 2 triangles via fan
        "f -4//1 -3//1 -2//1\n"  # negative + v//vn style indices
    )
    tri = load_obj(str(p))
    assert tri.shape == (3, 3, 3)
    np.testing.assert_allclose(tri[0][1], [2, 0, 0])
    unit = normalize_to_unit(tri)
    span = unit.reshape(-1, 3).max(0) - unit.reshape(-1, 3).min(0)
    np.testing.assert_allclose(span.max(), 1.0, rtol=1e-6)


def test_native_builder_matches_numpy_semantics():
    """C++ binned-SAH builder: same invariants, same closest hits."""
    from pathtracer.accel import native
    from pathtracer.scene import builder as B

    if not native.available():
        import pytest

        pytest.skip("native builder not built")
    scene = B.cornell_mesh(mesh_tris=B.procedural_bunny(2))
    g = scene.geometry
    v0 = np.asarray(g.tri_v0)
    e1 = np.asarray(g.tri_e1)
    e2 = np.asarray(g.tri_e2)
    bvh_n = native.build_bvh_native(v0, e1, e2)
    check_invariants(bvh_n, len(v0))

    # Same closest hits through the traversal as the numpy tree.
    s_np = with_bvh(scene, engine="numpy")
    s_nat = with_bvh(scene, engine="native")
    o, d = _random_rays(1024, seed=7)
    t_a, _, m_a = closest_hit(s_np.geometry, o, d)
    t_b, _, m_b = closest_hit(s_nat.geometry, o, d)
    np.testing.assert_allclose(np.asarray(t_a), np.asarray(t_b), atol=1e-5)
    # Materials may differ only where two triangles tie at shared edges.
    mism = (np.asarray(m_a) != np.asarray(m_b)).mean()
    assert mism < 0.005, mism


def test_native_builder_big_input_fast():
    """SAH build of ~80k triangles completes quickly (config-5 scale is
    2M; this keeps CI cheap while catching gross regressions)."""
    import time

    from pathtracer.accel import native
    from pathtracer.scene import builder as B

    if not native.available():
        import pytest

        pytest.skip("native builder not built")
    tri = B.procedural_bunny(6)  # 81920 triangles
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    t0 = time.time()
    bvh = native.build_bvh_native(v0, e1, e2)
    dt = time.time() - t0
    assert dt < 5.0, dt
    assert len(bvh.order) == len(tri)


def test_bunny_asset_roundtrip_exact():
    """The committed assets/bunny.obj loads bit-identical to the
    procedural bunny, so the asset-backed benchmark scene preserves
    goldens (scripts/make_assets.py contract)."""
    import os

    import numpy as np

    from pathtracer.scene.builder import _bunny_asset, procedural_bunny

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    asset = os.path.join(here, "assets", "bunny.obj")
    assert os.path.exists(asset), "committed bunny.obj missing"
    assert np.array_equal(_bunny_asset(), procedural_bunny(4))
