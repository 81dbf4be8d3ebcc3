"""Scene-model invariants: normals, light table, builders (SURVEY.md §4.1)."""

import numpy as np

from pathtracer.scene import builder
from pathtracer.scene.model import make_lights, triangle_areas


def test_geometry_normals_unit():
    scene = builder.cornell_spheres()
    n = np.asarray(scene.geometry.tri_n)
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, rtol=1e-5)


def test_cornell_normals_face_inward():
    scene = builder.cornell_spheres()
    g = scene.geometry
    center = np.array([0.5, 0.5, 0.5], np.float32)
    centroid = np.asarray(g.tri_v0) + (
        np.asarray(g.tri_e1) + np.asarray(g.tri_e2)
    ) / 3.0
    to_center = center - centroid
    # Every wall/light normal points toward the box interior.
    dots = (np.asarray(g.tri_n) * to_center).sum(-1)
    assert (dots > 0).all(), dots


def test_light_table():
    scene = builder.cornell_spheres()
    lights = scene.lights
    idx = np.asarray(lights.tri_idx)
    assert len(idx) == 2  # the light quad = 2 triangles
    mats = np.asarray(scene.geometry.tri_mat)[idx]
    assert (mats == builder.LIGHT).all()
    cdf = np.asarray(lights.cdf)
    assert cdf[-1] == 1.0
    assert (np.diff(cdf) >= 0).all()
    area = triangle_areas(scene.geometry)[idx].sum()
    np.testing.assert_allclose(float(lights.total_area), area, rtol=1e-5)
    np.testing.assert_allclose(area, 0.35 * 0.35, rtol=1e-5)


def test_no_lights_scene_is_valid():
    scene = builder.cornell_spheres()
    mats = scene.materials
    dark = mats.__class__(
        albedo=mats.albedo, emission=np.zeros_like(np.asarray(mats.emission))
    )
    lights = make_lights(scene.geometry, dark)
    assert np.asarray(lights.tri_idx).shape == (0,)
    assert float(lights.total_area) == 0.0


def test_mesh_scene_builds():
    scene = builder.cornell_mesh()
    T = np.asarray(scene.geometry.tri_v0).shape[0]
    assert T > 5000  # walls + ~5120-triangle procedural mesh
    # Mesh sits inside the box.
    v = np.asarray(scene.geometry.tri_v0)
    assert v.min() >= -1e-3 and v.max() <= 1.0 + 1e-3
    assert np.asarray(scene.geometry.sph_c).shape == (0, 3)


def test_procedural_bunny_deterministic():
    a = builder.procedural_bunny(2)
    b = builder.procedural_bunny(2)
    np.testing.assert_array_equal(a, b)
    assert len(a) == 320  # 20 * 4^2


def test_emissive_sphere_lights():
    """Emissive SPHERES are NEE lights (else they lose energy silently):
    make_lights must put them in
    the table with area 4*pi*r^2, triangles first in the cdf."""
    from pathtracer.scene.model import (
        Materials,
        make_geometry,
        make_lights,
        triangle_areas,
    )

    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    geom = make_geometry(
        tri, np.array([2], np.int32),
        sph_c=np.array([[0.0, 0.0, 2.0], [1.0, 1.0, 1.0]], np.float32),
        sph_r=np.array([0.5, 0.1], np.float32),
        sph_mat=np.array([1, 0], np.int32),
    )
    mats = Materials(
        albedo=np.zeros((3, 3), np.float32),
        emission=np.array(
            [[0, 0, 0], [5.0, 5.0, 5.0], [3.0, 3.0, 3.0]], np.float32),
    )
    lights = make_lights(geom, mats)
    np.testing.assert_array_equal(np.asarray(lights.tri_idx), [0])
    np.testing.assert_array_equal(np.asarray(lights.sph_idx), [0])
    t_area = float(triangle_areas(geom)[0])
    s_area = 4.0 * np.pi * 0.5 ** 2
    assert abs(float(lights.total_area) - (t_area + s_area)) < 1e-4
    cdf = np.asarray(lights.cdf)
    assert cdf.shape == (2,)
    assert abs(cdf[0] - t_area / (t_area + s_area)) < 1e-6
    assert cdf[-1] == 1.0

    # Sphere-only lights work too (no triangle lights at all).
    mats_sph = Materials(
        albedo=np.zeros((3, 3), np.float32),
        emission=np.array(
            [[0, 0, 0], [5.0, 5.0, 5.0], [0, 0, 0]], np.float32),
    )
    l2 = make_lights(geom, mats_sph)
    assert np.asarray(l2.tri_idx).shape == (0,)
    np.testing.assert_array_equal(np.asarray(l2.sph_idx), [0])
    assert abs(float(l2.total_area) - s_area) < 1e-4
