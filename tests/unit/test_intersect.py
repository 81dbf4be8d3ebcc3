"""Unit tests for the oracle's intersection math (SURVEY.md §4.1).

These pin down Möller–Trumbore and sphere-hit behavior against hand-worked
closed-form cases; the jnp and Pallas traversal paths are later validated
against the oracle, so correctness chains back to these.
"""

import numpy as np

from pathtracer import constants as C
from pathtracer.oracle.tracer import (
    _intersect_spheres,
    _intersect_tris,
    intersect_closest,
)
from pathtracer.scene.model import make_geometry


def _tri(v0, v1, v2):
    v0, v1, v2 = (np.asarray(p, np.float32) for p in (v0, v1, v2))
    return v0[None], (v1 - v0)[None], (v2 - v0)[None]


def test_mt_hits_center():
    v0, e1, e2 = _tri([0, 0, 1], [1, 0, 1], [0, 1, 1])
    o = np.array([[0.25, 0.25, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t = _intersect_tris(o, d, v0, e1, e2)
    np.testing.assert_allclose(t[0, 0], 1.0, rtol=1e-6)


def test_mt_misses_outside():
    v0, e1, e2 = _tri([0, 0, 1], [1, 0, 1], [0, 1, 1])
    o = np.array([[0.8, 0.8, 0.0]], np.float32)  # beyond the hypotenuse
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t = _intersect_tris(o, d, v0, e1, e2)
    assert t[0, 0] == C.T_FAR


def test_mt_parallel_ray_misses():
    v0, e1, e2 = _tri([0, 0, 1], [1, 0, 1], [0, 1, 1])
    o = np.array([[0.2, 0.2, 0.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)  # parallel to plane
    t = _intersect_tris(o, d, v0, e1, e2)
    assert t[0, 0] == C.T_FAR


def test_mt_behind_origin_misses():
    v0, e1, e2 = _tri([0, 0, -1], [1, 0, -1], [0, 1, -1])
    o = np.array([[0.25, 0.25, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t = _intersect_tris(o, d, v0, e1, e2)
    assert t[0, 0] == C.T_FAR


def test_mt_edge_and_vertex_hit():
    # Hits exactly on an edge (u=0) and on a vertex count as hits (>= 0).
    v0, e1, e2 = _tri([0, 0, 1], [1, 0, 1], [0, 1, 1])
    o = np.array([[0.0, 0.5, 0.0], [0.0, 0.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    t = _intersect_tris(o, d, v0, e1, e2)
    np.testing.assert_allclose(t[:, 0], [1.0, 1.0], rtol=1e-6)


def test_degenerate_triangle_never_hits():
    v0, e1, e2 = _tri([0, 0, 1], [1, 0, 1], [2, 0, 1])  # zero area
    o = np.array([[0.5, 0.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t = _intersect_tris(o, d, v0, e1, e2)
    assert t[0, 0] == C.T_FAR


def test_sphere_outside_hit():
    c = np.array([[0.0, 0.0, 2.0]], np.float32)
    r = np.array([0.5], np.float32)
    o = np.zeros((1, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t = _intersect_spheres(o, d, c, r)
    np.testing.assert_allclose(t[0, 0], 1.5, rtol=1e-6)


def test_sphere_inside_hits_far_side():
    c = np.zeros((1, 3), np.float32)
    r = np.array([1.0], np.float32)
    o = np.zeros((1, 3), np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    t = _intersect_spheres(o, d, c, r)
    np.testing.assert_allclose(t[0, 0], 1.0, rtol=1e-6)


def test_sphere_tangent_and_miss():
    c = np.array([[0.0, 1.0, 2.0]], np.float32)
    r = np.array([0.5], np.float32)
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], np.float32)
    t = _intersect_spheres(o, d, c, r)
    assert t[0, 0] == C.T_FAR  # passes 1.0 away from center > r
    assert t[1, 0] == C.T_FAR  # wrong direction


def test_closest_hit_picks_nearest_across_prim_types():
    # A triangle at z=1 in front of a sphere at z=3.
    tris = np.array(
        [[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32
    )
    geom = make_geometry(
        tris,
        np.array([0], np.int32),
        sph_c=np.array([[0, 0, 3]], np.float32),
        sph_r=np.array([0.5], np.float32),
        sph_mat=np.array([1], np.int32),
    )
    o = np.array([[0.0, 0.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, n, m = intersect_closest(geom, o, d)
    np.testing.assert_allclose(t[0], 1.0, rtol=1e-6)
    assert m[0] == 0
    # Ray offset to miss the triangle → hits the sphere.
    o2 = np.array([[0.0, -2.0, 0.0]], np.float32)
    d2 = np.array([[0.0, 0.0, 1.0]], np.float32)
    # direction toward sphere center from below
    d2 = np.array([[0.0, 2.0, 3.0]], np.float32)
    d2 /= np.linalg.norm(d2)
    t2, n2, m2 = intersect_closest(geom, o2, d2)
    assert m2[0] == 1
    assert t2[0] < C.T_FAR
