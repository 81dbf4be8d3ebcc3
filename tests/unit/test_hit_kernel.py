"""The hit-query kernel (ops/intersect_cluster.py:walk_candidates) in
Pallas interpret mode on the CPU, its platform rule, and the compiled
kernel on a GPU (marked `gpu`; skips elsewhere)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer import constants as C
from pathtracer.accel.clusters import with_clusters
from pathtracer.engine import intersect as isect
from pathtracer.ops.intersect_cluster import (
    RAY_TILE,
    _ray_features,
    closest_hit_cluster,
    cull_candidates,
    interpret_for,
    walk_candidates,
)
from pathtracer.scene import builder


@pytest.fixture(scope="module")
def geom():
    return with_clusters(builder.cornell_mesh()).geometry


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _all_candidates(geom, n_blocks):
    """Every cluster for every tile, with the early exit disabled (entry
    bounds -inf)."""
    C_ = int(geom.cl_lo.shape[0])
    cand = jnp.broadcast_to(jnp.arange(C_, dtype=jnp.int32), (n_blocks, C_))
    return (cand, jnp.full((n_blocks,), C_, jnp.int32),
            jnp.full((n_blocks, C_), -jnp.inf, jnp.float32))


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("gpu", False)])
def test_interpret_for_platform(platform, interpret):
    """The CPU interprets the kernel; a GPU compiles it."""
    assert interpret_for(platform) is interpret


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_interpret_for_other_platform_raises(platform):
    """No platform quietly falls back to interpreting."""
    with pytest.raises(NotImplementedError, match=platform):
        interpret_for(platform)


@pytest.mark.parametrize("n", [1, RAY_TILE + 1, 1000])
def test_odd_batch_padding_matches_brute(geom, n):
    """Batches that are not a whole number of tiles are padded to one
    tile and sliced back; every real ray equals brute force."""
    o, d = _rays(n, seed=n)
    t_c, n_c, m_c = closest_hit_cluster(geom, o, d, interpret=True)
    t_b, n_b, m_b = isect.brute(geom, o, d)
    assert t_c.shape == (n,) and n_c.shape == (n, 3) and m_c.shape == (n,)
    t_b, t_c = np.asarray(t_b), np.asarray(t_c)
    hit = t_b < C.T_FAR * 0.5
    np.testing.assert_array_equal(hit, t_c < C.T_FAR * 0.5)
    np.testing.assert_allclose(t_c[hit], t_b[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_c)[hit],
                                  np.asarray(m_b)[hit])


def test_t_max_cap_reports_only_nearer_hits(geom):
    """rayf row 10 caps each ray: a hit is reported only when strictly
    nearer than the cap, else the cap comes back with slot -1."""
    o, d = _rays(4 * RAY_TILE, seed=3)
    t_b = np.asarray(isect.brute(geom, o, d)[0])
    rng = np.random.default_rng(4)
    cap = np.where(rng.random(len(o)) < 0.5, t_b * 1.25, t_b * 0.75)
    cap = np.minimum(cap, C.T_FAR).astype(np.float32)
    rayf = _ray_features(jnp.asarray(o), jnp.asarray(d), jnp.asarray(cap))
    cand, count, no_exit = _all_candidates(geom, len(o) // RAY_TILE)
    t, slot = walk_candidates(cand, count, no_exit, rayf,
                              jnp.asarray(geom.cl_feat), True)
    t, slot = np.asarray(t), np.asarray(slot)
    found = t_b < cap
    np.testing.assert_allclose(t[found], t_b[found], rtol=1e-4, atol=1e-5)
    assert (slot[found] >= 0).all()
    np.testing.assert_array_equal(t[~found], cap[~found])
    assert (slot[~found] == -1).all()


def test_ordered_exit_matches_full_walk(geom):
    """The ordered early exit (near-first list + entry bounds) returns
    the same t and slot as walking every candidate."""
    o, d = _rays(8 * RAY_TILE, seed=5)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    rayf = _ray_features(oj, dj)
    cand, count, tnear, _ = cull_candidates(
        jnp.asarray(geom.cl_lo), jnp.asarray(geom.cl_hi), oj, dj, RAY_TILE)
    feat = jnp.asarray(geom.cl_feat)
    t_on, s_on = walk_candidates(cand, count, tnear, rayf, feat, True)
    no_exit = jnp.full_like(tnear, -jnp.inf)
    t_off, s_off = walk_candidates(cand, count, no_exit, rayf, feat, True)
    np.testing.assert_array_equal(np.asarray(t_on), np.asarray(t_off))
    np.testing.assert_array_equal(np.asarray(s_on), np.asarray(s_off))
    assert (np.asarray(s_on) >= 0).mean() > 0.5


def test_ordered_exit_respects_t_max_cap(geom):
    """With the early exit on, a per-ray cap still reports exactly the
    hits strictly nearer than it (the engine's shadow query)."""
    n = 4 * RAY_TILE
    o, d = _rays(n, seed=9)
    t_b = np.asarray(isect.brute(geom, o, d)[0])
    cap = np.where(np.arange(n) % 3 == 0, t_b * 0.5, t_b * 1.5)
    cap = np.minimum(cap, C.T_FAR).astype(np.float32)
    oj, dj, cj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(cap)
    cand, count, tnear, _ = cull_candidates(
        jnp.asarray(geom.cl_lo), jnp.asarray(geom.cl_hi), oj, dj, RAY_TILE,
        t_max=cj)
    t, slot = walk_candidates(cand, count, tnear, _ray_features(oj, dj, cj),
                              jnp.asarray(geom.cl_feat), True)
    t, slot = np.asarray(t), np.asarray(slot)
    kept = cap < t_b
    np.testing.assert_array_equal(t[kept], cap[kept])
    assert (slot[kept] == -1).all()
    hit = ~kept & (t_b < C.T_FAR * 0.5)
    assert hit.any()
    np.testing.assert_allclose(t[hit], t_b[hit], rtol=1e-4, atol=1e-5)


def test_zero_count_walks_nothing(geom):
    """A tile whose candidate count is 0 keeps every ray's initial t and
    reports no slot, whatever its candidate row holds."""
    o, d = _rays(2 * RAY_TILE, seed=10)
    cand, _, no_exit = _all_candidates(geom, 2)
    count = jnp.asarray([0, cand.shape[1]], jnp.int32)
    rayf = _ray_features(jnp.asarray(o), jnp.asarray(d))
    t, slot = walk_candidates(cand, count, no_exit, rayf,
                              jnp.asarray(geom.cl_feat), True)
    t, slot = np.asarray(t), np.asarray(slot)
    np.testing.assert_array_equal(t[:RAY_TILE], C.T_FAR)
    assert (slot[:RAY_TILE] == -1).all()
    assert (slot[RAY_TILE:] >= 0).any()


def test_walk_vjp_is_zero(geom):
    """custom_vjp boundary: hit queries pass zero cotangents back."""
    o, d = _rays(RAY_TILE, seed=11)
    cand, count, no_exit = _all_candidates(geom, 1)
    feat = jnp.asarray(geom.cl_feat)

    def f(rayf):
        t, _ = walk_candidates(cand, count, no_exit, rayf, feat, True)
        return jnp.sum(jnp.where(t < C.T_FAR, t, 0.0))

    g = jax.grad(f)(_ray_features(jnp.asarray(o), jnp.asarray(d)))
    assert g.shape == (16, RAY_TILE)
    assert not np.asarray(g).any()


@pytest.mark.gpu
def test_compiled_kernel_matches_brute(gpu, geom):
    """The Triton-compiled kernel equals brute force (run on the card)."""
    o, d = _rays(64 * RAY_TILE, seed=13)
    with jax.default_device(gpu):
        t_c, _, m_c = jax.jit(closest_hit_cluster)(geom, o, d)
        with jax.default_matmul_precision("highest"):
            t_b, _, m_b = isect.brute(geom, o, d)
    t_b, t_c = np.asarray(t_b), np.asarray(t_c)
    hit = t_b < C.T_FAR * 0.5
    assert (hit == (t_c < C.T_FAR * 0.5)).mean() > 0.9999
    both = hit & (t_c < C.T_FAR * 0.5)
    np.testing.assert_allclose(t_c[both], t_b[both], rtol=1e-4, atol=1e-5)
    assert (np.asarray(m_c)[both] == np.asarray(m_b)[both]).mean() > 0.9999
