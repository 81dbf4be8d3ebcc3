"""Counter-based threefry sampler.

The reference seeds a curand state per CUDA thread and advances it
imperatively through the bounce loop (SURVEY.md §2.1 R5) — the draw a path
consumes therefore depends on execution order. That is hostile to XLA and to
multi-chip determinism, so this design replaces it with a *stateless*
counter-based scheme (BASELINE.json:5 "curand → stateless threefry"):

    every uniform is a pure function of (seed, spp_idx, bounce, pixel_id, slot)

computed with JAX's threefry2x32 via a fold_in chain ending in the absolute
pixel id. Threefry is bit-exact across CPU and GPU backends, so the numpy
oracle (oracle/tracer.py) consumes *identical* uniforms by calling these
same functions on the CPU backend — this is what makes "allclose at fixed
seeds" meaningful across oracle/jnp/Pallas and across ANY sharding of the
pixel space: a device holding a tile derives draws from the absolute pixel
ids it owns, never from device id, buffer position, or iteration order
(SURVEY.md §7 hard part 4). Stream-compacted/permuted ray buffers likewise
carry their pixel id with them and keep their stream.

Draw layout per (spp_idx, bounce), fixed at N_DRAWS slots:

    0: light-triangle selection      3: BSDF u1 (cosine r^2)
    1: light barycentric u1          4: BSDF u2 (cosine phi)
    2: light barycentric u2          5: Russian-roulette u
    6: Fresnel reflect/refract u (dielectrics)

Pixel jitter (2 draws) uses a distinct fold_in tag so it never collides
with a bounce stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Slot indices into a per-bounce draw row.
(LIGHT_SEL, LIGHT_U1, LIGHT_U2, BSDF_U1, BSDF_U2, RR_U,
 FRESNEL_U) = range(7)
N_DRAWS = 7

_JITTER_TAG = 0x3779B1  # distinct stream tag for pixel jitter


def _stream_key(seed, spp_idx, tag) -> jax.Array:
    key = jax.random.PRNGKey(seed)
    key = jax.random.fold_in(key, spp_idx)
    return jax.random.fold_in(key, tag)


def _per_pixel(key, pixel_ids, n: int) -> jax.Array:
    """(len(pixel_ids), n) uniforms; row i depends only on pixel_ids[i]."""
    def one(pid):
        return jax.random.uniform(
            jax.random.fold_in(key, pid), (n,), dtype=jnp.float32
        )

    return jax.vmap(one)(jnp.asarray(pixel_ids, jnp.uint32))


def pixel_jitter(seed, spp_idx, pixel_ids) -> jax.Array:
    """(N, 2) uniforms in [0,1) for sub-pixel camera-ray jitter.

    pixel_ids are absolute row-major ids (y * width + x), so any sharding
    of the image produces the same jitter for the same pixel.
    """
    return _per_pixel(_stream_key(seed, spp_idx, _JITTER_TAG), pixel_ids, 2)


def bounce_uniforms(seed, spp_idx, bounce, pixel_ids) -> jax.Array:
    """(N, N_DRAWS) uniforms for one bounce of the given pixels' paths."""
    return _per_pixel(_stream_key(seed, spp_idx, bounce), pixel_ids, N_DRAWS)
