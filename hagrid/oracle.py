"""Brute-force intersection oracle.

The reference has no test suite (see SURVEY.md §4); our correctness story is
anchored by this oracle: closest-hit and any-hit computed by testing every
ray against every triangle. O(N*T) — use only for small scenes/tests. Tie
breaking matches the traversal kernels: strictly smaller t wins, equal t
resolved by smaller triangle id, so grid traversal can be compared
hit-for-hit against the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .core.intersect import moller_trumbore
from .core.types import Hits, Rays, Triangles


def _closest_one(org, dir, tmin, tmax, tris: Triangles) -> Hits:
    hit, t, u, v = moller_trumbore(org[None, :], dir[None, :],
                                   tris.v0, tris.e1, tris.e2, tmin, tmax)
    t_masked = jnp.where(hit, t, jnp.inf)
    # argmin breaks ties by lowest index, which is the smaller tri id.
    best = jnp.argmin(t_masked)
    found = t_masked[best] < jnp.inf
    return Hits(
        tri_id=jnp.where(found, best.astype(jnp.int32), jnp.int32(-1)),
        t=jnp.where(found, t_masked[best], jnp.inf),
        u=jnp.where(found, u[best], 0.0),
        v=jnp.where(found, v[best], 0.0),
    )


@jax.jit
def _closest_chunk(org, dir, tmin, tmax, tris: Triangles) -> Hits:
    return jax.vmap(lambda o, d, t0, t1: _closest_one(o, d, t0, t1, tris))(
        org, dir, tmin, tmax)


def closest_hit(rays: Rays, tris: Triangles, chunk: int = 2048) -> Hits:
    """Chunked over rays: the vmapped kernel materializes a
    (chunk, tris) intermediate, which at golden-generation scale
    (16k rays x 262k tris) otherwise allocates ~200GB."""
    n = rays.count
    if n <= chunk:
        return _closest_chunk(rays.org, rays.dir, rays.tmin, rays.tmax,
                              tris)
    outs = []
    for i in range(0, n, chunk):
        sl = slice(i, min(i + chunk, n))
        outs.append(jax.block_until_ready(_closest_chunk(
            rays.org[sl], rays.dir[sl], rays.tmin[sl], rays.tmax[sl],
            tris)))
    return Hits(tri_id=jnp.concatenate([o.tri_id for o in outs]),
                t=jnp.concatenate([o.t for o in outs]),
                u=jnp.concatenate([o.u for o in outs]),
                v=jnp.concatenate([o.v for o in outs]))


@jax.jit
def _any_chunk(rays: Rays, tris: Triangles) -> jnp.ndarray:
    def one(o, d, t0, t1):
        hit, _, _, _ = moller_trumbore(o[None, :], d[None, :],
                                       tris.v0, tris.e1, tris.e2, t0, t1)
        return jnp.any(hit)
    return jax.vmap(one)(rays.org, rays.dir, rays.tmin, rays.tmax)


def any_hit(rays: Rays, tris: Triangles, chunk: int = 2048) -> jnp.ndarray:
    """bool[N]: True where any triangle blocks the ray within (tmin, tmax).
    Chunked over rays like closest_hit."""
    n = rays.count
    if n <= chunk:
        return _any_chunk(rays, tris)
    return jnp.concatenate([
        jax.block_until_ready(_any_chunk(
            jax.tree.map(lambda a: a[i:i + chunk], rays), tris))
        for i in range(0, n, chunk)])
