"""Reference (jnp, vmapped-DDA) traversal over the uniform grid.

Re-derivation of the reference's traversal loop (src/traverse.cu: slab test
→ entry voxel → per-cell Moller-Trumbore → step past cell on min-exit axis)
for the single-level grid, as a per-ray Amanatides-Woo DDA in a
``lax.while_loop`` under ``vmap``. This is the correctness baseline (config
#1 in BASELINE.json) and the oracle for the wavefront/Pallas kernels; the
fast paths live in ops/ and must match it hit-for-hit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.intersect import moller_trumbore, safe_inv_dir, slab_test
from ..core.types import Hits, Rays
from .uniform import UniformGrid, linear_cell


def _trace_one(grid: UniformGrid, org, dir, tmin, tmax, any_hit: bool):
    dims = jnp.asarray(grid.dims, jnp.int32)
    cs = grid.cell_size
    inv_dir = safe_inv_dir(dir)
    enter, exit_, ok = slab_test(org, inv_dir, grid.bbox_lo, grid.bbox_hi,
                                 tmin, tmax)

    # Entry voxel; nudge inside so the floor is robust on the boundary.
    p = org + enter * dir
    v0 = jnp.floor((p - grid.bbox_lo) / cs).astype(jnp.int32)
    v0 = jnp.clip(v0, 0, dims - 1)
    step = jnp.where(dir >= 0, 1, -1).astype(jnp.int32)
    next_bound = grid.bbox_lo + (v0 + (dir >= 0)).astype(jnp.float32) * cs
    t_next0 = jnp.where(dir != 0.0, (next_bound - org) * inv_dir, jnp.inf)
    t_delta = jnp.where(dir != 0.0, cs * jnp.abs(inv_dir), jnp.inf)

    tris = grid.tris

    def isect_cell(cell, best):
        s0 = grid.cell_starts[cell]
        s1 = grid.cell_starts[cell + 1]

        def body(carry):
            r, bt, bid, bu, bv = carry
            tid = grid.ref_ids[r]
            h, t, u, v = moller_trumbore(org, dir, tris.v0[tid], tris.e1[tid],
                                         tris.e2[tid], tmin, tmax)
            better = h & ((t < bt) | ((t == bt) & (tid < bid)))
            bt = jnp.where(better, t, bt)
            bid = jnp.where(better, tid, bid)
            bu = jnp.where(better, u, bu)
            bv = jnp.where(better, v, bv)
            return r + 1, bt, bid, bu, bv

        def cond(carry):
            r = carry[0]
            if any_hit:
                return (r < s1) & (carry[2] < 0)
            return r < s1

        r0 = (s0, best[0], best[1], best[2], best[3])
        out = jax.lax.while_loop(cond, body, r0)
        return out[1], out[2], out[3], out[4]

    def loop_cond(state):
        active, _, _, best = state
        if any_hit:
            return active & (best[1] < 0)
        return active

    def loop_body(state):
        _, v, t_next, best = state
        cell = linear_cell(v[0], v[1], v[2], grid.dims)
        best = isect_cell(cell, best)
        t_exit = jnp.min(t_next)
        axis = jnp.argmin(t_next)
        v = v.at[axis].add(step[axis])
        out = (v[axis] < 0) | (v[axis] >= dims[axis])
        t_next = t_next.at[axis].add(t_delta[axis])
        done = (best[0] <= t_exit) | out | (t_exit >= tmax)
        return (~done, v, t_next, best)

    best0 = (jnp.inf, jnp.int32(-1), jnp.float32(0), jnp.float32(0))
    state0 = (ok, v0, t_next0, best0)
    _, _, _, best = jax.lax.while_loop(loop_cond, loop_body, state0)
    bt, bid, bu, bv = best
    found = bid >= 0
    return Hits(tri_id=bid, t=jnp.where(found, bt, jnp.inf), u=bu, v=bv)


def closest_hit(grid: UniformGrid, rays: Rays) -> Hits:
    f = jax.vmap(lambda o, d, t0, t1: _trace_one(grid, o, d, t0, t1, False))
    return f(rays.org, rays.dir, rays.tmin, rays.tmax)


def any_hit(grid: UniformGrid, rays: Rays) -> jnp.ndarray:
    f = jax.vmap(lambda o, d, t0, t1: _trace_one(grid, o, d, t0, t1, True))
    return f(rays.org, rays.dir, rays.tmin, rays.tmax).tri_id >= 0


closest_hit_jit = jax.jit(closest_hit)
any_hit_jit = jax.jit(any_hit)
