"""Step-synchronous wavefront traversal (jnp, batched) with ray compaction.

The reference traverses with one CUDA thread per ray chasing pointers
(src/traverse.cu); here the traversal is a *wavefront*:
all rays advance in lockstep, each iteration doing pure batched vector math
plus batched gathers — no per-ray control flow. Each iteration every live
ray either tests a fixed-size chunk of its current cell's refs (masked
Moller-Trumbore over lanes) or steps past the whole cell (the
irregular-grid "skip by cell bbox, not voxel" rule: reference
src/traverse.cu computes exit t from the CELL's int bbox).

Lockstep has a tail problem SIMT does not: one long-marching ray keeps the
whole batch burning gather bandwidth. ``trace`` therefore runs in rounds —
march a capped number of iterations, scatter results, compact survivors
into a power-of-two-smaller batch, repeat (BASELINE.json names ray
sorting/compaction as the divergence strategy). Cost becomes proportional
to live rays, not to the slowest ray.

Grid polymorphism: every grid object exposes `.cell_starts`, `.ref_ids`,
`.bbox_lo/.bbox_hi`, `.tris`, `.fine_dims`, and a module-level
``lookup_fn(grid, voxel i32[N,3]) -> (cell, cmin, cmax)`` is passed
statically so jit caches per grid *type*, not per instance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.intersect import moller_trumbore, safe_inv_dir, slab_test
from ..core.types import Hits, Rays, Triangles


def _load_cell(grid, lookup_fn, voxel, in_bounds):
    """Masked cell fetch: out-of-bounds rays get an empty range.

    Packed grids (irregular) answer in TWO row-gathers: a packed top-info
    word and an 8-wide entry record [cmin, cmax, start, end]. The generic
    path costs ~7 gathers, and gathers are the hot loop's currency."""
    safe_vox = jnp.maximum(voxel, 0)
    if getattr(grid, "is_packed", False):
        lv = grid.levels
        top = safe_vox >> lv
        tdx, tdy, _ = grid.top_dims
        tidx = (top[:, 2] * tdy + top[:, 1]) * tdx + top[:, 0]
        info = grid.top_info[tidx]
        r = info & 7
        off = info >> 3
        local = (safe_vox & ((1 << lv) - 1)) >> (lv - r)[:, None]
        side = jnp.int32(1) << r
        sub = (local[:, 2] * side + local[:, 1]) * side + local[:, 0]
        rec = grid.erec[off + sub]
        s0 = jnp.where(in_bounds, rec[:, 6], 0)
        s1 = jnp.where(in_bounds, rec[:, 7], 0)
        return rec[:, 0:3], rec[:, 3:6], s0, s1
    cell, cmin, cmax = lookup_fn(grid, safe_vox)
    starts = grid.cell_starts
    s0 = jnp.where(in_bounds, starts[cell], 0)
    s1 = jnp.where(in_bounds, starts[cell + 1], 0)
    return cmin, cmax, s0, s1


def _init_state(grid, lookup_fn, rays: Rays):
    n = rays.count
    dims = jnp.asarray(grid.fine_dims, jnp.int32)
    cs = (grid.bbox_hi - grid.bbox_lo) / jnp.asarray(grid.fine_dims,
                                                     jnp.float32)
    inv_dir = safe_inv_dir(rays.dir)
    enter, _, ok = slab_test(rays.org, inv_dir, grid.bbox_lo, grid.bbox_hi,
                             rays.tmin, rays.tmax)
    p_in = rays.org + enter[:, None] * rays.dir
    vox0 = jnp.clip(jnp.floor((p_in - grid.bbox_lo) / cs).astype(jnp.int32),
                    0, dims - 1)
    cmin0, cmax0, s00, s10 = _load_cell(grid, lookup_fn, vox0, ok)
    return dict(
        alive=ok, cursor=s00, end=s10, cmin=cmin0, cmax=cmax0,
        t_cur=jnp.maximum(enter, rays.tmin),
        rays=rays, idx=jnp.arange(n, dtype=jnp.int32),
        best_t=jnp.full((n,), jnp.inf, jnp.float32),
        best_id=jnp.full((n,), -1, jnp.int32),
        best_u=jnp.zeros((n,), jnp.float32),
        best_v=jnp.zeros((n,), jnp.float32),
    )


def _make_body(grid, lookup_fn, refs_per_iter: int, any_hit: bool):
    dims = jnp.asarray(grid.fine_dims, jnp.int32)
    cs = (grid.bbox_hi - grid.bbox_lo) / jnp.asarray(grid.fine_dims,
                                                     jnp.float32)
    inv_cs = 1.0 / cs
    tris = grid.tris
    ref_ids = grid.ref_ids

    def body(st):
        rays = st["rays"]
        org = rays.org
        dirs = rays.dir
        inv_dir = safe_inv_dir(dirs)
        pos_dir = dirs >= 0
        alive = st["alive"]
        cursor = st["cursor"]
        end = st["end"]

        # --- Phase 1: masked chunk of Moller-Trumbore tests. ------------
        best_t = st["best_t"]
        best_id = st["best_id"]
        best_u = st["best_u"]
        best_v = st["best_v"]
        packed = getattr(grid, "is_packed", False)
        no_tris = tris.count == 0  # static: empty scene has nothing to test

        def mt_update(m, tid, v0, e1, e2, best):
            bt, bid, bu, bv = best
            tid = jnp.where(m, tid, 0)
            h, t, u, v = moller_trumbore(org, dirs, v0, e1, e2,
                                         rays.tmin, rays.tmax)
            better = m & h & ((t < bt) | ((t == bt) & (tid < bid)))
            return (jnp.where(better, t, bt), jnp.where(better, tid, bid),
                    jnp.where(better, u, bu), jnp.where(better, v, bv))

        best = (best_t, best_id, best_u, best_v)
        quad_ok = packed and grid.ref_tris.shape[0] % 4 == 0
        if no_tris:
            pass
        elif quad_ok:
            # Quad rows: ONE 48-wide row-gather serves 4 triangle tests
            # (gather cost is dominated by per-row latency, not bytes).
            quads = grid.ref_tris.reshape(-1, 48)  # free view; R_cap % 4 == 0
            qidx = jnp.minimum(cursor >> 2, quads.shape[0] - 1)
            qrow = quads[jnp.where(alive, qidx, 0)]
            base = qidx << 2
            for k in range(4):
                ridx = base + k
                m = alive & (ridx >= cursor) & (ridx < end)
                row = qrow[:, k * 12:k * 12 + 12]
                tid = row[:, 9].astype(jnp.int32)
                best = mt_update(m, tid, row[:, 0:3], row[:, 3:6],
                                 row[:, 6:9], best)
            cursor = jnp.where(alive, jnp.minimum(base + 4, end), cursor)
        else:
            for k in range(refs_per_iter):
                r = cursor + k
                m = alive & (r < end)
                rm = jnp.where(m, r, 0)
                if packed:  # per-row packed path (odd-capacity tables)
                    row = grid.ref_tris[rm]
                    tid = row[:, 9].astype(jnp.int32)
                    best = mt_update(m, tid, row[:, 0:3], row[:, 3:6],
                                     row[:, 6:9], best)
                else:
                    tid = ref_ids[rm]
                    safe = jnp.where(m, tid, 0)
                    best = mt_update(m, tid, tris.v0[safe], tris.e1[safe],
                                     tris.e2[safe], best)
            cursor = jnp.minimum(cursor + refs_per_iter, end)
        best_t, best_id, best_u, best_v = best

        # --- Phase 2: rays whose cell is exhausted step past the cell. --
        finished_cell = alive & (cursor >= end)
        t_cur = st["t_cur"]
        hi_plane = grid.bbox_lo + (st["cmax"] + 1).astype(jnp.float32) * cs
        lo_plane = grid.bbox_lo + st["cmin"].astype(jnp.float32) * cs
        t_axes = jnp.where(pos_dir, (hi_plane - org) * inv_dir,
                           (lo_plane - org) * inv_dir)
        t_axes = jnp.where(dirs != 0.0, t_axes, jnp.inf)
        # Only exit planes AHEAD of the ray's march count. Expanded cells
        # overlap, so a cell entered by clamping can have exit planes the
        # ray already crossed; choosing one moves t backwards and two cells
        # ping-pong forever (observed on Sponza). Keeping t monotone and
        # re-deriving the voxel from the true position breaks every cycle.
        t_ahead = jnp.where(t_axes > t_cur[:, None], t_axes, jnp.inf)
        t_exit = jnp.min(t_ahead, axis=-1)
        axis = jnp.argmin(t_ahead, axis=-1)
        has_ahead = jnp.isfinite(t_exit)
        # Degenerate fallback (position already outside the bbox on every
        # axis): nudge t forward and resolve the true voxel, no jump.
        t_step = jnp.where(has_ahead, t_exit,
                           t_cur * 1.000001 + 1e-5)

        if any_hit:
            terminated = best_id >= 0
        else:
            terminated = best_t <= t_step
        terminated = terminated | (t_step >= rays.tmax)

        # Next voxel: jump past the cell bbox on the exit axis; recompute
        # the other axes from the ray point at t_step, clamped into the
        # cell bbox (at t_step the ray is still inside the cell's slab on
        # non-exit axes; the clamp kills float-rounding regressions).
        p_exit = org + t_step[:, None] * dirs
        vox_true = jnp.floor((p_exit - grid.bbox_lo) * inv_cs
                             ).astype(jnp.int32)
        vox_in = jnp.clip(vox_true, st["cmin"], st["cmax"])
        jump = jnp.where(pos_dir, st["cmax"] + 1, st["cmin"] - 1)
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.bool_)
        vox_in = jnp.where(onehot, jump, vox_in)
        vox = jnp.where(has_ahead[:, None], vox_in, vox_true)
        in_bounds = jnp.all((vox >= 0) & (vox < dims), axis=-1)

        advance = finished_cell & ~terminated & in_bounds
        cmin, cmax, s0, s1 = _load_cell(grid, lookup_fn, vox, advance)

        new_alive = alive & jnp.where(finished_cell, advance, True)
        return dict(
            alive=new_alive,
            cursor=jnp.where(advance, s0, cursor),
            end=jnp.where(advance, s1, end),
            cmin=jnp.where(advance[:, None], cmin, st["cmin"]),
            cmax=jnp.where(advance[:, None], cmax, st["cmax"]),
            t_cur=jnp.where(advance, t_step, t_cur),
            rays=rays, idx=st["idx"],
            best_t=best_t, best_id=best_id, best_u=best_u, best_v=best_v,
        )

    return body


def max_march_iters(fine_dims, max_refs_per_cell: int = 0,
                    refs_per_iter: int = 4) -> int:
    """Upper bound on one ray's march length (safety cap).

    Each loop iteration either steps one cell or tests one ref chunk, so a
    single huge cell (teapot-in-stadium) consumes refs/refs_per_iter
    iterations on its own; the cap scales with the largest cell so such
    scenes cannot exhaust it mid-cell and silently truncate."""
    return (8 * int(sum(fine_dims)) + 256
            + 8 * (int(max_refs_per_cell) // max(refs_per_iter, 1)))


#: Observability for the last `trace` call (see SURVEY.md §5 metrics):
#: rays still alive when the safety cap expired (0 in healthy runs).
last_trace_stats = {"truncated_rays": 0, "rounds": 0,
                    "mean_steps": 0.0}


def trace_wavefront(rays: Rays, tris: Triangles, lookup, starts, ref_ids,
                    bbox_lo, bbox_hi, fine_dims, refs_per_iter: int = 8,
                    any_hit: bool = False,
                    max_iters: int | None = None) -> Hits:
    """Single while_loop to completion (no compaction) — the simple path
    used by tests and small workloads. Callers wrap in jit."""

    class _G:  # adapt the loose-array interface to the grid protocol
        pass

    g = _G()
    g.cell_starts = starts
    g.ref_ids = ref_ids
    g.bbox_lo = bbox_lo
    g.bbox_hi = bbox_hi
    g.tris = tris
    g.fine_dims = tuple(fine_dims)

    def lookup_fn(_g, vox):
        return lookup(vox)

    if max_iters is None:
        max_iters = max_march_iters(fine_dims)
    state = _init_state(g, lookup_fn, rays)
    state["it"] = jnp.int32(0)
    body = _make_body(g, lookup_fn, refs_per_iter, any_hit)

    def cond(st):
        return jnp.any(st["alive"]) & (st["it"] < max_iters)

    def body_it(st):
        it = st.pop("it")
        out = body(st)
        out["it"] = it + 1
        return out

    out = jax.lax.while_loop(cond, body_it, state)
    found = out["best_id"] >= 0
    return Hits(tri_id=out["best_id"],
                t=jnp.where(found, out["best_t"], jnp.inf),
                u=out["best_u"], v=out["best_v"])


# --------------------------------------------------------------------------
# Compacted round-based tracer (the fast path).
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("lookup_fn",))
def _jit_init(grid, rays, lookup_fn):
    return _init_state(grid, lookup_fn, rays)


@functools.partial(
    jax.jit,
    static_argnames=("lookup_fn", "refs_per_iter", "any_hit", "cap"))
def _jit_segment(grid, state, lookup_fn, refs_per_iter, any_hit, cap):
    """Run up to `cap` iterations (early-exits when all rays are done)."""
    body = _make_body(grid, lookup_fn, refs_per_iter, any_hit)
    state = dict(state, it=jnp.int32(0))

    def cond(st):
        return jnp.any(st["alive"]) & (st["it"] < cap)

    def body_it(st):
        it = st.pop("it")
        steps = st.pop("steps") + st["alive"].astype(jnp.int32)
        out = body(st)
        out["it"] = it + 1
        out["steps"] = steps
        return out

    out = jax.lax.while_loop(cond, body_it, state)
    iters = out.pop("it")
    return out, jnp.sum(out["alive"].astype(jnp.int32)), iters


@jax.jit
def _jit_scatter(out, state):
    """Write the batch's current results into the full-size output."""
    idx = state["idx"]
    return dict(
        best_t=out["best_t"].at[idx].set(state["best_t"]),
        best_id=out["best_id"].at[idx].set(state["best_id"]),
        best_u=out["best_u"].at[idx].set(state["best_u"]),
        best_v=out["best_v"].at[idx].set(state["best_v"]),
        steps=out["steps"].at[idx].set(state["steps"]),
    )


@functools.partial(jax.jit, static_argnames=("size",))
def _jit_compact(state, size: int):
    """Pack live rays to the front and truncate the batch to `size`."""
    alive = state["alive"]
    n = alive.shape[0]
    key = jnp.where(alive, jnp.int32(0), jnp.int32(1))
    _, perm = jax.lax.sort((key, jnp.arange(n, dtype=jnp.int32)),
                           num_keys=1, is_stable=True)
    perm = perm[:size]

    def take(x):
        return jax.tree.map(lambda a: a[perm], x)

    return {k: take(v) for k, v in state.items()}


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def trace(grid, lookup_fn, rays: Rays, refs_per_iter: int = 2,
          any_hit: bool = False, round_iters: int = 16,
          min_batch: int = 8192) -> Hits:
    """Round-based compacted wavefront trace (host-orchestrated).

    Marches `round_iters` lockstep iterations, scatters results, compacts
    the survivors into the next power-of-two batch, doubles the cap, and
    repeats until no ray is alive. Batch sizes are pow2-bucketed so each
    (size, cap) pair compiles once and is reused across frames.
    """
    n = rays.count
    state = _jit_init(grid, rays, lookup_fn)
    state = dict(state, steps=jnp.zeros((n,), jnp.int32))
    out = dict(
        best_t=jnp.full((n,), jnp.inf, jnp.float32),
        best_id=jnp.full((n,), -1, jnp.int32),
        best_u=jnp.zeros((n,), jnp.float32),
        best_v=jnp.zeros((n,), jnp.float32),
        steps=jnp.zeros((n,), jnp.int32),
    )
    import os
    import time
    debug = bool(os.environ.get("HAGRID_TRACE_DEBUG"))
    cap = round_iters
    max_cell_refs = int(jnp.max(grid.cell_starts[1:] - grid.cell_starts[:-1]))
    hard_cap = max_march_iters(grid.fine_dims, max_cell_refs, refs_per_iter)
    size = n
    rounds = 0
    while True:
        rounds += 1
        t0 = time.perf_counter() if debug else 0.0
        state, live, iters = _jit_segment(grid, state, lookup_fn,
                                          refs_per_iter, any_hit,
                                          min(cap, hard_cap))
        out = _jit_scatter(out, state)
        live = int(live)
        if debug:
            jax.block_until_ready(out["best_t"])
            print(f"[trace] size={size} cap={min(cap, hard_cap)} "
                  f"iters={int(iters)} live={live} "
                  f"dt={time.perf_counter() - t0:.3f}s", flush=True)
        if live == 0 or cap >= hard_cap:
            if live:
                import warnings
                warnings.warn(
                    f"wavefront.trace: safety cap {hard_cap} expired with "
                    f"{live} rays still marching — their hit records are "
                    f"partial (see ops/wavefront.last_trace_stats)")
            break
        new_size = min(max(_pow2_at_least(live), min_batch), size)
        if new_size < size:
            # Population still shrinking: keep rounds short so the batch
            # tracks the live count; grow the cap only once compaction
            # stalls (long rounds then amortize fixed costs).
            state = _jit_compact(state, new_size)
            size = new_size
        else:
            cap *= 2
    last_trace_stats["truncated_rays"] = live
    last_trace_stats["rounds"] = rounds
    # Mean marched steps per ray (SURVEY §5 metrics; the reference's
    # traversal-cost yardstick). Host read is free here: this
    # orchestrator already syncs per round.
    last_trace_stats["mean_steps"] = float(
        jax.device_get(out["steps"].sum())) / max(n, 1)
    found = out["best_id"] >= 0
    return Hits(tri_id=out["best_id"],
                t=jnp.where(found, out["best_t"], jnp.inf),
                u=out["best_u"], v=out["best_v"])
