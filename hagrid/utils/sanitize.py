"""Runtime sanitizers — the counterpart of the reference's
compute-sanitizer / cuda-memcheck debug runs (SURVEY.md §5: race
detection & sanitizers row).

The planning pipeline is pure XLA array code, so the failure modes that
matter here are the value-level ones: NaNs escaping the
planning math, out-of-bounds gather indices into the ref tables, and
budget bookkeeping going negative. `check_sweep_plan` replays the sweep
tracer's planning pipeline (plan -> items) under `jax.experimental.
checkify` with NaN + index + div checks enabled and then asserts the
item-stream invariants on the host. It is a debug tool (syncs to host;
never on the hot path): call it from tests or the CLI's --sanitize
flag when a trace looks wrong.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from ..core.types import Rays
from ..grid.packet import PacketGrid
from ..ops import sweep_trace as st


def check_sweep_plan(grid: PacketGrid, rays: Rays, tile: int = 512,
                     bmax: int = 4096) -> dict:
    """Checkified replay of one frame's planning. Raises on NaN /
    out-of-bounds / div-by-zero inside plan/items; asserts stream
    invariants; returns summary stats."""
    n = rays.count
    n_pad = -(-n // tile) * tile
    slab = max(d[0] for d in grid.dims3)
    xp_ext = st._pad_coherent(rays.org, rays.dir, rays.tmin, rays.tmax,
                              n_pad, tile)

    def planned(xp_ext, bbox_lo, bbox_hi, rs, rowinfo, planes):
        nt = xp_ext.shape[0] // tile - 1
        cs_tab, n_tab, lo_tab = st._tile_tabs(bbox_lo, bbox_hi,
                                              grid.dims3)
        per_ray, per_tile = st._precompute(
            xp_ext[:nt * tile], cs_tab, n_tab, lo_tab, bbox_lo,
            bbox_hi, tile, planes)
        traceable = xp_ext[:nt * tile, 13].reshape(nt, tile) > 0
        best0 = jnp.where(traceable, st._BIG, -st._BIG)
        starts, counts, thr = st._plan(
            per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo,
            per_tile["k0"], best0, grid.dims3, slab, False)
        dead_idx = grid.cols.shape[0] // st._U - 1
        gidx, tile_of, tminb, n_blocks, demand = st._items(
            starts, counts, thr, nt, slab, bmax, dead_idx)
        return starts, counts, gidx, tile_of, n_blocks, demand

    errs = (checkify.index_checks | checkify.nan_checks
            | checkify.div_checks)
    checked = checkify.checkify(planned, errors=errs)
    err, (starts, counts, gidx, tile_of, n_blocks,
          demand) = jax.jit(checked)(xp_ext, grid.bbox_lo, grid.bbox_hi,
                                     grid.rs, grid.rowinfo, grid.planes)
    err.throw()

    starts_h = np.asarray(starts)
    counts_h = np.asarray(counts)
    gidx_h = np.asarray(gidx)
    units = grid.cols.shape[0] // st._U
    assert (counts_h >= 0).all(), "negative range count"
    live = counts_h > 0
    assert (starts_h[live] >= 0).all(), "negative range start"
    assert (starts_h[live] + counts_h[live] <= units).all(), \
        "range past the cols table"
    assert (gidx_h >= 0).all() and (gidx_h < units).all(), \
        "gather unit index out of bounds"
    nb = int(jax.device_get(n_blocks))
    to = np.asarray(tile_of)
    nt = xp_ext.shape[0] // tile - 1
    assert (to[:nb] < nt).all(), "live block points at the dummy tile"
    assert (to[nb:] == nt).all(), "dead block not parked on dummy tile"
    return {
        "ranges": int(live.sum()),
        "units": int(counts_h.sum()),
        "blocks": nb,
        "demand_units": int(jax.device_get(demand)),
    }
