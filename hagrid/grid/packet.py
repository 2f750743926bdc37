"""Packet grid: slice-major acceleration structure for the sweep tracer.

The reference's traversal (src/traverse.cu) is one CUDA thread per ray
chasing per-ray gathers. This structure serves *coherent packet
traversal* instead (in the spirit of Wald et al.'s coherent grid
traversal): a tile of rays marches the grid slice by slice along its
dominant axis, the frustum's cross-section selects a small rect of cells
per slice, and the union of those cells' triangles is tested densely
against the whole tile — memory accesses become contiguous runs and every
intersection test a dense elementwise op. Divergence is handled by
binning rays by direction (and terminating early), not by per-lane
control flow.

This module builds the data the planned-sweep tracer (ops/sweep_trace.py)
consumes:

- cells of a uniform grid laid out **slice-major per major axis** `a`:
  linear index (va * Db + vb) * Dc + vc with (b, c) = ((a+1)%3, (a+2)%3),
  c fastest. A slice-rect row of cells, and therefore its refs, is then a
  contiguous run.
- `rs` i32[RS_cap]: RAGGED per-row column tables mapping (row, c) to
  the absolute ref index (into `cols`) of the first ref of the row at
  fine column >= c (layout offset a*R_cap folded into the value). A
  frustum rect's refs in a row are the contiguous span
  [rs[off + c0], rs[off + c1 + 1]) where `off` is the row's entry in
  `rowinfo`. Rows are ragged because of PER-ROW COLUMN REFINEMENT
  (the packet analog of the reference's per-cell second level,
  src/build.cu): each (k, j) row subdivides its Dc base columns by m in
  {1, 2, 4} chosen from the row's post-SAT ref count (the densest 1/8 of
  rows by rank get m=4, the next 1/4 m=2, gated on an absolute
  refs-per-cell need), so dense rows get finer column spans. Refs
  straddling fine-cell boundaries duplicate (bbox-conservative), growing
  `cols`. DEFAULT-OFF: on sponza_like (331k tris) it cut primary block
  demand only 1.04x, GREW AO wave demand 1.28x and inflated refs 1.66x:
  dense rows are dense along the row too, so a tighter column window
  still spans the same clutter while every straddling ref now costs two
  gathered slots. Kept behind build_packet(refine=True) (tested:
  tests/test_packet.py::test_refined_columns_union) — the same ragged
  rs/rowinfo plumbing is what a per-row SAH split would ride.
- `rowinfo` i32[sum_a Da*Db]: per-row packed (rs_offset | log2(m)<<28);
  the planners gather it once per rect row to locate and scale the
  row's column table.
- `cols` f32[3*R_cap/6 + 8, 128]: GROUP rows of 6 consecutive per-ref
  PRECOMPUTED intersection rows (20 floats each = 120 lanes + 8 zero
  pad). 4 group rows form the tracer's gather unit and 128 a 768-ref
  block. (The 128-lane rows were shaped for an accelerator that copies
  (8, 128) tiles; the Triton kernel loads each coefficient column with
  a gather instead, so another layout may read faster.) Per-ref row:
  [n(3) -e2(3) -(v0 x e2)(3) e1(3) (v0 x e1)(3) v0.n tri_id zeros(3)]
  in sorted order per layout. With x = (o, d, m = o x d) these make
  det, t*det, u*det, v*det LINEAR in x (scalar-triple identities), so
  Moller-Trumbore collapses from ~65 ops/pair to ~38:
    det' = d.n        (= -det_MT; all signs below absorb it)
    t    = (v0.n - o.n) / det'
    u    = (m.(-e2) + d.(-(v0 x e2))) / det'
    v    = (m.e1 + d.(v0 x e1)) / det'
  The tri id in column 16 is stored as a float *value* (exact for up to
  2^24 triangles) — NOT a bitcast bit pattern: ids below 2^23 are
  denormal bit patterns that float ops may flush to zero (every hit
  came back as tri 0). The trailing 8 zero group rows (48 refs, two
  gather units) are the DEAD gather target (det = 0 -> t = NaN, never
  hits) for padding slots.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Triangles, pytree_dataclass, static_field
from ..ops.segment import expand_by_counts, segment_starts, sort_pairs
from ..utils.config import density_dims
from .uniform import tri_box_overlap, tri_voxel_ranges

# X-matrix column layout (one row per ray, 16 columns):
#   [0]=1, [1:4]=org, [4:7]=dir, [7:10]=m = org x dir, [10:12]=0,
#   [12]=tmin, [13]=min(tmax, BIG), [14:16]=0.
X_COLS = 16
MT_COLS = 20  # precomputed per-ref intersection row width (see above)
REF_GROUP = 6  # per-ref rows per stored 128-lane group row
GROUP_LANES = 128  # group-row width: 6*20 = 120 real + 8 zero pad
DEAD_ROWS = 8  # trailing zero group rows (dead gather target, 48 refs)
BIG = 3e38  # finite stand-in for +inf throughout the packet pipeline

# Ids ride in f32 rows as exact float values; beyond 2^24 they would
# round. (The reference's largest headline scene is ~1.1M tris.)
MAX_TRIS = 1 << 24


@pytree_dataclass
class PacketGrid:
    # Per-layout grid dims, PERMUTED to (slice, row, col) order:
    # dims3[a] = (Da, Db, Dc) for major axis a with (b, c) = ((a+1)%3,
    # (a+2)%3). Layouts are independent grids: coarse along their slice
    # axis (few marched slices) and fine in cross-section (tight frustum
    # rects) — the packet analog of the reference's per-cell adaptivity.
    dims3: tuple = static_field()
    bbox_lo: jnp.ndarray  # f32[3]
    bbox_hi: jnp.ndarray  # f32[3]
    # Sweep-tracer tables (see module docstring).
    rs: jnp.ndarray
    cols: jnp.ndarray
    total_refs: jnp.ndarray   # i32[]: max SAT-surviving refs per layout
    total_pairs: jnp.ndarray  # i32[]: max pre-SAT (tri, cell) pairs --
    #                           the capacity-bound quantity
    tris: Triangles
    # Per-row packed (rs offset | log2(column multiplier) << 28) —
    # see module docstring. Uniform (refine=False) grids carry m=1
    # rows; the planners read rowinfo unconditionally.
    rowinfo: jnp.ndarray
    # Slice planes: planes[a, k] = k-th slice boundary of layout a
    # along its major axis, k = 0..Da (padded by repeating the last
    # boundary to the widest layout). Uniform by default; build_packet
    # (adaptive=True) places them by a tri-mass quantile histogram.
    # MEASURED (1024^2 primaries, plan-only demand): equal-mass planes
    # cost 4-7% MORE gathered refs on both Sponza and San Miguel —
    # thin slices in dense regions mean more ranges and more 32-ref
    # round-out than their tighter column spans save — so uniform
    # stays the default and the capability is kept for scenes with
    # extreme empty-space skew.
    planes: jnp.ndarray       # f32[3, max(Da) + 1]

    @property
    def ref_capacity(self) -> int:
        return (self.cols.shape[0] - DEAD_ROWS) // 3 * REF_GROUP

    @property
    def overflowed(self):
        """Device bool: per-layout pairs exceeded capacity (only possible
        when built with check=False); hits may then be missed."""
        return self.total_pairs > self.ref_capacity

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims3[0]))


def rays_to_x(org, dir, tmin, tmax):
    """Pack rays into the tracer's X matrix. f32[N, 16]."""
    n = org.shape[0]
    one = jnp.ones((n, 1), jnp.float32)
    m = jnp.cross(org, dir)
    z2 = jnp.zeros((n, 2), jnp.float32)
    tmax = jnp.minimum(tmax, BIG)
    return jnp.concatenate(
        [one, org, dir, m, z2, tmin[:, None], tmax[:, None], z2], axis=1)


def _axis_order(axis: int):
    return axis, (axis + 1) % 3, (axis + 2) % 3


def _slice_planes(tlo3, thi3, bbox_lo, bbox_hi, dims3, adaptive):
    """Per-layout slice boundaries (f32[3, max(Da)+1]), traced.

    Adaptive placement: 256-bin histogram of tri-bbox centroids along
    the axis -> CDF -> equal-mass quantiles, blended 3:1 with uniform
    spacing (the uniform component keeps planes strictly increasing
    even when all mass lands in one bin). Endpoints pin to the bbox."""
    pmax = max(d[0] for d in dims3) + 1
    centroid = 0.5 * (tlo3 + thi3)
    B = 256
    rows = []
    for axis in range(3):
        da = dims3[axis][0]
        lo_w = bbox_lo[axis]
        hi_w = bbox_hi[axis]
        uni = lo_w + (hi_w - lo_w) * jnp.arange(
            da + 1, dtype=jnp.float32) / da
        if adaptive and da > 1:
            cb = jnp.clip(((centroid[:, axis] - lo_w)
                           / (hi_w - lo_w) * B).astype(jnp.int32),
                          0, B - 1)
            cdf = jnp.cumsum(jnp.zeros((B,), jnp.float32).at[cb].add(1.0))
            ks = jnp.arange(1, da, dtype=jnp.float32)
            targets = cdf[-1] * ks / da
            idx = jnp.sum((cdf[None, :] < targets[:, None]).astype(
                jnp.int32), axis=1)
            c_lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
            c_hi = cdf[jnp.minimum(idx, B - 1)]
            frac = jnp.where(c_hi > c_lo,
                             (targets - c_lo) / jnp.maximum(
                                 c_hi - c_lo, 1e-20), 0.5)
            pos = lo_w + (idx.astype(jnp.float32) + frac) / B \
                * (hi_w - lo_w)
            row = jnp.concatenate([
                lo_w[None], 0.75 * pos + 0.25 * uni[1:-1], hi_w[None]])
        else:
            row = uni
        rows.append(jnp.pad(row, (0, pmax - da - 1), mode="edge"))
    return jnp.stack(rows)


@functools.partial(jax.jit, static_argnames=("dims3", "ref_capacity",
                                             "adaptive", "refine"))
def _build(tris: Triangles, bbox_lo, bbox_hi, dims3, ref_capacity,
           adaptive=True, refine=False):
    """Bin tris into each layout's (independent) grid and emit the
    sweep-tracer tables (rs spans + cols MT rows)."""
    n1 = max(tris.count, 1)
    tlo3, thi3 = tris.bounds()
    planes = _slice_planes(tlo3, thi3, bbox_lo, bbox_hi, dims3, adaptive)

    # Pass 1 (cheap per-tri math): per-layout voxel ranges packed into
    # 10-bit fields, expansion offsets, counts.
    lay = []
    for axis in range(3):
        a, b, c = _axis_order(axis)
        da, db, dc = dims3[axis]
        dims_xyz = [0, 0, 0]
        dims_xyz[a], dims_xyz[b], dims_xyz[c] = da, db, dc
        lo, hi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, tuple(dims_xyz))
        # Slice-axis binning against the (possibly non-uniform) plane
        # table: cell k spans [P_k, P_{k+1}); the interior-plane count
        # <= coordinate is its index. dims b/c stay uniform.
        P = planes[axis]
        if da > 1:
            va_lo = jnp.sum((tlo3[:, a:a + 1] >= P[None, 1:da]).astype(
                jnp.int32), axis=1)
            va_hi = jnp.sum((thi3[:, a:a + 1] >= P[None, 1:da]).astype(
                jnp.int32), axis=1)
            lo = lo.at[:, a].set(va_lo)
            hi = hi.at[:, a].set(va_hi)
        span = hi - lo + 1
        counts = span[:, 0] * span[:, 1] * span[:, 2]
        offsets = jnp.cumsum(counts) - counts
        total = offsets[-1] + counts[-1]
        p_lo = lo[:, 0] + (lo[:, 1] << 10) + (lo[:, 2] << 20)
        p_sp = span[:, 0] + (span[:, 1] << 10) + (span[:, 2] << 20)
        lay.append(dict(offsets=offsets, total=total, p_lo=p_lo,
                        p_sp=p_sp, dims_xyz=tuple(dims_xyz)))

    # One fused per-tri attribute row [v0 e1 e2 id 0*6]: the per-layout
    # ref tables then need ONE 64B-row gather each instead of three
    # narrow ones. Column 9 is the tri id as a float VALUE (see module
    # docstring).
    tri_t = jnp.concatenate(
        [tris.v0, tris.e1, tris.e2,
         jnp.arange(n1, dtype=jnp.int32).astype(jnp.float32)[:, None],
         jnp.zeros((n1, 6), jnp.float32)], axis=1)

    rs_parts = []
    rowinfo_parts = []
    cols_parts = []
    totals = []
    reals = []
    rs_base = 0
    for axis in range(3):
        a, b, c = _axis_order(axis)
        da, db, dc = dims3[axis]
        L = lay[axis]
        offsets = L["offsets"]
        total = L["total"]
        # Run-owner per output slot: +1 marker at every run start,
        # prefix sum (empty runs stack markers and telescope past).
        markers = jnp.zeros((ref_capacity,), jnp.int32).at[offsets].add(
            1, mode="drop")
        tri_idx = jnp.clip(jnp.cumsum(markers) - 1, 0, n1 - 1)
        j = jnp.arange(ref_capacity, dtype=jnp.int32)
        valid = j < total
        # Per-pair (offset, lo, span) WITHOUT a row gather: per-tri INT
        # fields constant within each expansion run forward-fill
        # exactly via a delta scatter at run starts + cumsum. The three
        # 10-bit voxel fields ride PACKED in one i32 each (dims cap at
        # 1023): integer addition carries borrows across fields
        # exactly, and every forward-filled value decodes to in-range
        # fields, so the packed cumsum equals the field-wise cumsum —
        # one (cap,) stream instead of a (cap, 6) one.
        def ff1(p, offsets=offsets):
            d = jnp.diff(p, prepend=jnp.zeros((1,), p.dtype))
            return jnp.cumsum(jnp.zeros(
                (ref_capacity,), jnp.int32).at[offsets].add(
                    d, mode="drop"))

        # rank = offset within the run: the current run's start is the
        # running max of marker positions (markers stack on one slot
        # for empty runs — same position, still correct), reusing the
        # markers scatter instead of forward-filling offsets.
        run_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(markers > 0, j, 0))
        rank = j - run_start
        lo_ff = ff1(L["p_lo"])
        sp_ff = ff1(L["p_sp"])
        s0 = sp_ff & 1023
        s1 = (sp_ff >> 10) & 1023
        dx = rank % s0
        rem = rank // s0
        dy = rem % s1
        dz = rem // s1
        v = jnp.stack([(lo_ff & 1023) + dx,
                       ((lo_ff >> 10) & 1023) + dy,
                       (lo_ff >> 20) + dz], axis=1)
        tvk = tri_t[tri_idx]        # one 64B-row gather: v0|e1|e2

        dims_xyz = L["dims_xyz"]
        num_cells = da * db * dc
        # Exact SAT pruning (reference parity: src/build.cu exact
        # overlap): drop (tri, cell) pairs whose triangle misses the
        # cell box. Cuts refs ~25-40%, which shrinks panels AND the
        # per-panel live lanes the tracer tests.
        csx = jnp.stack([(bbox_hi[0] - bbox_lo[0]) / dims_xyz[0],
                         (bbox_hi[1] - bbox_lo[1]) / dims_xyz[1],
                         (bbox_hi[2] - bbox_lo[2]) / dims_xyz[2]])
        cell_lo = bbox_lo[None, :] + v.astype(jnp.float32) * csx[None, :]
        cell_hi = cell_lo + csx[None, :]
        # Slice-axis box bounds from the plane table (tiny-table
        # gathers; dims b/c keep the uniform expressions above).
        P = planes[axis]
        pa0 = P[jnp.clip(v[:, a], 0, da)]
        pa1 = P[jnp.clip(v[:, a] + 1, 0, da)]
        cell_lo = cell_lo.at[:, a].set(pa0)
        cell_hi = cell_hi.at[:, a].set(pa1)
        tv0 = tvk[:, 0:3]           # from the payload gather above
        sat = tri_box_overlap(tv0, tv0 + tvk[:, 3:6],
                              tv0 + tvk[:, 6:9],
                              cell_lo, cell_hi)
        keep = valid & sat
        nrows = da * db
        if refine:
            rowk = jnp.where(keep, v[:, a] * db + v[:, b], 0)

            # Per-row column multiplier m in {1, 2, 4} (module
            # docstring): rank-exact fractions keep the fine-cell count
            # STATIC (the densest nrows//8 rows by post-SAT ref count
            # get m=4, the next nrows//4 m=2), gated on an absolute
            # refs-per-base-cell need so sparse scenes don't refine
            # rows that gain nothing.
            n4 = nrows // 8
            n2 = nrows // 4
            rcnt = jnp.zeros((nrows,), jnp.int32).at[rowk].add(
                keep.astype(jnp.int32))
            _, order = sort_pairs(-rcnt, jnp.arange(nrows, dtype=jnp.int32))
            rank_of = jnp.zeros((nrows,), jnp.int32).at[order].set(
                jnp.arange(nrows, dtype=jnp.int32))
            m_rank = jnp.where(rank_of < n4, 4,
                               jnp.where(rank_of < n4 + n2, 2, 1))
            m_need = jnp.where(rcnt >= 6 * dc, 4,
                               jnp.where(rcnt >= 2 * dc, 2, 1))
            m = jnp.minimum(m_rank, m_need)
            cells_cap = dc * (4 * n4 + 2 * n2 + (nrows - n4 - n2))
            nc_row = m * dc
            cell_off = jnp.cumsum(nc_row) - nc_row    # i32[nrows]

            # Fine column span of each base pair from the tri's
            # c-extent (already on hand in tvk — no new gather;
            # bbox-conservative, the SAT prune stays at base
            # resolution).
            mg = m[rowk]
            v0c = tvk[:, c]
            c1v = v0c + tvk[:, 3 + c]
            c2v = v0c + tvk[:, 6 + c]
            tminc = jnp.minimum(v0c, jnp.minimum(c1v, c2v))
            tmaxc = jnp.maximum(v0c, jnp.maximum(c1v, c2v))
            mgf = mg.astype(jnp.float32)
            icsf = mgf / csx[c]
            base0 = v[:, c] * mg
            f_lo = jnp.clip(
                ((tminc - bbox_lo[c]) * icsf).astype(jnp.int32),
                base0, base0 + mg - 1)
            f_hi = jnp.clip(
                ((tmaxc - bbox_lo[c]) * icsf).astype(jnp.int32),
                f_lo, base0 + mg - 1)
            fcnt = jnp.where(keep, f_hi - f_lo + 1, 0)

            # Expand base pairs into fine pairs (per-pair int fields
            # ride the same delta-scatter+cumsum forward fill as the
            # base expansion; ONE sort per layout, now over fine keys —
            # the base-key sort is gone).
            foffsets = jnp.cumsum(fcnt) - fcnt
            ftotal = foffsets[-1] + fcnt[-1]
            _, rank2, valid2, _ = expand_by_counts(fcnt, ref_capacity)

            def ff2(p, foffsets=foffsets):
                d = jnp.diff(p, prepend=jnp.zeros((1,), p.dtype))
                return jnp.cumsum(jnp.zeros(
                    (ref_capacity,), jnp.int32).at[foffsets].add(
                        d, mode="drop"))

            fstart = cell_off[rowk] + f_lo           # per base pair
            fkey = jnp.where(valid2, ff2(fstart) + rank2, cells_cap)
            skeys, srefs = sort_pairs(fkey, ff2(tri_idx))
            starts = segment_starts(skeys, cells_cap)  # i32[cc+1]
            live = jnp.arange(ref_capacity) < starts[cells_cap]

            # Ragged rs emission: row r's column table occupies
            # [row_off[r], row_off[r] + nc_row[r]] (incl. the closing
            # entry, which equals the next row's first start).
            rs_cap_ax = cells_cap + nrows
            row_off = jnp.cumsum(nc_row + 1) - (nc_row + 1)
            _, rankR, validR, _ = expand_by_counts(nc_row + 1, rs_cap_ax)
            d_co = jnp.diff(cell_off, prepend=jnp.zeros((1,), jnp.int32))
            co_ff = jnp.cumsum(jnp.zeros((rs_cap_ax,), jnp.int32).at[
                row_off].add(d_co, mode="drop"))
            cell_idx = jnp.clip(co_ff + rankR, 0, cells_cap)
            rs_parts.append(jnp.where(validR, starts[cell_idx],
                                      starts[cells_cap])
                            + axis * ref_capacity)
            lg = jnp.where(m == 4, 2, jnp.where(m == 2, 1, 0))
            rowinfo_parts.append((row_off + rs_base) | (lg << 28))
            rs_base += rs_cap_ax
            real_ax = starts[cells_cap]
            total_ax = jnp.maximum(total, ftotal)
        else:
            # Uniform fast path (the benched default): ONE sort over
            # base cell keys and the rs table is a reshape of the
            # segment starts — none of the fine-expansion forward-fill
            # chains above (their cost does not shrink at m=1). rowinfo
            # still describes the rows (m=1, (dc+1)
            # entries each) so the planners are branch-free.
            num_cells = da * db * dc
            key = (v[:, a] * db + v[:, b]) * dc + v[:, c]
            key = jnp.where(keep, key, num_cells)
            skeys, srefs = sort_pairs(key, jnp.where(keep, tri_idx, 0))
            starts = segment_starts(skeys, num_cells)  # i32[C+1]
            live = jnp.arange(ref_capacity) < starts[num_cells]
            row_start = starts[::dc]                  # i32[nrows + 1]
            s_log = jnp.concatenate(
                [starts[:num_cells].reshape(nrows, dc),
                 row_start[1:, None]], axis=1)        # i32[nrows, dc+1]
            rs_parts.append((s_log + axis * ref_capacity).reshape(-1))
            rowinfo_parts.append(
                jnp.arange(nrows, dtype=jnp.int32) * (dc + 1) + rs_base)
            rs_base += nrows * (dc + 1)
            real_ax = starts[num_cells]
            total_ax = total
        # Per-ref rows: ONE row gather from tri_t, then the precomputed
        # linear-form coefficients (module docstring) derived
        # elementwise — no extra gather.
        tk = tri_t[srefs]
        v0 = tk[:, 0:3]
        e1 = tk[:, 3:6]
        e2 = tk[:, 6:9]
        nrm = jnp.cross(e1, e2)
        row20 = jnp.concatenate(
            [nrm, -e2, -jnp.cross(v0, e2), e1, jnp.cross(v0, e1),
             jnp.sum(v0 * nrm, axis=1, keepdims=True), tk[:, 9:10],
             jnp.zeros((ref_capacity, 3), jnp.float32)], axis=1)
        grp = jnp.where(live[:, None], row20, 0.0).reshape(
            ref_capacity // REF_GROUP, MT_COLS * REF_GROUP)
        cols_parts.append(jnp.pad(
            grp, ((0, 0), (0, GROUP_LANES - MT_COLS * REF_GROUP))))
        # Capacity bound: BOTH the base AABB pair expansion and (when
        # refining) the fine-column expansion stream through
        # ref_capacity slots.
        totals.append(total_ax)
        reals.append(real_ax)             # SAT-surviving refs
    rs_all = jnp.concatenate(rs_parts)
    rowinfo_all = jnp.concatenate(rowinfo_parts)
    cols_all = jnp.concatenate(
        cols_parts + [jnp.zeros((DEAD_ROWS, GROUP_LANES), jnp.float32)])
    return (rs_all, rowinfo_all, cols_all,
            jnp.max(jnp.stack(totals)), jnp.max(jnp.stack(reals)),
            planes)


def build_packet(tris: Triangles, cross_density: float = 0.4,
                 slice_density: float = 0.02,
                 ref_capacity: int | None = None,
                 dims: tuple | None = None,
                 dims3: tuple | None = None,
                 bbox=None, check: bool = True,
                 adaptive: bool = False,
                 refine: bool = False) -> PacketGrid:
    """Host wrapper: static dims/capacity from the density heuristic,
    retry on overflow (same capacity policy as the other builders).

    Each layout gets an ANISOTROPIC grid: slice_density sets the (coarse)
    resolution along its march axis — few slices, each a thick slab —
    and cross_density the (fine) cross-section — tight frustum rects.
    `dims` forces one isotropic grid for all three layouts (tests);
    `dims3` forces exact per-layout dims (per-frame rebuilds).

    Per-frame rebuilds pass `bbox` (host floats) and `check=False` with a
    capacity sized by the first frame, so they run without a
    device->host read; overflow is then detectable via
    grid.overflowed."""
    if tris.count >= MAX_TRIS:
        raise ValueError(
            f"packet grid carries tri ids as f32 values, exact only "
            f"below {MAX_TRIS} tris (got {tris.count})")
    if dims3 is not None and max(max(d) for d in dims3) > 1023:
        raise ValueError("packet grid dims are capped at 1023 per axis "
                         "(voxel coords ride packed in 10-bit fields)")
    if tris.count == 0:
        d3 = ((1, 1, 1),) * 3
        # Empty rows: rs spans all empty (every boundary 0). One row
        # per layout, m=1: rowinfo = layout rs bases (2 slots each).
        return PacketGrid(dims3=d3, bbox_lo=jnp.zeros(3, jnp.float32),
                          bbox_hi=jnp.ones(3, jnp.float32),
                          rs=jnp.zeros((6,), jnp.int32),
                          rowinfo=jnp.array([0, 2, 4], jnp.int32),
                          cols=jnp.zeros(
                              (3 * 768 // REF_GROUP + DEAD_ROWS,
                               GROUP_LANES), jnp.float32),
                          total_refs=jnp.int32(0),
                          total_pairs=jnp.int32(0), tris=tris,
                          planes=jnp.broadcast_to(
                              jnp.array([0.0, 1.0]), (3, 2)))
    if bbox is not None:
        lo, hi = np.asarray(bbox[0], np.float32), np.asarray(bbox[1],
                                                             np.float32)
    else:
        tlo, thi = jax.device_get(tris.bounds())
        lo = tlo.min(0)
        hi = thi.max(0)
    pad = (hi - lo) * 1e-4 + 1e-4
    lo = lo - pad
    hi = hi + pad
    if dims3 is not None:
        pass
    elif dims is None:
        cross = [min(d, 1023) for d in
                 density_dims(hi - lo, tris.count, cross_density)]
        slab = [min(d, 1023) for d in
                density_dims(hi - lo, tris.count, slice_density)]
        dims3 = tuple(
            (slab[a], cross[(a + 1) % 3], cross[(a + 2) % 3])
            for a in range(3))
    else:
        dims3 = tuple(
            (dims[a], dims[(a + 1) % 3], dims[(a + 2) % 3])
            for a in range(3))
    rs_total = sum(da * db + dc * (da * db // 8 * 4 + da * db // 4 * 2
                                   + da * db - da * db // 8
                                   - da * db // 4)
                   for (da, db, dc) in dims3) if refine else \
        sum(da * db * (dc + 1) for (da, db, dc) in dims3)
    if rs_total >= (1 << 28):
        raise ValueError("rs table too large for rowinfo's 28-bit "
                         "offsets; reduce grid dims")
    if ref_capacity is None:
        ref_capacity = max(1536, int(tris.count * 2))
    # Round to 768 = lcm(block refs 6*128, unit refs 24): per-layout
    # offsets in rs then align to whole gather units and sweep blocks.
    ref_capacity = -(-ref_capacity // 768) * 768
    bbox_lo = jnp.asarray(lo, jnp.float32)
    bbox_hi = jnp.asarray(hi, jnp.float32)
    while True:
        rs, rowinfo, cols, pairs, total, planes = _build(
            tris, bbox_lo, bbox_hi, dims3, ref_capacity,
            adaptive=adaptive, refine=refine)
        if not check:
            break
        t = int(jax.device_get(pairs))
        if t <= ref_capacity:
            break
        ref_capacity = -(-int(t * 1.25) // 768) * 768
    return PacketGrid(dims3=dims3, bbox_lo=bbox_lo, bbox_hi=bbox_hi,
                      rs=rs, rowinfo=rowinfo, cols=cols,
                      total_refs=total, total_pairs=pairs, tris=tris,
                      planes=planes)
