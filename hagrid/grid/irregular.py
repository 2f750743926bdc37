"""Two-level irregular grid — the flagship acceleration structure.

Re-derivation of the reference build pipeline (src/build.cu top binning →
octree-style per-cell refinement; src/merge.cu SAH neighbor merging;
src/expand.cu greedy cell expansion) as jitted stages over
static-shape SoA arrays (SURVEY.md §3.2, §7). Key re-design decisions:

- The reference's multi-level octree `entries` encoding is flattened to a
  *two-level* table: each top cell stores a resolution log2 `r` and an
  offset into a per-cell block of (2^r)^3 leaf entries. Equivalent
  expressive power (per-cell power-of-two subdivision), but lookup is two
  dependent gathers instead of a variable-depth descent — better for a
  vector ISA.
- Construction never scatters with atomics: every "emit" is
  count → exclusive-scan → binary-search expansion → stable sort →
  segment boundaries (ops/segment.py).
- Merging uses randomized independent-set matching per pass (hash-parity)
  instead of the reference's serial even/odd sweeps: each cell proposes its
  +axis neighbor when the SAH test passes; proposals are accepted where the
  hash bits differ, which is conflict-free and fully parallel. The SAH test
  uses the |A|+|B| upper bound for the union size (conservative: merges no
  pair the reference would reject).
- Expansion grows a cell's int bbox into an *empty* neighbor cell that
  covers its whole cross-section (the dominant win of the paper's
  subset-expansion; ref-subset growth into non-empty neighbors can chain
  through repeated passes). Cell bboxes may then overlap the voxel map —
  ownership (entries) never changes, only the skip extents.

All capacities are static; the host wrapper reads back totals once and
retries with pow2-bucketed capacities on overflow (the static-shape
replacement for the reference MemManager).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Triangles, pytree_dataclass, static_field
from ..ops.segment import (expand_by_counts, exclusive_scan,
                           rows_to_segments, segment_starts, sort_pairs)
from ..utils.config import BuildParams, density_dims
from .uniform import linear_cell, tri_voxel_ranges

# SAH constants (cost = half_area * (C_TRAV + C_ISECT * n_refs)).
C_TRAV = 1.0
C_ISECT = 1.0


@pytree_dataclass
class IrregularGrid:
    top_dims: tuple = static_field()
    levels: int = static_field()  # max sub-res log2
    bbox_lo: jnp.ndarray    # f32[3]
    bbox_hi: jnp.ndarray    # f32[3]
    top_res_log: jnp.ndarray  # i32[Ct]
    top_offset: jnp.ndarray   # i32[Ct] — into entries
    entries: jnp.ndarray      # i32[E_cap] — leaf cell id per sub-voxel
    cell_min: jnp.ndarray     # i32[C_cap,3] — inclusive, fine coords
    cell_max: jnp.ndarray     # i32[C_cap,3]
    cell_starts: jnp.ndarray  # i32[C_cap+1]
    ref_ids: jnp.ndarray      # i32[R_cap]
    alive: jnp.ndarray        # bool[C_cap]
    num_entries: jnp.ndarray  # i32[]
    total_refs: jnp.ndarray   # i32[]
    tris: Triangles
    # Cells whose bbox was analytically pre-expanded past their owned
    # region (air cubes): excluded from merging, since merge adjacency
    # reasons about owned regions via bboxes.
    preexpanded: jnp.ndarray  # bool[C_cap]
    # Packed hot-path tables (built by _optimize; see ops/wavefront.py):
    # the lookup chain is squeezed to two row-gathers and each ref test
    # to one.
    top_info: jnp.ndarray     # i32[Ct] = offset << 3 | res_log
    erec: jnp.ndarray         # i32[E_cap, 8] = [cmin, cmax, start, end]
    ref_tris: jnp.ndarray     # f32[R_cap, 12] = [v0, e1, e2, id_bits, pad]
    is_packed: bool = static_field(default=True)

    @property
    def fine_dims(self) -> tuple:
        return tuple(d << self.levels for d in self.top_dims)

    def lookup(self, voxel: jnp.ndarray):
        """fine voxel i32[N,3] -> (cell i32[N], cmin i32[N,3], cmax)."""
        lv = self.levels
        top = voxel >> lv
        tidx = linear_cell(top[:, 0], top[:, 1], top[:, 2], self.top_dims)
        r = self.top_res_log[tidx]
        off = self.top_offset[tidx]
        local = (voxel & ((1 << lv) - 1)) >> (lv - r)[:, None]
        side = (1 << r).astype(jnp.int32)
        sub = (local[:, 2] * side + local[:, 1]) * side + local[:, 0]
        e = self.entries[off + sub]
        return e, self.cell_min[e], self.cell_max[e]

    def stats(self) -> dict:
        starts = np.asarray(self.cell_starts)
        alive = np.asarray(self.alive)
        counts = np.diff(starts)[: alive.shape[0]][alive]
        return dict(
            top_dims=self.top_dims, levels=self.levels,
            entries=int(self.num_entries), cells=int(alive.sum()),
            refs=int(self.total_refs),
            refs_per_cell_mean=float(counts.mean()) if counts.size else 0.0,
            refs_per_cell_max=int(counts.max()) if counts.size else 0,
            empty_cell_frac=float((counts == 0).mean()) if counts.size else 0,
        )


# --------------------------------------------------------------------------
# Stage 1+2: top-level binning and per-cell resolution selection.
# --------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("top_dims", "levels", "rt_cap"))
def _stage_top(tris, bbox_lo, bbox_hi, top_dims, levels, snd_density,
               ref_growth, rt_cap):
    """`levels` is the STRUCTURAL maximum (params.levels + 1): the
    density heuristic demands a resolution per cell and a ref-growth
    cap grants it — over-dense cells of small triangles get the extra
    refinement level (the reference's iterative subdivision deepens
    exactly where density stays high, src/build.cu), while cells of
    large triangles (foliage) are auto-coarsened because subdividing
    them multiplies refs without separating them."""
    lo, hi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, top_dims)
    span = hi - lo + 1
    counts = span[:, 0] * span[:, 1] * span[:, 2]
    tri_idx, rank, valid, total = expand_by_counts(counts, rt_cap)
    s = span[tri_idx]
    l = lo[tri_idx]
    dx = rank % s[:, 0]
    rem = rank // s[:, 0]
    dy = rem % s[:, 1]
    dz = rem // s[:, 1]
    cell = linear_cell(l[:, 0] + dx, l[:, 1] + dy, l[:, 2] + dz, top_dims)
    n_top = int(np.prod(top_dims))
    key = jnp.where(valid, cell, n_top)
    skeys, srefs = sort_pairs(key, jnp.where(valid, tri_idx, -1))
    top_starts = segment_starts(skeys, n_top)

    # Per-top-cell second-level resolution. Demand side: the density
    # heuristic side = cbrt(snd_density * n_c) rounded UP to a power of
    # two. Supply side: per-cell projected ref count at resolution r,
    #   refs(r) <= A3 s^3 + A2 s^2 + A1 s + n_c,  s = 2^(r - levels),
    # from each tri's fine-voxel span polynomial prod_i (a_i s + 1)
    # summed per cell; the cell takes the deepest demanded r whose
    # projected refs stay within ref_growth * n_c.
    n_c = jnp.diff(top_starts).astype(jnp.float32)
    side = jnp.cbrt(snd_density * n_c)
    res_d = jnp.ceil(jnp.log2(jnp.maximum(side, 1.0))).astype(jnp.int32)

    fine_dims = tuple(d << levels for d in top_dims)
    flo, fhi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, fine_dims)
    a = (fhi - flo + 1).astype(jnp.float32)
    tri_poly = jnp.stack(
        [a.sum(1),
         a[:, 0] * a[:, 1] + a[:, 0] * a[:, 2] + a[:, 1] * a[:, 2],
         a[:, 0] * a[:, 1] * a[:, 2]], axis=1)
    pv = jnp.where((skeys < n_top)[:, None],
                   tri_poly[jnp.maximum(srefs, 0)], 0.0)
    A = jnp.zeros((n_top + 1, 3), jnp.float32).at[
        jnp.minimum(skeys, n_top)].add(pv, mode="drop")
    A1, A2, A3 = A[:n_top, 0], A[:n_top, 1], A[:n_top, 2]
    # Small cells refine freely (a few hundred refs cost nothing and
    # tiny scenes — Cornell walls — would otherwise never subdivide);
    # the cap exists to stop the San-Miguel-style blowup where dense
    # cells of LARGE triangles multiply refs without separating them.
    budget = jnp.maximum(ref_growth * n_c, 512.0)
    res_cap = jnp.zeros_like(res_d)
    for r in range(1, levels + 1):
        sc = 2.0 ** (r - levels)
        proj = ((A3 * sc + A2) * sc + A1) * sc + n_c
        # refs(r) is monotone in r, so the running where keeps the
        # deepest affordable resolution.
        res_cap = jnp.where(proj <= budget, r, res_cap)
    res_log = jnp.clip(jnp.minimum(res_d, res_cap), 0, levels)
    sizes = jnp.int32(1) << (3 * res_log)
    offsets = exclusive_scan(sizes)
    e_total = offsets[-1] + sizes[-1]
    return top_starts, skeys, srefs, total, res_log, offsets, e_total


# --------------------------------------------------------------------------
# Stage 3+4: sub-voxel ref emission and initial leaf cells.
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("top_dims", "levels", "e_cap",
                                             "r2_cap"))
def _stage_cells(tris, bbox_lo, bbox_hi, top_cell_of_ref, top_refs,
                 res_log, offsets, e_total, top_dims, levels, e_cap, r2_cap):
    """Expand each (top cell, tri) ref into the tri's sub-voxels at the
    cell's resolution; one leaf cell per sub-voxel."""
    fine_dims = tuple(d << levels for d in top_dims)
    flo, fhi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, fine_dims)

    rt_cap = top_refs.shape[0]
    valid_ref = top_refs >= 0
    c = jnp.minimum(top_cell_of_ref, int(np.prod(top_dims)) - 1)
    t = jnp.maximum(top_refs, 0)
    r = res_log[c]
    shift = levels - r  # sub-voxel width log2, in fine voxels

    # Top cell's fine-coord origin.
    tdx, tdy, _ = top_dims
    cx = c % tdx
    rem = c // tdx
    cy = rem % tdy
    cz = rem // tdy
    cell_lo = jnp.stack([cx, cy, cz], -1) << levels

    # Tri's fine range clipped to the top cell, in sub-voxel coords.
    side = jnp.int32(1) << r
    lo_s = jnp.clip((flo[t] - cell_lo) >> shift[:, None], 0,
                    (side - 1)[:, None])
    hi_s = jnp.clip((fhi[t] - cell_lo) >> shift[:, None], 0,
                    (side - 1)[:, None])
    span = hi_s - lo_s + 1
    counts = jnp.where(valid_ref, span[:, 0] * span[:, 1] * span[:, 2], 0)

    ref_idx, rank, valid, total2 = expand_by_counts(counts, r2_cap)
    valid = valid & valid_ref[ref_idx]
    s = span[ref_idx]
    l = lo_s[ref_idx]
    dx = rank % s[:, 0]
    rem2 = rank // s[:, 0]
    dy = rem2 % s[:, 1]
    dz = rem2 // s[:, 1]
    lx = l[:, 0] + dx
    ly = l[:, 1] + dy
    lz = l[:, 2] + dz
    cc = ref_idx  # row into top-ref arrays
    side_e = side[cc]
    entry = offsets[c[cc]] + (lz * side_e + ly) * side_e + lx

    key = jnp.where(valid, entry, e_cap)
    tri_of = jnp.where(valid, top_refs[cc], -1)
    skeys, srefs = sort_pairs(key, tri_of)
    cell_starts = segment_starts(skeys, e_cap)

    # Initial cells: one per entry e < e_total; int bbox = sub-voxel extent.
    # Entry -> owning top cell via scatter+cumsum (see ops/segment.py).
    e = jnp.arange(e_cap, dtype=jnp.int32)
    markers = jnp.zeros((e_cap,), jnp.int32).at[offsets].add(1, mode="drop")
    owner = jnp.clip(jnp.cumsum(markers) - 1, 0, offsets.shape[0] - 1)
    local = e - offsets[owner]
    r_o = res_log[owner]
    side_o = jnp.int32(1) << r_o
    w = jnp.int32(1) << (levels - r_o)
    # side_o is a power of two: masks/shifts instead of div/mod (integer
    # division by a runtime value is a long instruction sequence).
    lx = local & (side_o - 1)
    rem3 = local >> r_o
    ly = rem3 & (side_o - 1)
    lz = rem3 >> r_o
    ox = owner % tdx
    rem4 = owner // tdx
    oy = rem4 % tdy
    oz = rem4 // tdy
    cmin = ((jnp.stack([ox, oy, oz], -1) << levels)
            + jnp.stack([lx, ly, lz], -1) * w[:, None])
    cmax = cmin + (w[:, None] - 1)
    alive = e < e_total
    cmin = jnp.where(alive[:, None], cmin, 0)
    cmax = jnp.where(alive[:, None], cmax, -1)
    entries_arr = e  # identity: entry e -> cell e
    return (entries_arr, cmin, cmax, cell_starts, srefs, alive, total2)


# --------------------------------------------------------------------------
# Stage 4.5: analytic air coalescing ("air octree").
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("top_dims", "levels",
                                             "air_levels", "c_cap"))
def _stage_airboxes(top_starts, offsets, cell_min, cell_max,
                    top_dims, levels, air_levels, c_cap):
    """Pre-expand empty TOP cells' bboxes to their largest aligned all-air
    cube of top cells.

    Rays cross open space one top cell at a time unless empty cells
    coalesce; pairwise merge passes do that in O(passes) doublings over
    millions of rows. But air coalescing needs no SAH and no ref work —
    it's a pure octree-reduction over the ~10^4 top cells: level-k cube is
    air iff its 8 level-(k-1) children are. Costs ~nothing and replaces
    most merge passes. Ownership (entries) is untouched — this is
    EXPANSION semantics (bbox ⊇ owned region over empty-owned voxels), so
    the traversal invariant holds; the touched cells are flagged and
    excluded from later merging.
    """
    tdx, tdy, tdz = top_dims
    n_c = jnp.diff(top_starts)
    air = (n_c == 0)
    # (z, y, x) occupancy volume, padded to multiples of 2^air_levels.
    pd = 1 << air_levels
    pdx = -(-tdx // pd) * pd
    pdy = -(-tdy // pd) * pd
    pdz = -(-tdz // pd) * pd
    vol = jnp.zeros((pdz, pdy, pdx), bool)
    vol = vol.at[:tdz, :tdy, :tdx].set(air.reshape(tdz, tdy, tdx))

    best_k = jnp.zeros((pdz, pdy, pdx), jnp.int32)
    cur = vol
    for k in range(1, air_levels + 1):
        s = cur.shape
        cur = cur.reshape(s[0] // 2, 2, s[1] // 2, 2, s[2] // 2, 2)
        cur = cur.all(axis=(1, 3, 5))  # level-k cube all air?
        up = jnp.repeat(jnp.repeat(jnp.repeat(
            cur, 2 ** k, 0), 2 ** k, 1), 2 ** k, 2)
        best_k = jnp.where(up, k, best_k)

    best_k = best_k[:tdz, :tdy, :tdx].reshape(-1)
    c = jnp.arange(tdx * tdy * tdz, dtype=jnp.int32)
    cx = c % tdx
    rem = c // tdx
    cy = rem % tdy
    cz = rem // tdy
    k = best_k
    coord = jnp.stack([cx, cy, cz], -1)
    base = (coord >> k[:, None]) << k[:, None]
    cube_min = base << levels
    cube_max = (((base + (1 << k[:, None])) << levels) - 1)
    # Clamp to real top dims (padded cubes never mark air, but edge cubes
    # can stick out when dims aren't multiples).
    fine_max = (jnp.asarray(top_dims, jnp.int32) << levels) - 1
    cube_max = jnp.minimum(cube_max, fine_max)

    rows = jnp.where(air & (k > 0), offsets[c], c_cap)  # air cell's entry
    cell_min = cell_min.at[rows].set(cube_min, mode="drop")
    cell_max = cell_max.at[rows].set(cube_max, mode="drop")
    preexp = jnp.zeros((c_cap,), bool).at[rows].set(True, mode="drop")
    return cell_min, cell_max, preexp


# --------------------------------------------------------------------------
# Stage 5: SAH neighbor merging (randomized independent-set matching).
# --------------------------------------------------------------------------

def _half_area(cmin, cmax, cs):
    """SAH half-area of a cell's int bbox in world units. cmin/cmax i32[...,3]
    inclusive; cs f32[3] fine-cell size."""
    e = (cmax - cmin + 1).astype(jnp.float32) * cs
    return e[..., 0] * (e[..., 1] + e[..., 2]) + e[..., 1] * e[..., 2]


def _hash_bit(x, salt):
    """Cheap deterministic per-cell hash bit for matching parity."""
    h = (x.astype(jnp.uint32) * jnp.uint32(2654435761)
         + jnp.uint32(salt) * jnp.uint32(40503))
    h = h ^ (h >> 16)
    return (h & 1).astype(jnp.bool_)


def _buddy_pass(grid: IrregularGrid, axis: int) -> IrregularGrid:
    """Cheap empty-only merge pass: aligned equal-size empty buddies
    coalesce (conflict-free, see _merge_pass) WITHOUT any ref-array work —
    absorbed cells are empty, so cell_starts stays valid as-is. Costs a
    probe lookup + scatters; no device-wide sort."""
    c_cap = grid.cell_min.shape[0]
    fine = jnp.asarray(grid.fine_dims, jnp.int32)
    alive = grid.alive
    cmin = grid.cell_min
    cmax = grid.cell_max
    starts = grid.cell_starts
    n_refs = (starts[1:] - starts[:-1])[:c_cap]

    probe = cmin.at[:, axis].set(cmax[:, axis] + 1)
    in_b = probe[:, axis] < fine[axis]
    probe = jnp.clip(probe, 0, fine - 1)
    j, jmin, jmax = grid.lookup(probe)

    oa = [a for a in range(3) if a != axis]
    box_pair = ((jmin[:, axis] == cmax[:, axis] + 1)
                & (jmin[:, oa[0]] == cmin[:, oa[0]])
                & (jmax[:, oa[0]] == cmax[:, oa[0]])
                & (jmin[:, oa[1]] == cmin[:, oa[1]])
                & (jmax[:, oa[1]] == cmax[:, oa[1]]))
    w_i = cmax[:, axis] - cmin[:, axis] + 1
    w_j = jmax[:, axis] - jmin[:, axis] + 1
    buddy = (w_i == w_j) & ((cmin[:, axis] & (2 * w_i - 1)) == 0)
    accept = (alive & in_b & alive[j] & box_pair & buddy
              & (n_refs == 0) & (n_refs[j] == 0)
              & ~grid.preexpanded & ~grid.preexpanded[j])

    i_idx = jnp.arange(c_cap, dtype=jnp.int32)
    merge_map = i_idx.at[jnp.where(accept, j, c_cap)].set(i_idx, mode="drop")
    new_alive = alive & (merge_map == i_idx)
    new_cmax = jnp.where(accept[:, None], jnp.maximum(cmax, jmax), cmax)
    return dataclasses.replace(grid, entries=merge_map[grid.entries],
                               cell_max=new_cmax, alive=new_alive)


def _merge_pass(grid: IrregularGrid, salt, axis: int,
                alpha: float) -> IrregularGrid:
    """One merge pass along `axis`: each alive cell proposes its +axis
    neighbor if the pair tiles a box and the SAH cost of the union beats
    alpha * (sum of parts). Accepted where hash parity allows; absorbed
    cells die, entries are repointed, ref lists deduped."""
    c_cap = grid.cell_min.shape[0]
    fine = jnp.asarray(grid.fine_dims, jnp.int32)
    cs = (grid.bbox_hi - grid.bbox_lo) / fine.astype(jnp.float32)
    alive = grid.alive
    cmin = grid.cell_min
    cmax = grid.cell_max
    starts = grid.cell_starts
    n_refs = (starts[1:] - starts[:-1])[:c_cap]

    # Probe the voxel just past cmax on `axis`, at the cmin corner.
    probe = cmin.at[:, axis].set(cmax[:, axis] + 1)
    in_b = probe[:, axis] < fine[axis]
    probe = jnp.clip(probe, 0, fine - 1)
    j, jmin, jmax = grid.lookup(probe)

    oa = [a for a in range(3) if a != axis]
    box_pair = ((jmin[:, axis] == cmax[:, axis] + 1)
                & (jmin[:, oa[0]] == cmin[:, oa[0]])
                & (jmax[:, oa[0]] == cmax[:, oa[0]])
                & (jmin[:, oa[1]] == cmin[:, oa[1]])
                & (jmax[:, oa[1]] == cmax[:, oa[1]]))
    # Pre-expanded (air-cube) cells: bbox != owned region, so bbox-based
    # adjacency reasoning is invalid for them — never merge those.
    cand = (alive & in_b & alive[j] & box_pair
            & ~grid.preexpanded & ~grid.preexpanded[j])

    # SAH with |A|+|B| union upper bound.
    umin = jnp.minimum(cmin, jmin)
    umax = jnp.maximum(cmax, jmax)
    cost_a = _half_area(cmin, cmax, cs) * (C_TRAV + C_ISECT * n_refs)
    cost_b = _half_area(jmin, jmax, cs) * (C_TRAV + C_ISECT * n_refs[j])
    cost_u = _half_area(umin, umax, cs) * (
        C_TRAV + C_ISECT * (n_refs + n_refs[j]))
    sah_ok = cost_u <= alpha * (cost_a + cost_b)

    # Empty cells merge ONLY with aligned equal-size empty "buddies"
    # (octree-style doubling). Unrestricted SAH always accepts empty-empty
    # unions, which greedily elongates air cells along the first merge
    # axis; the resulting wide-thin slabs no longer share cross-sections,
    # so later axes can't merge and rays step through one thin layer at a
    # time. Buddy doubling keeps air isotropic and coalesces it
    # exponentially across passes. Buddy pairs need no matching parity:
    # the left buddy ((cmin & (2w-1)) == 0) is unique and a right buddy
    # can never itself initiate, so accepts are conflict-free — hash
    # parity would randomly reject 3/4 of them per pass and stall the
    # doubling. SAH merges (non-empty pairs) keep the randomized parity.
    empty_i = n_refs == 0
    empty_j = n_refs[j] == 0
    w_i = cmax[:, axis] - cmin[:, axis] + 1
    w_j = jmax[:, axis] - jmin[:, axis] + 1
    buddy = (w_i == w_j) & ((cmin[:, axis] & (2 * w_i - 1)) == 0)

    i_idx = jnp.arange(c_cap, dtype=jnp.int32)
    parity = ~_hash_bit(i_idx, salt) & _hash_bit(j, salt)
    accept_sah = cand & ~empty_i & ~empty_j & sah_ok & parity
    accept_buddy = cand & empty_i & empty_j & buddy
    accept = accept_sah | accept_buddy

    # Absorb j into i: map[j] = i (j dies), bbox grows, refs concatenated.
    # j's matching left neighbor is unique (cells tile space), and the hash
    # parity forbids a cell being absorber and absorbed at once, so the
    # scatter below has no duplicate target indices.
    merge_map = i_idx.at[jnp.where(accept, j, c_cap)].set(i_idx, mode="drop")
    new_alive = alive & (merge_map == i_idx)
    new_cmax = jnp.where(accept[:, None], jnp.maximum(cmax, jmax), cmax)
    new_cmin = jnp.where(accept[:, None], jnp.minimum(cmin, jmin), cmin)

    # Re-key every ref to its (possibly merged) owner, sort, dedup.
    r_cap = grid.ref_ids.shape[0]
    rrow = jnp.arange(r_cap, dtype=jnp.int32)
    owner = rows_to_segments(starts, r_cap)
    valid = (rrow < grid.total_refs) & (grid.ref_ids >= 0)
    new_owner = merge_map[owner]
    key = jnp.where(valid, new_owner, c_cap)
    # Two-key sort (owner, tri) so duplicates are adjacent.
    skeys, srefs = jax.lax.sort(
        (key, jnp.where(valid, grid.ref_ids, jnp.int32(2 ** 30))),
        num_keys=2, is_stable=True)
    prev_k = jnp.roll(skeys, 1)
    prev_r = jnp.roll(srefs, 1)
    first = rrow == 0
    dup = ~first & (skeys == prev_k) & (srefs == prev_r)
    keep = (skeys < c_cap) & ~dup
    # Compact: stable sort by (!keep) then re-key.
    ckey = jnp.where(keep, skeys, c_cap)
    ck, cr = jax.lax.sort((ckey, jnp.where(keep, srefs, -1)), num_keys=1,
                          is_stable=True)
    new_starts = segment_starts(ck, c_cap)
    new_total = jnp.sum(keep.astype(jnp.int32))

    new_entries = merge_map[grid.entries]
    return dataclasses.replace(
        grid, entries=new_entries, cell_min=new_cmin, cell_max=new_cmax,
        cell_starts=new_starts, ref_ids=cr, alive=new_alive,
        total_refs=new_total)


# --------------------------------------------------------------------------
# Stage 6: greedy cell expansion into empty neighbors.
# --------------------------------------------------------------------------

def _subset_test(grid: IrregularGrid, n_refs, jp, jm, candp, candm):
    """For candidate pairs (A, B=jp[A]) and (A, B=jm[A]), decide
    refs(B) ⊆ refs(A), fully vectorized (no per-pair loops):

    emit each pair's B-refs as QUERY rows and each A's own refs as DATA
    rows, sort all rows by (cell A, ref, tag) with data tags first, and
    mark a query matched when a data row with the same (A, ref) precedes
    it in its group (groups have <= 3 rows: 1 data + 2 directions, so
    two shifted propagation steps suffice). A pair passes when all its
    nB queries matched. Capacity overflow drops rows, which can only
    suppress expansions (conservative)."""
    c_cap = n_refs.shape[0]
    r_cap = grid.ref_ids.shape[0]
    starts = grid.cell_starts

    need = candp | candm
    di, dr, dv, _ = expand_by_counts(jnp.where(need, n_refs, 0), r_cap)
    ref_d = grid.ref_ids[starts[di] + dr]

    def qrows(j, cand):
        n_b = jnp.where(cand, n_refs[j], 0)
        qi, qr, qv, _ = expand_by_counts(n_b, r_cap)
        refq = grid.ref_ids[starts[j[qi]] + qr]
        return qi, refq, qv, n_b

    qi_p, ref_p, qv_p, n_bp = qrows(jp, candp)
    qi_m, ref_m, qv_m, n_bm = qrows(jm, candm)

    cell = jnp.concatenate([jnp.where(dv, di, c_cap),
                            jnp.where(qv_p, qi_p, c_cap),
                            jnp.where(qv_m, qi_m, c_cap)])
    key = jnp.concatenate([ref_d * 4, ref_p * 4 + 1, ref_m * 4 + 2])
    s_cell, s_key = jax.lax.sort((cell, jnp.where(cell < c_cap, key, 0)),
                                 num_keys=2)
    tag = s_key & 3
    ref = s_key >> 2
    same = ((s_cell == jnp.roll(s_cell, 1))
            & (ref == jnp.roll(ref, 1))).at[0].set(False)
    has_data = tag == 0
    for _ in range(2):
        has_data = has_data | (same & jnp.roll(has_data, 1))
    live = s_cell < c_cap
    hits_p = (has_data & (tag == 1) & live).astype(jnp.int32)
    hits_m = (has_data & (tag == 2) & live).astype(jnp.int32)
    cm_p = jnp.zeros((c_cap + 1,), jnp.int32).at[s_cell].add(
        hits_p, mode="drop")[:c_cap]
    cm_m = jnp.zeros((c_cap + 1,), jnp.int32).at[s_cell].add(
        hits_m, mode="drop")[:c_cap]
    return candp & (cm_p == n_bp), candm & (cm_m == n_bm)


def _expand_pass(grid: IrregularGrid, axis: int,
                 subset: bool = False) -> IrregularGrid:
    """Grow each alive cell's bbox along +axis and -axis into a neighbor
    cell that covers the full cross-section and is either EMPTY or
    (subset=True) carries a ref list that is a SUBSET of the cell's own
    (the full test of reference src/expand.cu). Safe transitively: a
    neighbor's own expanded territory only covers cells whose refs are
    subsets of its refs, hence of ours. Repeated passes chain."""
    c_cap = grid.cell_min.shape[0]
    fine = jnp.asarray(grid.fine_dims, jnp.int32)
    starts = grid.cell_starts
    n_refs = (starts[1:] - starts[:-1])[:c_cap]
    oa = [a for a in range(3) if a != axis]
    cmin, cmax = grid.cell_min, grid.cell_max

    def probe_dir(direction):
        """(neighbor id, its bbox, geometric acceptability) per cell.
        Both directions read the ORIGINAL bbox: growth along `axis`
        never changes the cross-section the covers test uses, so the
        directions are independent."""
        if direction > 0:
            probe = cmin.at[:, axis].set(cmax[:, axis] + 1)
            in_b = probe[:, axis] < fine[axis]
        else:
            probe = cmin.at[:, axis].set(cmin[:, axis] - 1)
            in_b = probe[:, axis] >= 0
        probe_c = jnp.clip(probe, 0, fine - 1)
        j, jmin, jmax = grid.lookup(probe_c)
        covers = ((jmin[:, oa[0]] <= cmin[:, oa[0]])
                  & (jmax[:, oa[0]] >= cmax[:, oa[0]])
                  & (jmin[:, oa[1]] <= cmin[:, oa[1]])
                  & (jmax[:, oa[1]] >= cmax[:, oa[1]]))
        base = grid.alive & in_b & covers & (j != jnp.arange(
            c_cap, dtype=jnp.int32))
        return j, jmin, jmax, base

    jp, _, jmax_p, base_p = probe_dir(+1)
    jm, jmin_m, _, base_m = probe_dir(-1)
    ok_p = base_p & (n_refs[jp] == 0)
    ok_m = base_m & (n_refs[jm] == 0)
    if subset:
        cand_p = base_p & (n_refs[jp] > 0) & (n_refs[jp] <= n_refs)
        cand_m = base_m & (n_refs[jm] > 0) & (n_refs[jm] <= n_refs)
        sub_p, sub_m = _subset_test(grid, n_refs, jp, jm, cand_p, cand_m)
        ok_p = ok_p | sub_p
        ok_m = ok_m | sub_m
    cmax = cmax.at[:, axis].set(
        jnp.where(ok_p, jmax_p[:, axis], cmax[:, axis]))
    cmin = cmin.at[:, axis].set(
        jnp.where(ok_m, jmin_m[:, axis], cmin[:, axis]))
    return dataclasses.replace(grid, cell_min=cmin, cell_max=cmax)


# --------------------------------------------------------------------------
# Host build wrapper.
# --------------------------------------------------------------------------

def _bucket(n: int, lo: int = 1024) -> int:
    """Round capacity up to a coarse bucket (25% steps, multiples of 256)
    so per-frame rebuilds reuse compilations without pow2's up-to-2x
    memory slop. Multiple-of-256 keeps quad-row reshapes exact."""
    b = lo
    while b < n:
        b += max(b // 4 // 256 * 256, lo)
    return b


def build_irregular(tris: Triangles, params: BuildParams | None = None,
                    top_dims: tuple | None = None) -> IrregularGrid:
    params = params or BuildParams()
    # The packed lookup encodes top_info = offset << 3 | res_log: res_log
    # (clamped to the structural max params.levels + 1) must fit in 3
    # bits or the table silently corrupts. Validate here so every entry
    # point (CLI included) is safe.
    if not 0 <= params.levels <= 6:
        raise ValueError(f"BuildParams.levels must be in [0, 6], "
                         f"got {params.levels}")
    if tris.count == 0:
        # Degenerate but legal: one empty unit-box cell, every ray misses.
        return IrregularGrid(
            top_dims=(1, 1, 1), levels=0,
            bbox_lo=jnp.zeros(3, jnp.float32),
            bbox_hi=jnp.ones(3, jnp.float32),
            top_res_log=jnp.zeros(1, jnp.int32),
            top_offset=jnp.zeros(1, jnp.int32),
            entries=jnp.zeros(1, jnp.int32),
            cell_min=jnp.zeros((1, 3), jnp.int32),
            cell_max=jnp.zeros((1, 3), jnp.int32),
            cell_starts=jnp.zeros(2, jnp.int32),
            ref_ids=jnp.full(1, -1, jnp.int32),
            alive=jnp.ones(1, bool),
            num_entries=jnp.int32(1), total_refs=jnp.int32(0), tris=tris,
            preexpanded=jnp.zeros(1, bool),
            top_info=jnp.zeros(1, jnp.int32),
            erec=jnp.asarray([[0, 0, 0, 0, 0, 0, 0, 0]], jnp.int32),
            ref_tris=jnp.zeros((1, 12), jnp.float32))
    tlo, thi = jax.device_get(tris.bounds())
    lo = tlo.min(0)
    hi = thi.max(0)
    pad = (hi - lo) * 1e-4 + 1e-4
    lo = lo - pad
    hi = hi + pad
    n = tris.count
    if top_dims is None:
        top_dims = density_dims(hi - lo, n, params.top_density)
    # Structural max res: one level beyond the density default, granted
    # per cell only where the ref-growth cap allows (see _stage_top).
    levels = params.levels + 1
    bbox_lo = jnp.asarray(lo, jnp.float32)
    bbox_hi = jnp.asarray(hi, jnp.float32)

    import os
    import time
    debug = bool(os.environ.get("HAGRID_BUILD_DEBUG"))

    t0 = time.perf_counter()
    rt_cap = _bucket(int(n * 2.5 * params.ref_slack))
    while True:
        (top_starts, top_keys, top_refs, rt_total, res_log, offsets,
         e_total) = _stage_top(tris, bbox_lo, bbox_hi, top_dims, levels,
                               params.snd_density, params.ref_growth,
                               rt_cap)
        t = int(jax.device_get(rt_total))
        if t <= rt_cap:
            break
        rt_cap = _bucket(int(t * 1.25))
    if debug:
        print(f"[build] stage_top: {(time.perf_counter() - t0) * 1e3:.1f} ms"
              f" (refs {t}/{rt_cap})", flush=True)

    t0 = time.perf_counter()
    e_cap = _bucket(int(jax.device_get(e_total)) + 1)
    r2_cap = _bucket(int(t * 3.0 * params.ref_slack))
    while True:
        (entries, cmin, cmax, cell_starts, refs, alive,
         r2_total) = _stage_cells(tris, bbox_lo, bbox_hi, top_keys, top_refs,
                                  res_log, offsets, e_total, top_dims,
                                  levels, e_cap, r2_cap)
        t2 = int(jax.device_get(r2_total))
        if t2 <= r2_cap:
            break
        r2_cap = _bucket(int(t2 * 1.25))
    if debug:
        print(f"[build] stage_cells: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"(refs {t2}/{r2_cap}, entries {int(jax.device_get(e_total))}"
              f"/{e_cap})", flush=True)

    cmin, cmax, preexp = _stage_airboxes(
        top_starts, offsets, cmin, cmax, top_dims, levels,
        params.air_levels, e_cap)
    if debug:
        print("[build] airboxes done", flush=True)

    n_top = int(np.prod(top_dims))
    grid = IrregularGrid(
        top_dims=top_dims, levels=levels, bbox_lo=bbox_lo, bbox_hi=bbox_hi,
        top_res_log=res_log, top_offset=offsets, entries=entries,
        cell_min=cmin, cell_max=cmax, cell_starts=cell_starts, ref_ids=refs,
        alive=alive, num_entries=e_total, total_refs=r2_total, tris=tris,
        preexpanded=preexp,
        top_info=jnp.zeros((n_top,), jnp.int32),
        erec=jnp.zeros((e_cap, 8), jnp.int32),
        ref_tris=jnp.zeros((r2_cap, 12), jnp.float32))

    grid = _optimize(grid, params)
    return grid


def compact_cells(grid: IrregularGrid, cell_capacity: int) -> IrregularGrid:
    """Voxel-map compression (reference src/compress.cu counterpart):
    renumber alive cells densely and shrink the per-cell tables to
    ``cell_capacity`` rows, repointing entries. Merging kills ~half the
    initial cells; compaction reclaims their rows. Relative cell order is
    preserved, so ref_ids stay sorted by owner and cell_starts is just a
    gather of the old boundaries.
    """
    from ..ops.segment import compact_indices

    alive = grid.alive
    c_cap = alive.shape[0]
    order = jnp.cumsum(alive.astype(jnp.int32)) - 1  # dense id per cell
    new_id = jnp.where(alive, order, -1)
    perm, n_alive = compact_indices(alive)
    take = perm[:cell_capacity]
    row = jnp.arange(cell_capacity, dtype=jnp.int32)
    live = row < n_alive
    # end(new k) = start(new k+1): empty dead segments between alive cells
    # make consecutive alive starts meet, so a plain gather is enough.
    starts_new = jnp.where(live, grid.cell_starts[take], grid.total_refs)
    starts_full = jnp.concatenate(
        [starts_new, grid.total_refs.reshape(1)]).astype(jnp.int32)
    return dataclasses.replace(
        grid,
        entries=new_id[grid.entries],
        cell_min=jnp.where(live[:, None], grid.cell_min[take], 0),
        cell_max=jnp.where(live[:, None], grid.cell_max[take], -1),
        cell_starts=starts_full,
        alive=live,
        preexpanded=live & grid.preexpanded[take],
    )


def _pack_tables(grid: IrregularGrid) -> IrregularGrid:
    """Build the packed hot-path tables from the canonical arrays."""
    top_info = (grid.top_offset << 3) | grid.top_res_log
    cell = grid.entries
    starts = grid.cell_starts
    erec = jnp.concatenate([
        grid.cell_min[cell], grid.cell_max[cell],
        starts[cell][:, None], starts[cell + 1][:, None]], axis=1)
    tid = jnp.maximum(grid.ref_ids, 0)
    tris = grid.tris
    if tris.count == 0:  # degenerate empty scene: no rows to gather
        ref_tris = jnp.zeros((tid.shape[0], 12), jnp.float32)
    else:
        # Id as float VALUE (exact below 2^24 tris) — bit patterns of
        # small ids are denormals that float ops flush to zero.
        idb = grid.ref_ids.astype(jnp.float32)
        pad = jnp.zeros((tid.shape[0], 2), jnp.float32)
        ref_tris = jnp.concatenate([
            tris.v0[tid], tris.e1[tid], tris.e2[tid], idb[:, None], pad],
            axis=1)
    return dataclasses.replace(grid, top_info=top_info, erec=erec,
                               ref_tris=ref_tris)


# Per-pass jits: one compile per axis (shapes identical across passes;
# salt is traced), instead of one 18-pass megagraph that takes minutes to
# compile. Merge/expand dispatch overhead is negligible next to the sorts.
_buddy_jit = jax.jit(_buddy_pass, static_argnames=("axis",))
_merge_jit = jax.jit(_merge_pass, static_argnames=("axis", "alpha"))
_expand_jit = jax.jit(_expand_pass, static_argnames=("axis", "subset"))
_pack_jit = jax.jit(_pack_tables)
_compact_jit = jax.jit(compact_cells, static_argnames=("cell_capacity",))


def _optimize(grid: IrregularGrid, params: BuildParams) -> IrregularGrid:
    import os
    import time

    debug = bool(os.environ.get("HAGRID_BUILD_DEBUG"))

    def step(name, fn, *a, block=None, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if debug:
            jax.block_until_ready(block(out) if block else out)
            print(f"[build] {name}: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        return out

    # Cheap empty-buddy coalescing first (no ref work), then SAH merges.
    for p in range(params.buddy_passes):
        for axis in range(3):
            grid = step(f"buddy p{p} ax{axis}", _buddy_jit, grid, axis=axis)
    for p in range(params.merge_passes):
        for axis in range(3):
            grid = step(f"merge p{p} ax{axis}", _merge_jit, grid,
                        jnp.int32(p * 3 + axis + 1), axis=axis,
                        alpha=float(params.alpha))
    # Compact before expansion: merging kills ~half the cells, and every
    # expansion pass scans all cell rows.
    if params.compact:
        n_alive = int(jax.device_get(jnp.sum(grid.alive.astype(jnp.int32))))
        grid = step("compact", _compact_jit, grid,
                    cell_capacity=_bucket(n_alive))
    for p in range(params.expansion_passes):
        for axis in range(3):
            # The sort-backed subset test is ~3 device sorts per axis;
            # one pass of it captures almost all non-empty growth
            # (chains continue through the cheap empty rule).
            grid = step(f"expand p{p} ax{axis}", _expand_jit, grid,
                        axis=axis,
                        subset=params.subset_expansion and p == 0)
    grid = step("pack", _pack_jit, grid)
    return grid


# --------------------------------------------------------------------------
# Traversal wrappers.
# --------------------------------------------------------------------------

def irregular_lookup(grid: IrregularGrid, voxel):
    """Grid-protocol lookup for the wavefront tracer."""
    return grid.lookup(voxel)


def trace_irregular_fast(grid: IrregularGrid, rays, any_hit: bool = False):
    """Compacted round-based wavefront trace (host-orchestrated)."""
    from ..ops import wavefront

    return wavefront.trace(grid, irregular_lookup, rays, any_hit=any_hit)


@functools.partial(jax.jit, static_argnames=("refs_per_iter", "any_hit"))
def trace_irregular(grid: IrregularGrid, rays, refs_per_iter: int = 8,
                    any_hit: bool = False):
    from ..ops.wavefront import trace_wavefront

    return trace_wavefront(rays, grid.tris, grid.lookup, grid.cell_starts,
                           grid.ref_ids, grid.bbox_lo, grid.bbox_hi,
                           grid.fine_dims, refs_per_iter=refs_per_iter,
                           any_hit=any_hit)
