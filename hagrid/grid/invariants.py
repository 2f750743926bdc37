"""Structural invariant checks over built grids (host-side, for tests).

The reference validates by golden images only; we additionally assert the
invariants that make traversal correct (SURVEY.md §4.2): conservative
completeness (every tri overlapping a cell is in that cell's ref list),
monotone segment bounds, in-range ref ids.
"""

from __future__ import annotations

import numpy as np

from .irregular import IrregularGrid
from .uniform import UniformGrid, tri_voxel_ranges


def check_uniform(grid: UniformGrid) -> None:
    starts = np.asarray(grid.cell_starts)
    refs = np.asarray(grid.ref_ids)
    total = int(grid.total_refs)
    n_tris = grid.tris.count
    assert total <= refs.shape[0], "ref buffer overflow"
    assert starts[0] == 0 and starts[-1] == total
    assert np.all(np.diff(starts) >= 0), "cell_starts not monotone"
    assert np.all(refs[:total] >= 0) and np.all(refs[:total] < n_tris)
    assert np.all(refs[total:] == -1)

    # Conservative completeness: recompute each tri's voxel range and check
    # membership in every overlapped cell's segment.
    lo, hi = (np.asarray(x) for x in tri_voxel_ranges(
        grid.tris, grid.bbox_lo, grid.bbox_hi, grid.dims))
    dx, dy, _ = grid.dims
    cell_sets = {}
    for c in range(grid.num_cells):
        seg = refs[starts[c]:starts[c + 1]]
        cell_sets[c] = set(seg.tolist())
        assert np.all(np.diff(seg) > 0) or len(seg) <= 1, \
            f"cell {c} refs not sorted/unique"
    for t in range(n_tris):
        for z in range(lo[t, 2], hi[t, 2] + 1):
            for y in range(lo[t, 1], hi[t, 1] + 1):
                for x in range(lo[t, 0], hi[t, 0] + 1):
                    c = (z * dy + y) * dx + x
                    assert t in cell_sets[c], \
                        f"tri {t} missing from cell {c}"


def _all_fine_voxels(dims):
    import itertools
    return np.array(list(itertools.product(
        range(dims[0]), range(dims[1]), range(dims[2]))), np.int32)


def check_irregular(grid: IrregularGrid) -> None:
    """Invariants that make irregular-grid traversal correct:
    1. every fine voxel is owned by an alive cell whose bbox contains it;
    2. conservative completeness: a tri overlapping voxel v is in the ref
       list of v's owner;
    3. expansion safety: every voxel inside a cell's (possibly expanded)
       bbox is owned by that cell or by an empty cell;
    4. per-cell ref lists are sorted and unique.
    """
    import jax.numpy as jnp

    fine = grid.fine_dims
    vox = _all_fine_voxels(fine)
    owner, cmin_o, cmax_o = (np.asarray(x) for x in
                             grid.lookup(jnp.asarray(vox)))
    alive = np.asarray(grid.alive)
    starts = np.asarray(grid.cell_starts)
    refs = np.asarray(grid.ref_ids)
    n_refs = np.diff(starts)[:alive.shape[0]]

    assert np.all(alive[owner]), "voxel owned by dead cell"
    assert np.all((cmin_o <= vox).all(1) & (vox <= cmax_o).all(1)), \
        "owner bbox does not contain voxel"

    # 4: sorted unique ref lists, in-range ids.
    n_tris = grid.tris.count
    total = int(grid.total_refs)
    assert starts[-1] == total
    for c in np.nonzero(alive)[0]:
        seg = refs[starts[c]:starts[c + 1]]
        assert len(seg) <= 1 or np.all(np.diff(seg) > 0), \
            f"cell {c} refs not sorted/unique"
        assert np.all((seg >= 0) & (seg < n_tris))

    # 2: completeness against recomputed fine ranges.
    lo, hi = (np.asarray(x) for x in tri_voxel_ranges(
        grid.tris, grid.bbox_lo, grid.bbox_hi, fine))
    own_map = owner.reshape(fine)  # indexed [x,y,z] via itertools order
    cell_sets = {int(c): set(refs[starts[c]:starts[c + 1]].tolist())
                 for c in np.nonzero(alive)[0]}
    for t in range(n_tris):
        for x in range(lo[t, 0], hi[t, 0] + 1):
            for y in range(lo[t, 1], hi[t, 1] + 1):
                for z in range(lo[t, 2], hi[t, 2] + 1):
                    c = int(own_map[x, y, z])
                    assert t in cell_sets[c], \
                        f"tri {t} missing from owner cell {c} of voxel " \
                        f"({x},{y},{z})"

    # 3: expansion safety — every foreign cell covered by a cell's bbox
    # must carry a ref list that is a SUBSET of the covering cell's
    # (empty is the trivial subset; non-empty coverage comes from the
    # src/expand.cu-style subset expansion).
    cmin = np.asarray(grid.cell_min)
    cmax = np.asarray(grid.cell_max)
    for c in np.nonzero(alive)[0]:
        sl = own_map[cmin[c, 0]:cmax[c, 0] + 1,
                     cmin[c, 1]:cmax[c, 1] + 1,
                     cmin[c, 2]:cmax[c, 2] + 1]
        others = np.unique(sl[sl != c])
        mine = cell_sets[int(c)]
        for o in others:
            theirs = cell_sets.get(int(o), set())
            assert theirs <= mine, \
                f"cell {c} bbox covers foreign cell {o} whose refs " \
                f"{theirs - mine} are not in its own list"


def check_packet(grid, sample_tris: int | None = 4096, seed: int = 0):
    """Vectorized invariants for the packet grid (scales to Sponza-size
    scenes, unlike the per-voxel python loops above).

    1. rs tables are consistent ref maps: monotone within and across
       rows, within capacity, layout-offset aligned.
    2. Ref rows of `cols` carry valid triangle ids in every live span.
    3. Conservative completeness (sampled): every (tri, voxel) exact
       overlap has the tri's id somewhere in the voxel's row span.
    """
    from .uniform import tri_box_overlap

    r_cap = grid.ref_capacity
    # cols stores 4-ref GROUP rows; per-ref col 16 is the tri id as a
    # float VALUE (grid/packet.py docstring) — positions 16, 36, 56, 76.
    ids_all = np.asarray(grid.cols)[:, 16::20].reshape(-1).astype(
        np.int32)
    n_tris = grid.tris.count
    rng = np.random.default_rng(seed)

    rs_flat = np.asarray(grid.rs)
    rowinfo = np.asarray(grid.rowinfo)
    rbase = 0
    for a in range(3):
        da, db, dc = grid.dims3[a]
        nrows = da * db
        ri = rowinfo[rbase:rbase + nrows]
        rbase += nrows
        row_off = ri & 0x0FFFFFFF
        m_row = 1 << (ri >> 28)
        nc_row = m_row * dc

        # 1: structure of the ragged ref map (per-row refined columns):
        # each row's table is monotone, rows are contiguous, values
        # layout-offset aligned within capacity.
        ends = row_off + nc_row
        first = rs_flat[row_off] - a * r_cap
        last = rs_flat[ends] - a * r_cap
        assert first[0] == 0 and np.all(first >= 0) \
            and np.all(last <= r_cap)
        assert np.all(first[1:] == last[:-1]), \
            f"layout {a}: row spans not contiguous"
        for r in range(nrows):
            seg = rs_flat[row_off[r]:ends[r] + 1] - a * r_cap
            assert np.all(np.diff(seg) >= 0), \
                f"layout {a}: rs not monotone within row {r}"

        # 2: live spans carry valid ids.
        ids = ids_all[a * r_cap:(a + 1) * r_cap]
        total = int(last[-1])
        assert np.all(ids[:total] >= 0) and np.all(ids[:total] < n_tris)

        # 3: sampled completeness vs recomputed voxel ranges. The build
        # SAT-prunes (tri, cell) pairs, so membership is required only
        # where the exact overlap test passes for some cell of the row.
        # SLICE-AXIS boundaries come from the plane table (non-uniform
        # when built adaptive=True; identical to uniform otherwise) —
        # both the per-tri slice range and the cell box below.
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        dims_xyz = [0, 0, 0]
        dims_xyz[a], dims_xyz[a1], dims_xyz[a2] = da, db, dc
        lo, hi = (np.array(x) for x in tri_voxel_ranges(
            grid.tris, grid.bbox_lo, grid.bbox_hi, tuple(dims_xyz)))
        P = np.asarray(grid.planes)[a, :da + 1]
        tlo3, thi3 = (np.asarray(x) for x in grid.tris.bounds())
        if da > 1:
            lo[:, a] = np.sum(tlo3[:, a:a + 1] >= P[None, 1:da], axis=1)
            hi[:, a] = np.sum(thi3[:, a:a + 1] >= P[None, 1:da], axis=1)
        blo = np.asarray(grid.bbox_lo)
        bhi = np.asarray(grid.bbox_hi)
        cs = ((bhi - blo) / np.asarray(dims_xyz, np.float32)
              ).astype(np.float32)
        v0h = np.asarray(grid.tris.v0)
        v1h = v0h + np.asarray(grid.tris.e1)
        v2h = v0h + np.asarray(grid.tris.e2)
        n_s = n_tris if sample_tris is None else min(n_tris, sample_tris)
        ts = rng.choice(n_tris, size=n_s, replace=False)
        row_sets = {}
        for t in ts:
            for k in range(lo[t, a], hi[t, a] + 1):
                for j in range(lo[t, a1], hi[t, a1] + 1):
                    ccols = np.arange(lo[t, a2], hi[t, a2] + 1)
                    vox = np.zeros((len(ccols), 3), np.float32)
                    vox[:, a], vox[:, a1], vox[:, a2] = k, j, ccols
                    clo = blo + vox * cs
                    chi = clo + cs
                    clo[:, a] = P[k]
                    chi[:, a] = P[min(k + 1, da)]
                    m = np.asarray(tri_box_overlap(
                        np.broadcast_to(v0h[t], clo.shape),
                        np.broadcast_to(v1h[t], clo.shape),
                        np.broadcast_to(v2h[t], clo.shape),
                        clo, chi))
                    if not m.any():
                        continue
                    r = k * db + j
                    # Column-trimmed membership at FINE granularity:
                    # the tracer gathers ids[rs[off+c0]:rs[off+c1+1]]
                    # over the row's refined columns, so the tri must
                    # sit in every fine column its c-extent covers
                    # within each SAT-positive base cell (the build's
                    # bbox-conservative fine binning, grid/packet.py).
                    mr = int(m_row[r])
                    ro = int(row_off[r])
                    tcmin = min(v0h[t, a2], v1h[t, a2], v2h[t, a2])
                    tcmax = max(v0h[t, a2], v1h[t, a2], v2h[t, a2])
                    # f32 arithmetic, matching the build's fine-span
                    # computation bit-exactly (boundary cells).
                    icf = np.float32(mr) / cs[a2]
                    for c in ccols[m]:
                        fl = int(np.clip(
                            np.floor((tcmin - blo[a2]) * icf),
                            c * mr, c * mr + mr - 1))
                        fh = int(np.clip(
                            np.floor((tcmax - blo[a2]) * icf),
                            fl, c * mr + mr - 1))
                        for fc in range(fl, fh + 1):
                            key = (r, fc)
                            if key not in row_sets:
                                row_sets[key] = set(
                                    ids[rs_flat[ro + fc] - a * r_cap:
                                        rs_flat[ro + fc + 1] - a * r_cap
                                        ].tolist())
                            assert int(t) in row_sets[key], \
                                f"layout {a}: tri {t} missing from " \
                                f"row {r} fine column {fc}"
