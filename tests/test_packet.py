"""Packet grid: sweep-table layout invariants vs the uniform oracle."""

import numpy as np
import pytest

from hagrid import scenes
from hagrid.core.types import Triangles
from hagrid.grid import packet
from hagrid.grid.uniform import build_uniform, tri_box_overlap


@pytest.fixture(scope="module")
def cornell():
    v, f = scenes.cornell_box()
    return Triangles.from_mesh(v, f)


def _cell_sets(g, axis, dims):
    """Per-(x,y,z)-cell ref sets from one layout's ragged rs/cols
    tables: a BASE cell's set is the union of its row's fine columns
    (contiguous spans, so one slice per base cell), which must equal
    the unrefined set — fine binning only splits, never drops."""
    a, b, c = packet._axis_order(axis)
    da, db, dc = g.dims3[axis]
    r_cap = g.ref_capacity
    rbase = sum(g.dims3[i][0] * g.dims3[i][1] for i in range(axis))
    ri = np.asarray(g.rowinfo[rbase:rbase + da * db])
    row_off = ri & 0x0FFFFFFF                 # absolute into rs
    m_row = 1 << (ri >> 28)
    rs = np.asarray(g.rs) - axis * r_cap
    ids_flat = np.asarray(g.cols)[:, 16::20].reshape(-1)  # group rows
    ids = ids_flat[axis * r_cap:(axis + 1) * r_cap].astype(np.int32)
    out = {}
    for ka in range(da):
        for kb in range(db):
            r = ka * db + kb
            ro, mr = int(row_off[r]), int(m_row[r])
            for kc in range(dc):
                xyz = [0, 0, 0]
                xyz[a], xyz[b], xyz[c] = ka, kb, kc
                out[tuple(xyz)] = frozenset(
                    ids[rs[ro + kc * mr]:
                        rs[ro + (kc + 1) * mr]].tolist())
    return out


def test_three_layouts_agree_with_uniform(cornell):
    dims = (4, 4, 4)
    g = packet.build_packet(cornell, dims=dims)
    u = build_uniform(cornell, dims=dims)
    # Uniform grid cell sets (x-fastest linearization). The packet build
    # SAT-prunes pairs the uniform AABB binning keeps, so each layout's
    # set must equal the uniform set filtered by the exact overlap test.
    us = np.asarray(u.cell_starts)
    uref = np.asarray(u.ref_ids)
    v0 = np.asarray(cornell.v0)
    v1 = v0 + np.asarray(cornell.e1)
    v2 = v0 + np.asarray(cornell.e2)
    # f32 corner math, exactly like the build (float64 promotion flips
    # boundary pairs).
    blo = np.asarray(g.bbox_lo)
    cs = ((np.asarray(g.bbox_hi) - blo) / 4.0).astype(np.float32)
    expected = {}
    for z in range(4):
        for y in range(4):
            for x in range(4):
                cell = (z * 4 + y) * 4 + x
                ts = uref[us[cell]:us[cell + 1]]
                clo = blo + np.array([x, y, z], np.float32) * cs
                keep = np.asarray(tri_box_overlap(
                    v0[ts], v1[ts], v2[ts],
                    np.broadcast_to(clo, (len(ts), 3)),
                    np.broadcast_to(clo + cs, (len(ts), 3))))
                expected[(x, y, z)] = frozenset(ts[keep].tolist())
    for axis in range(3):
        got = _cell_sets(g, axis, dims)
        assert got == expected, f"axis {axis} layout disagrees"


def test_rs_monotone_and_total(cornell):
    g = packet.build_packet(cornell, dims=(5, 3, 4))
    r_cap = g.ref_capacity
    rs = np.asarray(g.rs)
    rowinfo = np.asarray(g.rowinfo)
    rbase = 0
    for axis in range(3):
        da, db, dc = g.dims3[axis]
        ri = rowinfo[rbase:rbase + da * db]
        rbase += da * db
        row_off = ri & 0x0FFFFFFF
        ends = row_off + (1 << (ri >> 28)) * dc
        # Within each row: monotone; across rows: row end == next start.
        assert rs[row_off[0]] - axis * r_cap == 0
        for ro, e in zip(row_off, ends):
            assert (np.diff(rs[ro:e + 1]) >= 0).all()
        assert (rs[row_off[1:]] == rs[ends[:-1]]).all()
        # Fine-column duplication differs per layout (row partitions
        # differ); total_refs records the max.
        assert rs[ends[-1]] - axis * r_cap <= int(g.total_refs)


def test_cols_ids_are_exact_values(cornell):
    """Tri ids ride in cols[:, 16] as float values: exact, non-negative in
    live spans, zero in the dead tail (regression for the denormal-flush
    bug: bitcast id bits of small ids are denormals and get flushed)."""
    g = packet.build_packet(cornell, dims=(4, 4, 4))
    # cols stores 4-ref group rows; per-ref ids at 16, 36, 56, 76.
    ids_f = np.asarray(g.cols)[:, 16::20].reshape(-1)
    assert (ids_f == np.round(ids_f)).all()
    total = int(g.total_refs)
    ids0 = ids_f[:total].astype(np.int32)
    assert (ids0 >= 0).all() and (ids0 < cornell.count).all()
    # Every triangle appears somewhere in each layout's live span.
    r_cap = g.ref_capacity
    for axis in range(3):
        span = ids_f[axis * r_cap:axis * r_cap + total].astype(np.int32)
        assert set(span.tolist()) == set(range(cornell.count))


def test_refined_columns_union_matches_uniform_and_oracle():
    """build_packet(refine=True) (default-off, see grid/packet.py
    docstring) splits dense rows' columns by
    m in {2, 4}. Per base cell, the union of its fine columns must
    equal the unrefined set (fine binning only splits, never drops),
    and the tracer must stay oracle-exact through ragged rows."""
    from hagrid import oracle
    from hagrid.core.camera import primary_rays
    from hagrid.ops.sweep_trace import trace_sweep

    v, f = scenes.sponza_like(2000)
    tris = Triangles.from_mesh(v, f)
    dims = (4, 4, 4)
    g0 = packet.build_packet(tris, dims=dims, refine=False)
    g1 = packet.build_packet(tris, dims=dims, refine=True)
    assert int(np.asarray(g1.rowinfo >> 28).max()) >= 1, \
        "refinement gate never triggered; test scene too sparse"
    for axis in range(3):
        assert _cell_sets(g1, axis, dims) == _cell_sets(g0, axis, dims)
    rays = primary_rays(scenes.sponza_camera(), 48, 48)
    hits = trace_sweep(g1, rays, tile=128)
    ref = oracle.closest_hit(rays, tris)
    assert (np.asarray(hits.tri_id) == np.asarray(ref.tri_id)).mean() \
        == 1.0


def test_adaptive_slice_planes_match_oracle():
    """build_packet(adaptive=True) places non-uniform slice planes;
    tracing through them must stay oracle-exact."""
    from hagrid import oracle, scenes
    from hagrid.core.camera import primary_rays
    from hagrid.ops.sweep_trace import trace_sweep

    v, f = scenes.sponza_like(3000)
    tris = Triangles.from_mesh(v, f)
    g = packet.build_packet(tris, adaptive=True)
    pl = np.asarray(g.planes)
    for a in range(3):
        da = g.dims3[a][0]
        assert (np.diff(pl[a, :da + 1]) > 0).all(), "planes not monotone"
    rays = primary_rays(scenes.sponza_camera(), 48, 48)
    hits = trace_sweep(g, rays, tile=128)
    ref = oracle.closest_hit(rays, tris)
    assert (np.asarray(hits.tri_id) == np.asarray(ref.tri_id)).mean() \
        == 1.0
