"""Packet-grid invariants at scale (vectorized checker:
the per-voxel python-loop checkers cannot run on >100k-tri scenes)."""

import numpy as np
import pytest

from hagrid import scenes
from hagrid.core.types import Triangles
from hagrid.grid.invariants import check_packet
from hagrid.grid.packet import build_packet


def test_packet_invariants_cornell():
    v, f = scenes.cornell_box()
    g = build_packet(Triangles.from_mesh(v, f), dims=(6, 5, 4))
    check_packet(g, sample_tris=None)


def test_packet_invariants_sponza_scale():
    v, f = scenes.sponza_like(100000)
    assert len(f) >= 100000
    g = build_packet(Triangles.from_mesh(v, f))
    check_packet(g, sample_tris=1024)


def test_packet_invariants_adaptive_planes():
    """check_packet must bin the slice axis by the PLANE TABLE, not
    uniform cell sizes: on an adaptive grid the
    two disagree, and a plane-unaware checker mis-assigns rows."""
    v, f = scenes.sponza_like(20000)
    g = build_packet(Triangles.from_mesh(v, f), adaptive=True)
    planes = np.asarray(g.planes)
    da = g.dims3[0][0]
    uniform = np.linspace(planes[0, 0], planes[0, da], da + 1)
    assert not np.allclose(planes[0, :da + 1], uniform, rtol=1e-3), \
        "adaptive build produced uniform planes; test is vacuous"
    check_packet(g, sample_tris=512)


def test_packet_overflow_flag():
    # Capacity rounds up to 768 (one sweep block), so force overflow
    # with a fine grid: wall tris at 12^3 span hundreds of voxels.
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    g = build_packet(tris, ref_capacity=768, check=False,
                     dims=(12, 12, 12))
    assert bool(np.asarray(g.overflowed))
    g2 = build_packet(tris, dims=(12, 12, 12))
    assert not bool(np.asarray(g2.overflowed))
