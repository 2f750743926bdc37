"""Multi-chip ray sharding on the faked 8-device CPU mesh (SURVEY.md §4.3)."""

import jax
import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Triangles
from hagrid.grid.irregular import (build_irregular, irregular_lookup,
                                       trace_irregular)
from hagrid.parallel import mesh as pmesh
from hagrid.utils.config import BuildParams

from test_uniform_grid import assert_hits_match

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=1, expansion_passes=1)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return pmesh.make_mesh(8)


def test_sharded_trace_matches_single(eight_devices):
    mesh = eight_devices
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    rays = primary_rays(scenes.cornell_camera(), 32, 32)
    rays, n = pmesh.pad_rays(rays, 8)

    trace = pmesh.shard_trace(lambda g, r: trace_irregular(g, r), mesh)
    got = trace(grid, rays)
    want = oracle.closest_hit(rays, tris)
    got_trim = jax.tree.map(lambda a: a[:n], got)
    want_trim = jax.tree.map(lambda a: a[:n], want)
    assert_hits_match(got_trim, want_trim)


def test_sharded_sweep_matches_single(eight_devices):
    """The FLAGSHIP path (packet grid + sweep tracer) under shard_map:
    per-shard static shapes (tile/bmax) keep the per-chip program
    identical to single-chip; results must match the oracle."""
    from hagrid.grid.packet import build_packet
    from hagrid.ops.sweep_trace import trace_sweep

    mesh = eight_devices
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_packet(tris, dims=(6, 6, 6))
    rays = primary_rays(scenes.cornell_camera(), 64, 64)
    rays, n = pmesh.pad_rays(rays, 8 * 128)

    trace = pmesh.shard_trace(
        lambda g, r: trace_sweep(g, r, tile=128, slab=4, bmax=512), mesh)
    got = trace(grid, rays)
    assert len(got.t.sharding.device_set) == 8
    want = oracle.closest_hit(rays, tris)
    got_trim = jax.tree.map(lambda a: a[:n], got)
    want_trim = jax.tree.map(lambda a: a[:n], want)
    assert_hits_match(got_trim, want_trim)


def test_sharded_output_sharding(eight_devices):
    mesh = eight_devices
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    rays = primary_rays(scenes.cornell_camera(), 32, 32)
    rays, n = pmesh.pad_rays(rays, 8)
    trace = pmesh.shard_trace(lambda g, r: trace_irregular(g, r), mesh)
    hits = trace(grid, rays)
    # Output stays sharded over the rays axis (no implicit full gather).
    assert len(hits.t.sharding.device_set) == 8


def test_pad_rays_dead():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    rays = primary_rays(scenes.cornell_camera(), 3, 3)
    padded, n = pmesh.pad_rays(rays, 8)
    assert padded.count == 16 and n == 9
    # Padding rays have tmax 0 (dead).
    assert float(np.asarray(padded.tmax)[n:].max()) == 0.0


def test_distributed_single_process_noop(eight_devices):
    from hagrid.parallel import distributed

    distributed.initialize(num_processes=1)  # no-op path
    assert distributed.process_count() == 1
    assert distributed.is_coordinator()
    mesh = distributed.global_mesh()
    assert mesh.devices.size == len(jax.devices())
