"""Two-level irregular grid: build invariants and traversal vs oracle."""

import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid import invariants
from hagrid.grid.irregular import build_irregular, trace_irregular
from hagrid.utils.config import BuildParams

from test_uniform_grid import assert_hits_match, random_rays

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=2, expansion_passes=2)


def test_build_invariants_cornell():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    invariants.check_irregular(grid)
    st = grid.stats()
    assert st["cells"] > 0 and st["refs"] > 0


def test_build_invariants_soup():
    v, f = scenes.random_soup(120, seed=2)
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    invariants.check_irregular(grid)


def test_build_no_merge_no_expand():
    v, f = scenes.random_soup(100, seed=4)
    tris = Triangles.from_mesh(v, f)
    p = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=0, expansion_passes=0)
    grid = build_irregular(tris, p)
    invariants.check_irregular(grid)


def test_merging_reduces_cells():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    # levels=1 -> structural max 2, and ref_growth=inf disables the
    # refinement budget: identical cells to the pre-budget builder,
    # where Cornell's subdivision leaves SAH-mergeable neighbors.
    p0 = BuildParams(top_density=0.3, snd_density=2.0, levels=1,
                     ref_growth=1e9, merge_passes=0,
                     expansion_passes=0, buddy_passes=0)
    p1 = BuildParams(top_density=0.3, snd_density=2.0, levels=1,
                     ref_growth=1e9, merge_passes=3,
                     expansion_passes=0, buddy_passes=0)
    g0 = build_irregular(tris, p0)
    g1 = build_irregular(tris, p1)
    assert g1.stats()["cells"] < g0.stats()["cells"]


def test_traverse_cornell_matches_oracle():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    rays = primary_rays(scenes.cornell_camera(), 48, 48)
    got = trace_irregular(grid, rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traverse_soup_matches_oracle(seed):
    v, f = scenes.random_soup(150, seed=seed)
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    rays = random_rays(256, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=seed + 30)
    got = trace_irregular(grid, rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


def test_traverse_any_hit():
    v, f = scenes.random_soup(100, seed=6)
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    rays = random_rays(256, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=77)
    got = trace_irregular(grid, rays, any_hit=True)
    want = oracle.any_hit(rays, tris)
    np.testing.assert_array_equal(np.asarray(got.tri_id) >= 0,
                                  np.asarray(want))
