"""Wavefront (lockstep) traversal vs DDA reference and oracle."""

import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid.uniform import build_uniform, trace_uniform

from test_uniform_grid import assert_hits_match, random_rays


def test_wavefront_cornell_matches_oracle():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    rays = primary_rays(scenes.cornell_camera(), 48, 48)
    got = trace_uniform(grid, rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


@pytest.mark.parametrize("seed,rpi", [(0, 1), (1, 4), (2, 16)])
def test_wavefront_soup_matches_oracle(seed, rpi):
    v, f = scenes.random_soup(150, seed=seed)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=3.0)
    rays = random_rays(256, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=seed + 20)
    got = trace_uniform(grid, rays, refs_per_iter=rpi)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


def test_wavefront_any_hit():
    v, f = scenes.random_soup(100, seed=5)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    rays = random_rays(256, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=42)
    got = trace_uniform(grid, rays, any_hit=True)
    want = oracle.any_hit(rays, tris)
    np.testing.assert_array_equal(np.asarray(got.tri_id) >= 0,
                                  np.asarray(want))


def test_wavefront_rays_outside_grid():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    org = np.array([[3000.0, 3000, 3000], [-3000, 273, 250]], np.float32)
    dirs = np.array([[1.0, 0, 0], [-1.0, 0, 0]], np.float32)
    got = trace_uniform(grid, Rays.make(org, dirs))
    assert np.all(np.asarray(got.tri_id) == -1)
