"""Uniform grid build + DDA traversal vs the brute-force oracle."""

import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid import invariants, traverse_ref
from hagrid.grid.uniform import build_uniform


def assert_hits_match(got, want, rtol=1e-4):
    got_id = np.asarray(got.tri_id)
    want_id = np.asarray(want.tri_id)
    np.testing.assert_array_equal(got_id, want_id)
    m = want_id >= 0
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m],
                               rtol=rtol, atol=1e-5)


def random_rays(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    ext = hi - lo
    org = rng.uniform(lo - 0.3 * ext, hi + 0.3 * ext, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays.make(org.astype(np.float32), d.astype(np.float32))


def test_build_invariants_cornell():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    invariants.check_uniform(grid)


def test_build_invariants_soup():
    v, f = scenes.random_soup(200, seed=1)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    invariants.check_uniform(grid)


def test_traverse_cornell_matches_oracle():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    rays = primary_rays(scenes.cornell_camera(), 48, 48)
    got = traverse_ref.closest_hit_jit(grid, rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traverse_soup_matches_oracle(seed):
    v, f = scenes.random_soup(150, seed=seed)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=3.0)
    lo = np.asarray(grid.bbox_lo)
    hi = np.asarray(grid.bbox_hi)
    rays = random_rays(256, lo, hi, seed=seed + 10)
    got = traverse_ref.closest_hit_jit(grid, rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


def test_any_hit_matches_oracle():
    v, f = scenes.random_soup(100, seed=5)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    rays = random_rays(256, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=42)
    got = traverse_ref.any_hit_jit(grid, rays)
    want = oracle.any_hit(rays, tris)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_rays_with_axis_aligned_dirs():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=2.4)
    org = np.array([[278, 273, -100], [278, 600, 250], [-100, 273, 250]],
                   np.float32)
    dirs = np.array([[0, 0, 1], [0, -1, 0], [1, 0, 0]], np.float32)
    rays = Rays.make(org, dirs)
    got = traverse_ref.closest_hit_jit(grid, rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


def test_overflow_retry():
    # Tiny capacity forces the overflow-retry path.
    v, f = scenes.random_soup(64, seed=9)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=4.0, ref_capacity=8)
    assert not grid.overflowed()
    invariants.check_uniform(grid)
