"""Core math: Moller-Trumbore, slab test, camera, oracle."""

import jax.numpy as jnp
import numpy as np

from hagrid.core.camera import Camera, primary_rays
from hagrid.core.intersect import moller_trumbore, safe_inv_dir, slab_test
from hagrid.core.types import AABB, Rays, Triangles
from hagrid import oracle
from hagrid import scenes


def test_moller_trumbore_basic():
    # Unit triangle in z=0 plane, ray straight down.
    tris = Triangles.from_vertices(
        np.array([[0.0, 0, 0]]), np.array([[1.0, 0, 0]]),
        np.array([[0.0, 1, 0]]))
    hit, t, u, v = moller_trumbore(
        jnp.array([0.25, 0.25, 1.0]), jnp.array([0.0, 0.0, -1.0]),
        tris.v0[0], tris.e1[0], tris.e2[0], 0.0, jnp.inf)
    assert bool(hit)
    np.testing.assert_allclose(float(t), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(u), 0.25, rtol=1e-5)
    np.testing.assert_allclose(float(v), 0.25, rtol=1e-5)
    # Outside the triangle.
    hit, _, _, _ = moller_trumbore(
        jnp.array([0.9, 0.9, 1.0]), jnp.array([0.0, 0.0, -1.0]),
        tris.v0[0], tris.e1[0], tris.e2[0], 0.0, jnp.inf)
    assert not bool(hit)
    # Parallel ray misses.
    hit, _, _, _ = moller_trumbore(
        jnp.array([0.25, 0.25, 1.0]), jnp.array([1.0, 0.0, 0.0]),
        tris.v0[0], tris.e1[0], tris.e2[0], 0.0, jnp.inf)
    assert not bool(hit)


def test_slab():
    org = jnp.array([[-1.0, 0.5, 0.5]])
    dir = jnp.array([[1.0, 0.0, 0.0]])
    inv = safe_inv_dir(dir)
    enter, exit_, ok = slab_test(org, inv, jnp.zeros(3), jnp.ones(3),
                                 0.0, jnp.inf)
    assert bool(ok[0])
    np.testing.assert_allclose(float(enter[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(exit_[0]), 2.0, rtol=1e-6)
    # Ray pointing away misses.
    _, _, ok = slab_test(org, safe_inv_dir(-dir), jnp.zeros(3), jnp.ones(3),
                         0.0, jnp.inf)
    assert not bool(ok[0])
    # Axis-parallel ray inside the slab (dir component 0) still works.
    org2 = jnp.array([[0.5, 0.5, -2.0]])
    dir2 = jnp.array([[0.0, 0.0, 1.0]])
    enter, exit_, ok = slab_test(org2, safe_inv_dir(dir2), jnp.zeros(3),
                                 jnp.ones(3), 0.0, jnp.inf)
    assert bool(ok[0]) and abs(float(enter[0]) - 2.0) < 1e-6


def test_oracle_cornell_center_ray():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    cam = scenes.cornell_camera()
    rays = primary_rays(cam, 3, 3)
    hits = oracle.closest_hit(rays, tris)
    # Center ray must hit something (the tall block or back wall).
    assert int(hits.tri_id[4]) >= 0
    assert float(hits.t[4]) > 0


def test_oracle_coverage_cornell():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    cam = scenes.cornell_camera()
    rays = primary_rays(cam, 32, 32)
    hits = oracle.closest_hit(rays, tris)
    frac = float(np.mean(np.asarray(hits.tri_id) >= 0))
    # Camera looks into a closed box: nearly every ray hits (edge rays can
    # slip past the open front face).
    assert frac > 0.9


def test_any_hit_matches_closest():
    v, f = scenes.random_soup(64, seed=3)
    tris = Triangles.from_mesh(v, f)
    rng = np.random.default_rng(0)
    org = rng.uniform(-0.2, 1.2, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(org, d)
    closest = oracle.closest_hit(rays, tris)
    any_ = oracle.any_hit(rays, tris)
    np.testing.assert_array_equal(np.asarray(any_),
                                  np.asarray(closest.tri_id) >= 0)


def test_aabb():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    bb = AABB.of_triangles(tris)
    np.testing.assert_allclose(np.asarray(bb.lo), [0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(bb.hi), [556, 548.8, 559.2],
                               atol=1e-3)
    assert float(bb.half_area()) > 0


def test_camera_rays_normalized():
    cam = Camera(eye=(0, 0, -5), center=(0, 0, 0))
    rays = primary_rays(cam, 8, 4)
    assert rays.count == 32
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(rays.dir), axis=1), 1.0, rtol=1e-5)
