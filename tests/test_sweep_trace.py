"""Planned-sweep tracer (plain-XLA sweep on the CPU) vs the brute-force oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid.packet import build_packet
from hagrid.ops.sweep_trace import trace_sweep


@pytest.fixture(scope="module")
def cornell():
    v, f = scenes.cornell_box()
    return Triangles.from_mesh(v, f)


def _check(hits, ref, n_report=8, id_rate=0.995):
    got_id = np.asarray(hits.tri_id)
    ref_id = np.asarray(ref.tri_id)
    got_t = np.asarray(hits.t)
    ref_t = np.asarray(ref.t)
    got_hit = got_id >= 0
    ref_hit = ref_id >= 0
    tol_t = np.isclose(got_t, ref_t, rtol=1e-3, atol=1e-5)
    # Hit-ness must agree, and where both hit, t must match. (The old
    # form `same | A & B` bound as `same | (A & B)` and let any
    # hit-ness-matching ray pass regardless of id — it missed a bug
    # where every id came back 0.)
    ok = (got_hit == ref_hit) & (~ref_hit | tol_t)
    assert ok.mean() > 0.999, (
        f"{(~ok).sum()} rays disagree; first: "
        f"{[(i, got_id[i], ref_id[i], got_t[i], ref_t[i]) for i in np.where(~ok)[0][:n_report]]}")
    # Ids must agree too (allowing a sliver of equal-t edge ties).
    both = got_hit & ref_hit
    same = got_id[both] == ref_id[both]
    assert same.mean() > id_rate, (
        f"tri-id agreement only {same.mean():.4f}; first mismatches: "
        f"{[(int(i), got_id[i], ref_id[i]) for i in np.where(both)[0][~same][:n_report]]}")
    np.testing.assert_allclose(got_t[both][same], ref_t[both][same],
                               rtol=1e-3, atol=1e-5)


def test_primary_cornell_matches_oracle(cornell):
    g = build_packet(cornell, dims=(6, 6, 6))
    rays = primary_rays(scenes.cornell_camera(), 32, 32)
    hits = trace_sweep(g, rays, tile=128, slab=4, bmax=2048)
    ref = oracle.closest_hit(rays, cornell)
    frac = float(np.mean(np.asarray(hits.tri_id) >= 0))
    assert frac > 0.9
    _check(hits, ref)


def test_random_rays_match_oracle(cornell):
    g = build_packet(cornell, dims=(5, 4, 6))
    key = jax.random.PRNGKey(7)
    n = 512
    org = jax.random.uniform(key, (n, 3)) * 0.6 + 0.2
    d = jax.random.normal(jax.random.PRNGKey(8), (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(org, d)
    hits = trace_sweep(g, rays, tile=128, slab=4, bmax=2048)
    ref = oracle.closest_hit(rays, cornell)
    _check(hits, ref)


def test_finite_tmax_any_hit(cornell):
    g = build_packet(cornell, dims=(6, 6, 6))
    rays = primary_rays(scenes.cornell_camera(), 16, 16)
    ref = oracle.closest_hit(rays, cornell)
    short = Rays(org=rays.org, dir=rays.dir, tmin=rays.tmin,
                 tmax=jnp.where(jnp.isfinite(ref.t), ref.t * 0.5, 1e-3))
    hits = trace_sweep(g, short, tile=128, slab=4, bmax=2048)
    assert (np.asarray(hits.tri_id) == -1).all()
    any_hits = trace_sweep(g, rays, any_hit=True,
                           tile=128, slab=4, bmax=2048)
    assert ((np.asarray(any_hits.tri_id) >= 0)
            == (np.asarray(ref.tri_id) >= 0)).all()


def test_empty_scene():
    tris = Triangles.from_mesh(np.zeros((0, 3), np.float32),
                               np.zeros((0, 3), np.int32))
    g = build_packet(tris)
    rays = primary_rays(scenes.cornell_camera(), 8, 8)
    hits = trace_sweep(g, rays, tile=128, slab=4, bmax=2048)
    assert (np.asarray(hits.tri_id) == -1).all()
