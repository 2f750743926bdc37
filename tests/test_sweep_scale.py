"""Sweep tracer at scale, production configuration.

The production configuration (tile=512, whole-grid single round,
anisotropic multi-layout dims, _RMAX row trim + tail ranges, block-budget
gating) needs a big-scene cross-check: bench's hit_fraction cannot catch
wrong hit *ids* in an enclosed atrium. These tests run the production
config (the plain-XLA sweep on the CPU backend) on a 20k-tri sponza_like
scene against the
brute-force oracle, for primaries and an incoherent AO wave, and pin
the block-budget overflow contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid.packet import build_packet
from hagrid.ops.sweep_trace import trace_sweep
from hagrid.render.sampling import cosine_hemisphere, \
    hit_points_normals

W = H = 64


@pytest.fixture(scope="module")
def scene():
    v, f = scenes.sponza_like(20000)
    tris = Triangles.from_mesh(v, f)
    grid = build_packet(tris)  # production densities/dims3
    rays = primary_rays(scenes.sponza_camera(), W, H, order="block")
    return tris, grid, rays


def _oracle_chunked(rays: Rays, tris: Triangles, chunk=512):
    outs = []
    for i in range(0, rays.count, chunk):
        sl = slice(i, i + chunk)
        outs.append(oracle.closest_hit(
            Rays(org=rays.org[sl], dir=rays.dir[sl],
                 tmin=rays.tmin[sl], tmax=rays.tmax[sl]), tris))
    return (np.concatenate([np.asarray(h.tri_id) for h in outs]),
            np.concatenate([np.asarray(h.t) for h in outs]))


def _agree(hits, ref_id, ref_t, min_rate=0.999):
    got_id = np.asarray(hits.tri_id)
    got_t = np.asarray(hits.t)
    got_hit = got_id >= 0
    ref_hit = ref_id >= 0
    tol_t = np.isclose(got_t, ref_t, rtol=1e-3, atol=1e-4)
    # Equal-t ties on coplanar/shared-edge geometry may resolve to a
    # different id; count a ray as agreeing if hit-ness matches, t
    # matches, and (id matches or the t-tie is within tolerance).
    ok = (got_hit == ref_hit) & (~ref_hit | tol_t)
    rate = ok.mean()
    assert rate > min_rate, (
        f"agreement {rate:.4f}; first disagreements: "
        f"{[(int(i), int(got_id[i]), int(ref_id[i]), float(got_t[i]), float(ref_t[i])) for i in np.where(~ok)[0][:8]]}")
    both = got_hit & ref_hit
    same = (got_id[both] == ref_id[both]).mean()
    assert same > 0.995, f"tri-id agreement only {same:.4f}"
    return got_hit


@pytest.mark.slow
def test_primary_production_config_matches_oracle(scene):
    tris, grid, rays = scene
    # Production call: default tile=512, slab=None (whole-grid single
    # round), default per-round budget ladder; coherent fast path.
    hits, ovf = trace_sweep(grid, rays, coherent=True, bmax=4096,
                            return_overflow=True)
    assert not bool(ovf), "primary wave should fit the block budget"
    ref_id, ref_t = _oracle_chunked(rays, tris)
    got_hit = _agree(hits, ref_id, ref_t)
    assert got_hit.mean() > 0.9  # enclosed atrium: nearly all rays hit


@pytest.mark.slow
def test_ao_wave_production_config_matches_oracle(scene):
    tris, grid, rays = scene
    hits = trace_sweep(grid, rays, coherent=True, bmax=4096)
    tri_n = tris.n
    p, n, found = hit_points_normals(rays, hits, tri_n)
    d = cosine_hemisphere(jax.random.PRNGKey(3), n)
    ext = float(np.max(np.asarray(grid.bbox_hi - grid.bbox_lo)))
    org = p + n * 1e-3 * ext
    tmax = jnp.where(found, ext * 0.2, 0.0)  # masked-dead misses ride along
    sec = Rays(org=org, dir=d, tmin=jnp.zeros(rays.count), tmax=tmax)
    got = np.asarray(trace_sweep(grid, sec, any_hit=True,
                                 bmax=8192).tri_id) >= 0
    ref = np.asarray(oracle.any_hit(sec, tris))
    rate = (got == ref).mean()
    assert rate > 0.999, f"any-hit agreement {rate:.4f}"


def test_any_hit_overflow_error_is_one_sided(scene):
    """Block-budget overflow drops occluder panels. For ANY-HIT waves
    the error is exactly one-sided: a dropped block can only remove
    hits (an AO/shadow estimate only gets BRIGHTER, never darker) and
    the overflow flag must report it. The quantified error bound: flag
    clear -> exact (pinned by the oracle tests above); flag set ->
    one-sided over-brightening."""
    tris, grid, _ = scene
    # 128^2 keeps the wave big enough to starve at the 128-block floor
    # while staying in the fast tier.
    rays = primary_rays(scenes.sponza_camera(), 128, 128, order="block")
    hits = trace_sweep(grid, rays, coherent=True, bmax=4096)
    p, n, found = hit_points_normals(rays, hits, tris.n)
    d = cosine_hemisphere(jax.random.PRNGKey(5), n)
    ext = float(np.max(np.asarray(grid.bbox_hi - grid.bbox_lo)))
    sec = Rays(org=p + n * 1e-3 * ext, dir=d,
               tmin=jnp.zeros(rays.count),
               tmax=jnp.where(found, ext * 0.2, 0.0))
    full, ovf_full, demand = trace_sweep(
        grid, sec, any_hit=True, bmax=8192, return_overflow=True,
        return_demand=True)
    assert int(demand[0]) > 128, \
        "wave too small to starve at the floor"
    starved, ovf_st = trace_sweep(grid, sec, any_hit=True, bmax=128,
                                  return_overflow=True)
    assert not bool(ovf_full)
    assert bool(ovf_st), "starved any-hit must raise the overflow flag"
    f_full = np.asarray(full.tri_id) >= 0
    f_st = np.asarray(starved.tri_id) >= 0
    assert not (f_st & ~f_full).any(), \
        "overflow invented an occluder (must only drop hits)"
    assert (f_full & ~f_st).any(), \
        "starved run should actually drop some occluders"


def test_block_budget_overflow_contract(scene):
    """Overflow is the ONLY way the sweep drops work: with a starved
    budget the flag must fire (and hits may be missed); with the flag
    clear, results must be complete (pinned by the tests above)."""
    tris, grid, _ = scene
    # Measure the frame's true block demand, then starve it at the
    # 128-block budget floor. 128x128 primaries keep demand comfortably
    # above the floor even as planner trims tighten across rounds.
    rays = primary_rays(scenes.sponza_camera(), 128, 128, order="block")
    hits_ok, ovf_ok, demand = trace_sweep(
        grid, rays, coherent=True, bmax=2048, return_overflow=True,
        return_demand=True)
    assert int(demand[0]) > 128, \
        f"demand {int(demand[0])} blocks too low to starve at the floor"
    hits_sm, ovf_sm = trace_sweep(grid, rays, coherent=True, bmax=128,
                                  return_overflow=True)
    assert not bool(ovf_ok)
    assert bool(ovf_sm), "starved budget must raise the overflow flag"
    # The starved run loses geometry (never invents it): any hits it
    # does report exist in the full run... but the dropped blocks can
    # also unmask farther triangles, so only assert the flag + that
    # SOME rays lost their hit.
    lost = ((np.asarray(hits_ok.tri_id) >= 0)
            & (np.asarray(hits_sm.tri_id) < 0)).mean()
    assert lost > 0 or (np.asarray(hits_sm.tri_id)
                        != np.asarray(hits_ok.tri_id)).any()
