"""Compacted round-based tracer vs oracle (both grid types)."""

import numpy as np

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Triangles
from hagrid.grid.irregular import build_irregular, trace_irregular_fast
from hagrid.grid.uniform import build_uniform, trace_uniform_fast
from hagrid.render.session import RenderSession
from hagrid.utils.config import BuildParams

from test_uniform_grid import assert_hits_match, random_rays

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=2, expansion_passes=2)


def test_compact_uniform_matches_oracle():
    v, f = scenes.random_soup(150, seed=1)
    tris = Triangles.from_mesh(v, f)
    grid = build_uniform(tris, density=3.0)
    rays = random_rays(300, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=11)
    # min_batch tiny so the compaction rounds actually trigger in tests
    from hagrid.ops import wavefront
    from hagrid.grid.uniform import uniform_lookup
    got = wavefront.trace(grid, uniform_lookup, rays, round_iters=4,
                          min_batch=16)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


def test_compact_irregular_matches_oracle():
    v, f = scenes.random_soup(150, seed=2)
    tris = Triangles.from_mesh(v, f)
    grid = build_irregular(tris, SMALL)
    rays = random_rays(300, np.asarray(grid.bbox_lo),
                       np.asarray(grid.bbox_hi), seed=12)
    from hagrid.ops import wavefront
    from hagrid.grid.irregular import irregular_lookup
    got = wavefront.trace(grid, irregular_lookup, rays, round_iters=4,
                          min_batch=16)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)


def test_session_irregular_cornell():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    rays = primary_rays(scenes.cornell_camera(), 32, 32)
    got = s.trace(rays)
    want = oracle.closest_hit(rays, tris)
    assert_hits_match(got, want)
    s.rebuild(tris)  # second build reuses capacities
    got2 = s.trace(rays)
    assert_hits_match(got2, want)


def test_session_any_hit():
    v, f = scenes.random_soup(100, seed=3)
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    rays = random_rays(200, np.asarray(s.grid.bbox_lo),
                       np.asarray(s.grid.bbox_hi), seed=13)
    got = s.trace(rays, any_hit=True)
    want = oracle.any_hit(rays, tris)
    np.testing.assert_array_equal(np.asarray(got.tri_id) >= 0,
                                  np.asarray(want))


def test_finite_tmax_respected():
    """Rays with finite tmax must ignore hits beyond it (shadow rays)."""
    import jax.numpy as jnp
    from hagrid.core.types import Rays

    v, f = scenes.random_soup(120, seed=9)
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    rays_inf = random_rays(256, np.asarray(s.grid.bbox_lo),
                           np.asarray(s.grid.bbox_hi), seed=21)
    base = s.trace(rays_inf)
    t = np.asarray(base.t)
    hit = np.asarray(base.tri_id) >= 0
    # Cut tmax to 90% of each hit distance: every such ray must now miss.
    tmax = np.where(hit, t * 0.9, 1e-3).astype(np.float32)
    rays_cut = Rays(org=rays_inf.org, dir=rays_inf.dir,
                    tmin=rays_inf.tmin, tmax=jnp.asarray(tmax))
    cut = s.trace(rays_cut)
    assert np.all(np.asarray(cut.tri_id)[hit] == -1)
    any_cut = s.trace(rays_cut, any_hit=True)
    assert np.all(np.asarray(any_cut.tri_id)[hit] == -1)
    # And tmax just beyond the hit keeps it.
    tmax2 = np.where(hit, t * 1.1, 1e-3).astype(np.float32)
    rays_keep = Rays(org=rays_inf.org, dir=rays_inf.dir,
                     tmin=rays_inf.tmin, tmax=jnp.asarray(tmax2))
    keep = s.trace(rays_keep)
    np.testing.assert_array_equal(np.asarray(keep.tri_id)[hit],
                                  np.asarray(base.tri_id)[hit])


def test_empty_scene():
    """A scene with zero triangles builds a valid grid; all rays miss."""
    import jax.numpy as jnp
    from hagrid.core.types import Rays
    from hagrid.grid.uniform import build_uniform, trace_uniform_fast

    tris = Triangles.from_mesh(np.zeros((0, 3), np.float32),
                               np.zeros((0, 3), np.int32))
    s = RenderSession.create(tris)
    r = Rays.make(np.array([[0, 0, -5.0]], np.float32),
                  np.array([[0, 0, 1.0]], np.float32))
    assert int(np.asarray(s.trace(r).tri_id)[0]) == -1
    g = build_uniform(tris)
    assert int(np.asarray(trace_uniform_fast(g, r).tri_id)[0]) == -1
