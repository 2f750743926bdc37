"""AO / shadow / path-tracing integrators and ray sorting."""

import jax
import numpy as np

from hagrid import scenes
from hagrid.core.camera import Camera, primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.ops import sortrays
from hagrid.render import integrators
from hagrid.render.session import RenderSession
from hagrid.utils.config import BuildParams

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=1, expansion_passes=1)


def _floor_scene():
    # A big ground quad at y=0 with a small blocker slab above part of it.
    floor_v, floor_f = scenes.grid_quad([-5, 0, -5], [10, 0, 0],
                                        [0, 0, 10], 4, 4)
    block_v, block_f = scenes.box([-1, 0.5, -1], [1, 0.7, 1], n=1)
    return scenes.merge([(floor_v, floor_f), (block_v, block_f)])


def test_sort_unsort_roundtrip():
    rng = np.random.default_rng(0)
    org = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(org, d)
    srt, perm = sortrays.sort_rays(rays, np.zeros(3, np.float32),
                                   np.ones(3, np.float32))
    # Unsorting the sorted org recovers the original org.
    back = sortrays.unsort(srt.org, perm)
    np.testing.assert_allclose(np.asarray(back), org)


def test_ao_open_vs_blocked():
    v, f = _floor_scene()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    cam = Camera(eye=(0, 6, 6.5), center=(0, 0, 0), fov_deg=50)
    rays = primary_rays(cam, 24, 24)
    hits = s.trace(rays)
    ao = integrators.ambient_occlusion(s, rays, hits,
                                       jax.random.PRNGKey(1), n_samples=8)
    ao = np.asarray(ao)
    tid = np.asarray(hits.tri_id)
    p = np.asarray(rays.org) + np.asarray(hits.t)[:, None] * np.asarray(
        rays.dir)
    on_floor = (tid >= 0) & (np.abs(p[:, 1]) < 1e-3)
    under = on_floor & (np.abs(p[:, 0]) < 0.8) & (np.abs(p[:, 2]) < 0.8)
    open_ = on_floor & (np.abs(p[:, 0]) > 2.0)
    assert under.sum() > 0 and open_.sum() > 0
    # Floor under the blocker is measurably darker than open floor.
    assert ao[under].mean() < ao[open_].mean() - 0.2
    # Open floor is mostly unoccluded.
    assert ao[open_].mean() > 0.8


def test_shadow_blocked_vs_lit():
    v, f = _floor_scene()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    cam = Camera(eye=(0, 6, 6.5), center=(0, 0, 0), fov_deg=50)
    rays = primary_rays(cam, 24, 24)
    hits = s.trace(rays)
    vis = np.asarray(integrators.shadow(s, rays, hits, (0.0, 50.0, 0.0)))
    tid = np.asarray(hits.tri_id)
    p = np.asarray(rays.org) + np.asarray(hits.t)[:, None] * np.asarray(
        rays.dir)
    on_floor = (tid >= 0) & (np.abs(p[:, 1]) < 1e-3)
    under = on_floor & (np.abs(p[:, 0]) < 0.8) & (np.abs(p[:, 2]) < 0.8)
    open_ = on_floor & (np.abs(p[:, 0]) > 2.0)
    # Light is straight above: under-blocker floor fully shadowed,
    # open floor fully lit (cos ~ 1).
    assert vis[under].max() == 0.0
    assert vis[open_].min() > 0.9


def test_path_trace_runs_and_bounded():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    img = integrators.path_trace(s, scenes.cornell_camera(), 16, 16,
                                 spp=2, max_bounces=3)
    img = np.asarray(img)
    assert img.shape == (16, 16, 3)
    assert np.all(img >= 0) and np.all(img <= 1.0 + 1e-5)
    # A closed box with only the open front as light: interior is dim but
    # not black everywhere.
    assert img.mean() > 0.001
