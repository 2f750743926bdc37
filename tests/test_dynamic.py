"""Dynamic geometry: per-frame rebuilds stay correct and shape-stable."""

import jax
import numpy as np

from hagrid import oracle, scenes
from hagrid.core.camera import Camera, primary_rays
from hagrid.core.types import Triangles
from hagrid.render.dynamic import AnimatedScene, wave_deform
from hagrid.render.session import RenderSession
from hagrid.utils.config import BuildParams

from test_uniform_grid import assert_hits_match

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=1, expansion_passes=1)


def test_animated_rebuild_matches_oracle_every_frame():
    v, f = scenes.random_soup(80, seed=8, extent=2.0)
    anim = AnimatedScene(v, f)
    s = RenderSession.create(anim.frame(0.0), SMALL)
    cam = Camera(eye=(1, 1, 6), center=(1, 1, 1))
    rays = primary_rays(cam, 16, 16)
    shapes0 = jax.tree.map(lambda a: a.shape, s.grid)
    for t in (0.25, 0.5, 0.75):
        tris = anim.frame(t)
        s.rebuild(tris)
        got = s.trace(rays)
        want = oracle.closest_hit(rays, tris)
        assert_hits_match(got, want)
    # Capacity buckets must be stable across frames (no reallocation).
    shapes1 = jax.tree.map(lambda a: a.shape, s.grid)
    assert shapes0 == shapes1


def test_wave_deform_moves_vertices():
    v = np.zeros((4, 3), np.float32)
    v[:, 0] = np.arange(4)
    out0 = np.asarray(wave_deform(v, 0.0))
    out1 = np.asarray(wave_deform(v, 0.3))
    assert not np.allclose(out0[:, 1], out1[:, 1])
    np.testing.assert_allclose(out0[:, 0], v[:, 0])  # only y moves
