"""Golden-image regression tests (SURVEY.md §4.4).

The reference validates by rendered-image comparison; here the golden is
the brute-force oracle render of the same scene — structure-independent
ground truth. We compare hit-id maps exactly and t-maps within tolerance,
and pin a coarse perceptual hash of the shaded image so shading
regressions are caught too.
"""

import hashlib

import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Triangles
from hagrid.io.image import dhash, hamming, shade_eyelight, to_u8
from hagrid.render.session import RenderSession
from hagrid.utils.config import BuildParams

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=2, expansion_passes=2)
W = H = 64


def _render(session, tris, cam):
    rays = primary_rays(cam, W, H)
    hits = session.trace(rays)
    img = shade_eyelight(np.asarray(hits.tri_id), np.asarray(hits.t),
                         np.asarray(tris.n), np.asarray(rays.dir), W, H)
    return rays, hits, img


def test_cornell_golden_vs_oracle():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    rays, hits, img = _render(s, tris, scenes.cornell_camera())
    want = oracle.closest_hit(rays, tris)
    np.testing.assert_array_equal(np.asarray(hits.tri_id),
                                  np.asarray(want.tri_id))
    m = np.asarray(want.tri_id) >= 0
    np.testing.assert_allclose(np.asarray(hits.t)[m],
                               np.asarray(want.t)[m], rtol=1e-4, atol=1e-4)


def test_cornell_image_hash_stable():
    """Coarse (quantized) image hash: catches shading/camera regressions
    while tolerating float jitter. Update the hash only for intentional
    changes to camera/shading/geometry."""
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    _, _, img = _render(s, tris, scenes.cornell_camera())
    q = (to_u8(img) >> 4).astype(np.uint8)  # 16 levels: float-jitter-proof
    h = hashlib.sha256(q.tobytes()).hexdigest()[:16]
    assert h == "fb83fdf3e236bd52", f"image hash changed: {h}"


# --- Scaled goldens (SURVEY §4.4) -------------------------------------
#
# The scenes the benchmarks run on (sponza_like, san_miguel_like) pin a
# 64-bit perceptual dhash of the rendered image (io/image.dhash): exact
# pixel hashes are not stable across backends at these tri counts
# (silhouette pixels flip with float jitter), but structural regressions
# — camera, shading, geometry, missing occluder panels — flip many
# gradient-sign bits. Hashes were generated on CPU; tolerance 6/64
# keeps backend jitter green while a broken image (hamming ~20-32)
# stays red.
#
# The sponza eyelight golden is additionally ORACLE-anchored: the pinned
# hash equals the hash of the brute-force oracle render of the same
# rays (the session render's ids matched the oracle exactly on CPU). To
# regenerate a golden, render the same rays with oracle.closest_hit,
# shade with io.image.shade_eyelight and take io.image.dhash of the
# image; a session render must match it within HAM_TOL.

GOLD_W = GOLD_H = 128
HAM_TOL = 6


def _scene_session(name, n_tris):
    v, f = getattr(scenes, name)(n_tris)
    tris = Triangles.from_mesh(v, f)
    return RenderSession.create(tris, verts=v), tris


def _eyelight_dhash(name, n_tris, cam):
    s, tris = _scene_session(name, n_tris)
    rays = primary_rays(cam, GOLD_W, GOLD_H)
    hits = s.trace(rays)
    img = shade_eyelight(np.asarray(hits.tri_id), np.asarray(hits.t),
                         np.asarray(tris.n), np.asarray(rays.dir),
                         GOLD_W, GOLD_H)
    return dhash(img), s


@pytest.mark.slow
def test_sponza_like_golden():
    h, s = _eyelight_dhash("sponza_like", 262144,
                           scenes.sponza_camera())
    assert hamming(h, "2d2d6b4ae9c9eff3") <= HAM_TOL, \
        f"sponza_like eyelight image changed: dhash {h}"
    # AO golden on the same session: covers the incoherent-wave path
    # (secondary-ray sort, calibration, any-hit sweep) end to end.
    from hagrid.render.integrators import render_ao
    import jax
    img, _ = render_ao(s, scenes.sponza_camera(), GOLD_W, GOLD_H,
                       seed=3, n_samples=4)
    img = np.asarray(jax.block_until_ready(img))
    ha = dhash(img)
    assert not s.poll_overflow(recalibrate=False), \
        "AO golden frame dropped occluder work"
    assert hamming(ha, "dcdcecf2b2466636") <= HAM_TOL, \
        f"sponza_like AO image changed: dhash {ha}"


@pytest.mark.slow
def test_san_miguel_like_golden():
    h, _ = _eyelight_dhash("san_miguel_like", 1000000,
                           scenes.san_miguel_camera())
    assert hamming(h, "cccc94b4b2b6b2a2") <= HAM_TOL, \
        f"san_miguel_like eyelight image changed: dhash {h}"
