"""IO: OBJ round-trip, PNG writer, grid checkpoint round-trip, CLI."""

import os
import subprocess
import sys

import numpy as np

from hagrid import scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Triangles
from hagrid.io.checkpoint import load_grid, save_grid
from hagrid.io.image import write_png, write_ppm
from hagrid.io.obj import load_obj, save_obj
from hagrid.render.session import RenderSession
from hagrid.utils.config import BuildParams

from test_uniform_grid import assert_hits_match

SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=1, expansion_passes=1, buddy_passes=1)


def test_obj_roundtrip(tmp_path):
    v, f = scenes.cornell_box()
    p = str(tmp_path / "c.obj")
    save_obj(p, v, f)
    v2, f2 = load_obj(p)
    np.testing.assert_allclose(v, v2, rtol=1e-6)
    np.testing.assert_array_equal(f, f2)


def test_png_ppm_writers(tmp_path):
    img = np.random.default_rng(0).random((8, 16, 3)).astype(np.float32)
    write_png(str(tmp_path / "x.png"), img)
    write_ppm(str(tmp_path / "x.ppm"), img)
    assert (tmp_path / "x.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "x.ppm").read_bytes()[:2] == b"P6"


def test_grid_checkpoint_roundtrip(tmp_path):
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, SMALL)
    p = str(tmp_path / "g.npz")
    save_grid(p, s.grid)
    g2 = load_grid(p)
    rays = primary_rays(scenes.cornell_camera(), 24, 24)
    from hagrid.ops.sweep_trace import trace_sweep
    got = trace_sweep(g2, rays, tile=128, slab=4, bmax=2048)
    want = s.trace(rays)
    assert_hits_match(got, want)

    from hagrid.grid.irregular import build_irregular, \
        trace_irregular_fast
    gi = build_irregular(tris)
    save_grid(p, gi)
    gi2 = load_grid(p)
    got_i = trace_irregular_fast(gi2, rays)
    assert_hits_match(got_i, want)


def test_cli_render_and_stats(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = str(tmp_path / "r.png")
    r = subprocess.run(
        [sys.executable, "-m", "hagrid.cli", "render", "--scene",
         "cornell", "--size", "32x32", "--platform", "cpu", "--out", out,
         "--levels", "2", "--merge-passes", "1", "--expansion-passes", "1"],
        capture_output=True, text=True, timeout=500, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    assert os.path.exists(out)
    assert "hit fraction" in r.stdout


def test_load_scene_obj_path(tmp_path):
    v, f = scenes.cornell_box()
    p = str(tmp_path / "scene.obj")
    save_obj(p, v, f)
    v2, f2, cam = scenes.load_scene(p)
    assert len(f2) == len(f)
    assert cam.fov_deg > 0


def test_stage_timer():
    from hagrid.utils.profiling import StageTimer, timed

    st = StageTimer()
    with st.stage("a"):
        sum(range(1000))
    with st.stage("b"):
        pass
    rep = st.report()
    assert "a" in rep and "b" in rep and "%" in rep
    dt = timed(lambda: sum(range(100)), warmup=1, iters=2)
    assert dt >= 0
