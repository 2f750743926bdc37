"""chip_smoke.py and bench.py on the CPU: both refuse to report without a
GPU, and chip_smoke's phases run end to end at a tiny size (a rehearsal
of the card run: control flow, comparisons, the sharded path on virtual
devices)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("args", [
    ["chip_smoke.py"],
    ["chip_smoke.py", "--cards", "4"],
    ["bench.py", "--quick", "--workload", "primary"],
])
def test_refuses_without_gpu(args):
    r = _run(args, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout
    assert "no GPU" in r.stderr


def test_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def cornell():
    return chip_smoke.load("cornell", 64)


def test_rehearse_oracle_phase(cornell):
    chip_smoke.phase_oracle(cornell, n_rays=512)


def test_rehearse_main_path_phase(cornell):
    chip_smoke.phase_main_path(cornell, ao_samples=2, bounces=2,
                               dyn_frames=2)


def test_rehearse_structures_phase():
    chip_smoke.phase_structures(size=32)


def test_rehearse_sharded_phase(cornell):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    chip_smoke.phase_sharded(cornell, 4)


def test_oracle_agreement_rejects_non_ties():
    """A miss where the oracle hits is a disagreement, not a tie."""
    import numpy as np

    from hagrid import scenes
    from hagrid.core.camera import primary_rays
    from hagrid.core.types import Triangles

    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    rays = primary_rays(scenes.cornell_camera(), 4, 4)
    ref_id = np.arange(16, dtype=np.int32) % 4
    ref_t = np.ones(16, np.float32)
    got_id = ref_id.copy()
    got_id[3] = -1
    with pytest.raises(AssertionError):
        chip_smoke.oracle_agreement(got_id, ref_t, ref_id, ref_t, rays,
                                    tris, "rigged", 0.5)
    chip_smoke.oracle_agreement(ref_id, ref_t, ref_id, ref_t, rays, tris,
                                "identical", 1.0)
