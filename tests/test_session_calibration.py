"""RenderSession demand-calibrated block budgets: the second frame of a
wave shape runs at ~demand * margin and must agree with the first."""

import numpy as np

from hagrid import scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Triangles
from hagrid.render.session import RenderSession


def test_calibrated_budget_matches_first_frame():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, structure="packet", verts=v)
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block")

    h1 = s.trace(rays, coherent=True)       # calibrating frame
    key = (False, True, rays.count, None)
    assert key in s._bmax_cal
    bmax, rowmax = s._bmax_cal[key]
    assert bmax % 128 == 0 and bmax >= 256

    h2 = s.trace(rays, coherent=True)       # calibrated frame
    assert (np.asarray(h1.tri_id) == np.asarray(h2.tri_id)).all()
    t1, t2 = np.asarray(h1.t), np.asarray(h2.t)
    finite = np.isfinite(t1)
    assert np.allclose(t1[finite], t2[finite])
    assert not bool(np.asarray(s.trace_overflow))


def test_overflowed_wave_converges_to_complete_oracle_match():
    """A wave whose first probe OVERFLOWS must be
    re-traced at grown budgets until complete, and the completed result
    must match the oracle; the session's accumulated overflow flag must
    end CLEAR.

    The Cornell box on a forced-fine 64^3 grid has a measured peak block
    demand of 151 — above trace_sweep's 128-block default/floor budget —
    so calibration's FIRST probe genuinely overflows (exactly round 4's
    failure mode: budgets set from an underestimating probe) and the
    retry loop must grow the budget and verify the wave completes."""
    from hagrid import oracle
    from hagrid.grid import packet

    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, structure="packet", verts=v)
    # Swap in the fine grid (fixed capacity: skips the build's overflow
    # retry recompiles; 131328 is the measured settled capacity).
    s.grid = packet.build_packet(tris, dims=(64, 64, 64),
                                 ref_capacity=131328, check=False)
    s._bmax_cal.clear()
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block")

    # Sanity: the floor budget genuinely overflows on this wave.
    from hagrid.ops.sweep_trace import trace_sweep
    _, ovf = trace_sweep(s.grid, rays, coherent=True, bmax=128,
                         return_overflow=True)
    assert bool(np.asarray(ovf))

    hits = s.trace(rays, coherent=True)
    bmax, _ = s._bmax_cal[(False, True, rays.count, None)]
    assert bmax > 128                     # calibration grew the budget
    assert not bool(np.asarray(s.trace_overflow))

    ref = oracle.closest_hit(rays, tris)
    assert (np.asarray(hits.tri_id) == np.asarray(ref.tri_id)).all()
    ft = np.isfinite(np.asarray(ref.t))
    assert np.allclose(np.asarray(hits.t)[ft], np.asarray(ref.t)[ft],
                       rtol=1e-5, atol=1e-5)


def test_poll_overflow_grows_offending_budget():
    import jax.numpy as jnp

    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    s = RenderSession.create(tris, structure="packet", verts=v)
    rays = primary_rays(scenes.cornell_camera(), 32, 32, order="block")
    s.trace(rays, coherent=True)
    assert s.poll_overflow() is False     # clean wave: no action
    key = (False, True, rays.count, None)
    bmax0, _ = s._bmax_cal[key]

    # Simulate a steady-state frame whose demand outgrew its budget:
    # poll must GROW that wave's budgets (no re-probe) and clear its
    # flag so the caller's re-run traces complete.
    s._ovf[key] = jnp.int32(1)
    s.trace_overflow = jnp.int32(1)
    assert s.poll_overflow() is True
    bmax1, _ = s._bmax_cal[key]
    assert bmax1 >= 2 * bmax0             # grown one rung step
    assert key not in s._ovf              # flag cleared for the re-run
    assert s.trace_overflow is None
    assert s.poll_overflow() is False     # nothing still overflowing
