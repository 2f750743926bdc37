"""Checkified planning sanitizer (SURVEY §5 sanitizers row)."""

import numpy as np

from hagrid import scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Triangles
from hagrid.grid.packet import build_packet
from hagrid.utils.sanitize import check_sweep_plan


def test_sweep_plan_sanitizer_clean():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_packet(tris)
    rays = primary_rays(scenes.cornell_camera(), 64, 64)
    stats = check_sweep_plan(grid, rays, tile=128, bmax=512)
    assert stats["ranges"] > 0
    assert stats["blocks"] > 0
    assert stats["units"] <= stats["demand_units"]


def test_sweep_plan_sanitizer_degenerate_rays():
    """NaN-free planning even for degenerate directions (zero dir)."""
    import jax.numpy as jnp

    from hagrid.core.types import Rays

    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    grid = build_packet(tris)
    n = 128
    org = jnp.zeros((n, 3), jnp.float32) + 0.5
    d = jnp.zeros((n, 3), jnp.float32).at[:, 2].set(
        jnp.where(jnp.arange(n) % 2 == 0, 1.0, 0.0))
    rays = Rays(org=org, dir=d, tmin=jnp.zeros(n),
                tmax=jnp.full(n, 10.0))
    stats = check_sweep_plan(grid, rays, tile=128, bmax=512)
    assert stats["demand_units"] >= 0
