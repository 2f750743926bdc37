"""Multi-card ray sharding over a 1-D device mesh.

The reference is strictly single-GPU (no NCCL/MPI anywhere — SURVEY.md §2);
multi-card tracing is a new capability of this framework. Ray tracing is
embarrassingly parallel across rays, so the design is pure data parallelism:
the grid + triangles are replicated per card (they are rebuilt per frame and
small relative to device memory), rays/hits are sharded along a 1-D
``rays`` mesh axis, and the only collective is the implicit all-gather when
the host assembles the final image. The mesh follows the algorithm alone:
the cards of one host are joined all to all. `shard_map` keeps the per-card
trace identical to the single-card path — same kernels, no SPMD-specific
code inside.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

RAYS_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAYS_AXIS,))


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def shard_trace(trace_fn, mesh: Mesh):
    """Wrap a batched ``trace_fn(grid, rays) -> Hits`` to run ray-sharded.

    grid (and the triangles inside it) replicate; rays/hits shard on axis 0.
    The returned callable requires ray count divisible by mesh size (pad
    with dead rays via `pad_rays` first).
    """
    sharded = jax.shard_map(
        trace_fn, mesh=mesh,
        in_specs=(P(), P(RAYS_AXIS)),
        out_specs=P(RAYS_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded)


def pad_rays(rays, multiple: int):
    """Pad the ray batch with dead rays (tmax=0) to a multiple; returns
    (padded_rays, original_count)."""
    from ..core.types import Rays

    n = rays.count
    m = pad_to_multiple(n, multiple)
    if m == n:
        return rays, n
    pad = m - n
    z3 = jnp.zeros((pad, 3), jnp.float32)
    return Rays(
        org=jnp.concatenate([rays.org, z3]),
        dir=jnp.concatenate([rays.dir, jnp.tile(
            jnp.asarray([[1.0, 0, 0]], jnp.float32), (pad, 1))]),
        tmin=jnp.concatenate([rays.tmin, jnp.zeros((pad,), jnp.float32)]),
        tmax=jnp.concatenate([rays.tmax, jnp.zeros((pad,), jnp.float32)]),
    ), n
