"""Single-level uniform grid: the minimum end-to-end acceleration structure.

Counterpart of the reference's top-level binning pass (src/build.cu:
count_refs → scan → emit_refs) restructured as static-shape array
passes (SURVEY.md §7): no atomics, no scatters — per-triangle
voxel-range counts feed a vectorized binary-search expansion, then a
single device-wide stable sort by cell id
yields cell-contiguous ref lists, and segment boundaries come from
searchsorted. Everything is static-shape: `dims` and the ref capacity are
host-side (compile-time) values derived from the density heuristic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Triangles, pytree_dataclass, static_field
from ..ops.segment import expand_by_counts, segment_starts, sort_pairs
from ..utils.config import density_dims


@pytree_dataclass
class UniformGrid:
    """SoA uniform grid. dims is static; arrays have static capacities.

    ref_ids rows >= total_refs are INVALID (-1) and sorted to the back.
    """

    dims: tuple = static_field()
    bbox_lo: jnp.ndarray   # f32[3]
    bbox_hi: jnp.ndarray   # f32[3]
    cell_starts: jnp.ndarray  # i32[C+1], C = prod(dims)
    ref_ids: jnp.ndarray      # i32[R_cap]
    total_refs: jnp.ndarray   # i32[] — live refs; > R_cap means overflow
    tris: Triangles

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims))

    @property
    def fine_dims(self) -> tuple:
        return self.dims

    @property
    def cell_size(self) -> jnp.ndarray:
        return (self.bbox_hi - self.bbox_lo) / jnp.asarray(
            self.dims, jnp.float32)

    def overflowed(self) -> bool:
        return int(self.total_refs) > self.ref_ids.shape[0]


def tri_voxel_ranges(tris: Triangles, bbox_lo, bbox_hi, dims):
    """Conservative AABB binning: per-tri inclusive voxel range [lo, hi].

    Matches the reference's binning overlap test at the conservative end
    (tri AABB vs cell); exact SAT pruning would only shrink ref lists.
    """
    d = jnp.asarray(dims, jnp.float32)
    inv_cs = d / (bbox_hi - bbox_lo)
    tlo, thi = tris.bounds()
    lo = jnp.floor((tlo - bbox_lo) * inv_cs).astype(jnp.int32)
    hi = jnp.floor((thi - bbox_lo) * inv_cs).astype(jnp.int32)
    dmax = jnp.asarray(dims, jnp.int32) - 1
    lo = jnp.clip(lo, 0, dmax)
    hi = jnp.clip(hi, 0, dmax)
    return lo, hi


def tri_box_overlap(v0, v1, v2, box_lo, box_hi):
    """Exact separating-axis triangle/AABB test, vectorized over pairs.

    Counterpart of the reference's exact binning overlap (src/build.cu
    prims — SURVEY.md §2 triangle row; Akenine-Moller's 13-axis SAT).
    All args (N, 3); returns bool (N,). The 3 box face normals are
    assumed pre-satisfied (callers test only cells inside the tri's
    AABB voxel range), leaving the tri plane + 9 edge cross axes."""
    c = 0.5 * (box_lo + box_hi)
    # Relative epsilon pad: f32 cancellation on large coordinates must
    # err toward keeping a pair (conservative completeness).
    h = 0.5 * (box_hi - box_lo) * 1.0001 + 1e-6
    p0 = v0 - c
    p1 = v1 - c
    p2 = v2 - c
    f0 = p1 - p0
    f1 = p2 - p1
    f2 = p0 - p2

    def sep(ax, ay, az):
        r = (h[:, 0] * jnp.abs(ax) + h[:, 1] * jnp.abs(ay)
             + h[:, 2] * jnp.abs(az))
        q0 = ax * p0[:, 0] + ay * p0[:, 1] + az * p0[:, 2]
        q1 = ax * p1[:, 0] + ay * p1[:, 1] + az * p1[:, 2]
        q2 = ax * p2[:, 0] + ay * p2[:, 1] + az * p2[:, 2]
        qmin = jnp.minimum(jnp.minimum(q0, q1), q2)
        qmax = jnp.maximum(jnp.maximum(q0, q1), q2)
        return (qmin > r) | (qmax < -r)

    z = jnp.zeros_like(f0[:, 0])
    separated = z > 1.0  # all-False
    for f in (f0, f1, f2):
        # a = e_x x f, e_y x f, e_z x f
        separated |= sep(z, -f[:, 2], f[:, 1])
        separated |= sep(f[:, 2], z, -f[:, 0])
        separated |= sep(-f[:, 1], f[:, 0], z)
    # Triangle plane.
    n = jnp.cross(f0, f1)
    separated |= sep(n[:, 0], n[:, 1], n[:, 2])
    return ~separated


def linear_cell(ix, iy, iz, dims):
    """x-fastest linearization, matching voxel -> entry indexing everywhere."""
    return (iz * dims[1] + iy) * dims[0] + ix


@functools.partial(jax.jit, static_argnames=("dims", "ref_capacity"))
def _build(tris: Triangles, bbox_lo, bbox_hi, dims, ref_capacity):
    lo, hi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, dims)
    span = hi - lo + 1
    counts = span[:, 0] * span[:, 1] * span[:, 2]

    tri_idx, rank, valid, total = expand_by_counts(counts, ref_capacity)
    s = span[tri_idx]
    l = lo[tri_idx]
    # Decode rank -> (dx, dy, dz) within the tri's voxel box (x fastest).
    dx = rank % s[:, 0]
    rem = rank // s[:, 0]
    dy = rem % s[:, 1]
    dz = rem // s[:, 1]
    cell = linear_cell(l[:, 0] + dx, l[:, 1] + dy, l[:, 2] + dz, dims)

    num_cells = int(np.prod(dims))
    key = jnp.where(valid, cell, num_cells)
    skeys, srefs = sort_pairs(key, jnp.where(valid, tri_idx, -1))
    starts = segment_starts(skeys, num_cells)
    return starts, srefs, total


def build_uniform(tris: Triangles, density: float = 2.4,
                  ref_capacity: int | None = None,
                  dims: tuple | None = None) -> UniformGrid:
    """Host wrapper: derives static dims/capacity, retries on overflow."""
    if tris.count == 0:
        # Degenerate but legal: one empty unit-box cell, every ray misses.
        return UniformGrid(dims=(1, 1, 1),
                           bbox_lo=jnp.zeros(3, jnp.float32),
                           bbox_hi=jnp.ones(3, jnp.float32),
                           cell_starts=jnp.zeros(2, jnp.int32),
                           ref_ids=jnp.full(1, -1, jnp.int32),
                           total_refs=jnp.int32(0), tris=tris)
    tlo, thi = jax.device_get(tris.bounds())
    lo = tlo.min(0)
    hi = thi.max(0)
    pad = (hi - lo) * 1e-4 + 1e-4
    lo = lo - pad
    hi = hi + pad
    n = tris.count
    if dims is None:
        dims = density_dims(hi - lo, n, density)
    if ref_capacity is None:
        ref_capacity = max(1024, int(n * 4))
    bbox_lo = jnp.asarray(lo, jnp.float32)
    bbox_hi = jnp.asarray(hi, jnp.float32)
    while True:
        starts, refs, total = _build(tris, bbox_lo, bbox_hi, dims,
                                     ref_capacity)
        t = int(jax.device_get(total))
        if t <= ref_capacity:
            break
        ref_capacity = int(t * 1.25)  # recompile with room to spare
    return UniformGrid(dims=dims, bbox_lo=bbox_lo, bbox_hi=bbox_hi,
                       cell_starts=starts, ref_ids=refs, total_refs=total,
                       tris=tris)


def uniform_lookup(grid: UniformGrid, voxel):
    """Grid-protocol lookup for the wavefront tracer (module-level so jit
    caches on the function identity)."""
    cell = linear_cell(voxel[:, 0], voxel[:, 1], voxel[:, 2], grid.dims)
    return cell, voxel, voxel


def trace_uniform_fast(grid: UniformGrid, rays, any_hit: bool = False):
    """Compacted round-based wavefront trace (host-orchestrated)."""
    from ..ops import wavefront

    return wavefront.trace(grid, uniform_lookup, rays, any_hit=any_hit)


@functools.partial(jax.jit, static_argnames=("refs_per_iter", "any_hit"))
def trace_uniform(grid: UniformGrid, rays, refs_per_iter: int = 8,
                  any_hit: bool = False):
    """Wavefront (lockstep) traversal of the uniform grid."""
    from ..ops.wavefront import trace_wavefront

    def lookup(voxel):
        cell = linear_cell(voxel[:, 0], voxel[:, 1], voxel[:, 2], grid.dims)
        return cell, voxel, voxel

    return trace_wavefront(rays, grid.tris, lookup, grid.cell_starts,
                           grid.ref_ids, grid.bbox_lo, grid.bbox_hi,
                           grid.dims, refs_per_iter=refs_per_iter,
                           any_hit=any_hit)
