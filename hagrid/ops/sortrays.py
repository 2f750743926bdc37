"""Ray coherence sorting.

The reference relies on SIMT to absorb incoherent secondary rays
(SURVEY.md §3.5 — divergence is its pain point); the packet tracer makes
coherence explicit: secondary rays are sorted by (direction octant, origin
Morton code) before tracing so lockstep lanes march through similar cells,
and results are scattered back through the permutation. BASELINE.json names
this ray sorting/compaction as a first-class component.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Rays


def _part1by2(x):
    """Spread 10 bits to every 3rd bit (Morton helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(ix, iy, iz):
    return (_part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2))


def coherence_keys(rays: Rays, bbox_lo, bbox_hi, bits: int = 7,
                   origin_major: bool = False):
    """Sort key. Two modes:

    - octant-major (default, bits<=9): direction octant (3 bits) then
      origin Morton (3*bits). Measured WORSE than caller order for
      camera-derived waves (+33% sweep block demand): direction
      coherence is not what bounds the sweep planner's frusta.
    - origin_major (bits<=10): origin Morton only. For hemisphere
      waves (AO, diffuse bounces) the frustum blowup is partly the
      per-tile origin DEPTH spread (hit points of one image block lie
      at any depth). Measured on a Sponza 1M-ray AO wave (block
      demand, tile=512): caller order 173.6k; 24-group direction
      sub-binning 284k (WORSE — it scatters origins); 10-bit
      origin-major sort 103.7k, saturating already at 5 bits. The
      downstream (axis, sign) binning keeps the stable sorted order,
      so tiles stay direction-pure AND origin-tight."""
    scale = (1 << bits) / (bbox_hi - bbox_lo + 1e-20)
    q = jnp.clip(((rays.org - bbox_lo) * scale).astype(jnp.int32), 0,
                 (1 << bits) - 1)
    m = morton3(q[:, 0], q[:, 1], q[:, 2])
    if origin_major:
        return m
    d = rays.dir
    octant = ((d[:, 0] >= 0).astype(jnp.int32)
              | ((d[:, 1] >= 0).astype(jnp.int32) << 1)
              | ((d[:, 2] >= 0).astype(jnp.int32) << 2))
    return (octant << (3 * bits)) | m


def sort_rays(rays: Rays, bbox_lo, bbox_hi, mask=None, bits: int = 7,
              origin_major: bool = False):
    """Returns (sorted rays, perm) — apply results back as out[perm] = res.

    mask: optional bool[N]; False rays sort to the back (combined
    sort+compaction for wavefront bounces)."""
    keys = coherence_keys(rays, bbox_lo, bbox_hi, bits=bits,
                          origin_major=origin_major)
    if mask is not None:
        keys = jnp.where(mask, keys, jnp.int32(2 ** 30))
    idx = jnp.arange(rays.count, dtype=jnp.int32)
    _, perm = jax.lax.sort((keys, idx), num_keys=1, is_stable=True)
    sorted_rays = jax.tree.map(lambda a: a[perm], rays)
    return sorted_rays, perm


def unsort(values, perm):
    """Scatter results (aligned with sorted rays) back to original order:
    row i of `values` belongs to original ray perm[i]."""
    def one(a):
        out = jnp.zeros_like(a)
        return out.at[perm].set(a)
    return jax.tree.map(one, values)
