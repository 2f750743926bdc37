"""Integrators: primary/eyelight, ambient occlusion, shadows, path tracing.

The reference's app layer shades trivially (eye-light) and its benchmark
generates AO/shadow secondary rays (SURVEY.md §3.5, BASELINE configs #2-4).
Secondary waves are ORIGIN-MAJOR Morton-sorted before the sweep tracer
(round 4, measured on a Sponza 1M-ray AO wave): the per-tile origin
DEPTH spread is what blows up incoherent frusta, and a 10-bit
origin-major sort cuts block demand 173.6k -> 103.7k dense / enables
the compact planner's 41-59k. Octant-MAJOR (direction-first) sorting
remains measured WORSE than caller order (+33% demand — it scatters
tile origins); direction purity comes from the tracer's own (axis,
sign) binning, which preserves the sorted order within groups.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Rays
from ..ops import sortrays
from .sampling import cosine_hemisphere, hit_points_normals

# Self-intersection offsets: scaled by hit distance to stay robust across
# scene scales (same role as the reference's ray epsilon).
EPS_REL = 1e-3
EPS_ABS = 1e-4


def _spawn(p, n, d, t_near, t_far):
    org = p + n * (EPS_REL * jnp.linalg.norm(p, axis=-1, keepdims=True)
                   + EPS_ABS)
    return Rays(org=org, dir=d, tmin=jnp.full(d.shape[:1], t_near),
                tmax=t_far)


def trace_sorted(session, rays: Rays, any_hit: bool = False,
                 sort: str | bool = "origin", cal_key=None):
    """Incoherent-wave entry point with coherence sorting.

    sort="origin" (default): 10-bit origin-major Morton sort — see the
    module docstring for the measured rationale. sort="octant":
    direction-octant-major (measured worse for camera-derived waves;
    kept for waves with no origin locality). sort=False: raw caller
    order."""
    if not sort:
        return session.trace(rays, any_hit=any_hit, cal_key=cal_key)
    grid = session.grid
    om = sort == "origin"
    sorted_rays, perm = sortrays.sort_rays(
        rays, grid.bbox_lo, grid.bbox_hi,
        bits=10 if om else 7, origin_major=om)
    hits = session.trace(sorted_rays, any_hit=any_hit, cal_key=cal_key)
    return sortrays.unsort(hits, perm)


def ao_max_dist(grid) -> float:
    """Default AO ray length: a tenth of the scene's largest extent."""
    return float(jnp.max(grid.bbox_hi - grid.bbox_lo)) * 0.1


def ao_wave(tri_n, rays: Rays, hits, key, max_dist: float):
    """One AO sample's secondary wave: cosine-hemisphere rays from each
    hit point, dead (tmax 0) for primary misses. Returns (rays, found)."""
    p, n, found = hit_points_normals(rays, hits, tri_n)
    d = cosine_hemisphere(key, n)
    tmax = jnp.where(found, max_dist, 0.0)
    return _spawn(p, n, d, 0.0, tmax), found


def ambient_occlusion(session, rays: Rays, hits, key, n_samples: int = 4,
                      max_dist: float | None = None):
    """AO estimate in [0,1] per ray (1 = fully open). Misses get 0."""
    if max_dist is None:
        max_dist = ao_max_dist(session.grid)
    acc = jnp.zeros(rays.count, jnp.float32)
    for k in jax.random.split(key, n_samples):
        sec, found = ao_wave(session.grid.tris.n, rays, hits, k, max_dist)
        # ONE calibration key for all samples: they are iid draws of
        # the same wave shape, so budgets transfer (within margin);
        # a sample that still outgrows them sets its per-key overflow
        # flag and poll_overflow grows the shared budget.
        occ = trace_sorted(session, sec, any_hit=True,
                           cal_key="ao").tri_id >= 0
        acc = acc + jnp.where(found & ~occ, 1.0, 0.0)
    return acc / n_samples


def shadow(session, rays: Rays, hits, light_pos):
    """Hard shadow visibility toward a point light. Misses get 0."""
    tri_n = session.grid.tris.n
    p, n, found = hit_points_normals(rays, hits, tri_n)
    lp = jnp.asarray(light_pos, jnp.float32)
    to_l = lp[None, :] - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    d = to_l / (dist[:, None] + 1e-20)
    cos = jnp.maximum(jnp.sum(n * d, axis=-1), 0.0)
    tmax = jnp.where(found & (cos > 0), dist * (1.0 - 2.0 * EPS_REL), 0.0)
    sec = _spawn(p, n, d, 0.0, tmax)
    blocked = trace_sorted(session, sec, any_hit=True,
                           cal_key="shadow").tri_id >= 0
    return jnp.where(found & ~blocked, cos, 0.0)


def _to_scanline(flat, width: int, height: int):
    """Undo primary_rays block ordering (no-op when it fell back)."""
    if width % 32 or height % 32:
        return flat
    from ..core.camera import block_index
    import jax.numpy as jnp
    return jnp.zeros_like(flat).at[
        jnp.asarray(block_index(width, height))].set(flat)


def render_ao(session, cam, width: int, height: int, seed: int = 0,
              n_samples: int = 4):
    """Primary + AO frame (AO part of BASELINE config #2)."""
    from ..core.camera import primary_rays

    rays = primary_rays(cam, width, height, order="block")
    hits = session.trace(rays, coherent=True)
    key = jax.random.PRNGKey(seed)
    ao = ambient_occlusion(session, rays, hits, key, n_samples=n_samples)
    img = jnp.repeat(_to_scanline(ao, width, height)[:, None],
                     3, axis=1).reshape(height, width, 3)
    return img, hits


def path_trace(session, cam, width: int, height: int, seed: int = 0,
               spp: int = 1, max_bounces: int = 4, sky=1.0,
               albedo: float = 0.7):
    """Diffuse (Lambertian) path tracer with bounce compaction — BASELINE
    config #3 (San Miguel workload). Constant sky light, grey albedo.

    Bounce waves keep their inherited pixel order (measured best; see
    module docstring) and dead rays compact via tmax=0 masking into
    planner-skipped tiles; live rays carry a throughput that attenuates
    by albedo."""
    from ..core.camera import primary_rays

    n = width * height
    radiance = jnp.zeros((n,), jnp.float32)
    key = jax.random.PRNGKey(seed)
    tri_n = session.grid.tris.n

    for s in range(spp):
        key, kj = jax.random.split(key)
        jitter = jax.random.uniform(kj, (n, 2))
        rays = primary_rays(cam, width, height, jitter=jitter,
                            order="block")
        throughput = jnp.ones((n,), jnp.float32)
        live = jnp.ones((n,), bool)
        for bounce in range(max_bounces):
            # Bounces >= 1 share one calibration key (see
            # ambient_occlusion): deeper bounces that outgrow the
            # first bounce's budgets are caught by their overflow flag
            # and grown at the next poll, instead of paying a fresh
            # compile + probe per bounce depth.
            hits = (session.trace(rays, coherent=True) if bounce == 0
                    else trace_sorted(session, rays, cal_key="path"))
            found = hits.tri_id >= 0
            # Escaped rays collect the sky.
            radiance = radiance + jnp.where(live & ~found,
                                            throughput * sky, 0.0)
            live = live & found
            throughput = throughput * albedo
            p, nrm, _ = hit_points_normals(rays, hits, tri_n)
            key, kd = jax.random.split(key)
            d = cosine_hemisphere(kd, nrm)
            tmax = jnp.where(live, jnp.inf, 0.0)  # dead rays don't trace
            rays = _spawn(p, nrm, d, 0.0, tmax)
        # Rays still alive after max bounces contribute nothing (biased,
        # same cutoff policy as typical benchmark tracers).
    img = (_to_scanline(radiance / spp, width, height)
           )[:, None].repeat(3, 1).reshape(height, width, 3)
    return img
