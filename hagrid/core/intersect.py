"""Vectorized ray/primitive intersection tests.

Re-derivations of the reference's device-side tests (Moller-Trumbore in
reference src/prims.h / intersect.h, ray-AABB slab test in src/traverse.cu)
as pure batched jnp functions: every function maps over leading batch axes so
it vectorizes across rays under jit/vmap.
"""

from __future__ import annotations

import jax.numpy as jnp

# Epsilon for Moller-Trumbore determinant test — rays parallel to the
# triangle plane are treated as misses (same policy as the reference).
MT_EPS = 1e-9


def moller_trumbore(org, dir, v0, e1, e2, tmin, tmax):
    """Batched Moller-Trumbore.

    All of org/dir/v0/e1/e2 are f32[..., 3] broadcastable against each other;
    tmin/tmax f32[...]. Returns (hit_mask bool[...], t, u, v).
    """
    pvec = jnp.cross(dir, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # No backface culling (the reference traces both sides).
    inv_det = jnp.where(jnp.abs(det) > MT_EPS, 1.0 / det, 0.0)
    tvec = org - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dir * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > MT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return hit, t, u, v


def slab_test(org, inv_dir, lo, hi, tmin, tmax):
    """Batched ray-AABB slab test.

    org/inv_dir f32[...,3]; lo/hi f32[...,3] broadcastable; returns
    (enter f32[...], exit f32[...], hit bool[...]). inv_dir is 1/dir with
    +-inf for zero components (IEEE semantics make the slab test robust).
    """
    t0 = (lo - org) * inv_dir
    t1 = (hi - org) * inv_dir
    # 0 * inf = NaN when an origin component sits exactly on a slab plane
    # with a zero direction component; the ray then lies ON the plane, so
    # treating that axis as always-overlapping (-inf/+inf) is the
    # conservative-correct resolution. NaN would otherwise propagate
    # through min/max and falsely miss the whole box.
    tnear = jnp.where(jnp.isnan(t0 * t1), -jnp.inf, jnp.minimum(t0, t1))
    tfar = jnp.where(jnp.isnan(t0 * t1), jnp.inf, jnp.maximum(t0, t1))
    enter = jnp.maximum(jnp.max(tnear, axis=-1), tmin)
    exit_ = jnp.minimum(jnp.min(tfar, axis=-1), tmax)
    return enter, exit_, enter <= exit_


def safe_inv_dir(dir):
    """1/dir with exact zeros mapped to +inf (sign preserved for -0.0)."""
    return jnp.where(dir != 0.0, 1.0 / jnp.where(dir != 0.0, dir, 1.0),
                     jnp.copysign(jnp.inf, dir))
