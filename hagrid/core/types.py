"""Core SoA data types for the ray tracer.

The reference (cg-saarland/hagrid) uses header-only AoS C++ structs
(``vec3``, ``Ray{org,tmin,dir,tmax}``, ``Hit{id,t,u,v}``, ``Tri{v0,e1,e2,n}``;
see reference src/vec.h, src/ray.h, src/tri.h). Here every field is a dense
``(N, ...)`` jnp array (structure-of-arrays), so loads over rays are
contiguous and XLA can fuse elementwise pipelines. Each type is a frozen
dataclass registered as a pytree (``pytree_dataclass``), so it passes
through ``jit`` / ``vmap`` / ``shard_map`` transparently.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree. Fields made with
    ``static_field()`` are pytree metadata (hashed into jit cache keys);
    all others are leaves. Copy with ``dataclasses.replace``."""
    return jax.tree_util.register_dataclass(
        dataclasses.dataclass(frozen=True)(cls))


def static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)

# Sentinel for "no hit" / invalid ids, matches the reference convention of
# -1. Plain int: a jnp value here would initialize the backend at import
# time, before callers can pick a platform.
INVALID_ID = -1


@pytree_dataclass
class Rays:
    """A batch of rays in SoA layout.

    org/dir: f32[N, 3]; tmin/tmax: f32[N].
    """

    org: jnp.ndarray
    dir: jnp.ndarray
    tmin: jnp.ndarray
    tmax: jnp.ndarray

    @property
    def count(self) -> int:
        return self.org.shape[0]

    @staticmethod
    def make(org, dir, tmin=None, tmax=None) -> "Rays":
        org = jnp.asarray(org, jnp.float32)
        dir = jnp.asarray(dir, jnp.float32)
        n = org.shape[0]
        if tmin is None:
            tmin = jnp.zeros((n,), jnp.float32)
        if tmax is None:
            tmax = jnp.full((n,), jnp.inf, jnp.float32)
        return Rays(org=org, dir=dir, tmin=jnp.asarray(tmin, jnp.float32),
                    tmax=jnp.asarray(tmax, jnp.float32))


@pytree_dataclass
class Hits:
    """Closest-hit records, SoA. tri_id == -1 means miss."""

    tri_id: jnp.ndarray  # i32[N]
    t: jnp.ndarray       # f32[N]
    u: jnp.ndarray       # f32[N]
    v: jnp.ndarray       # f32[N]

    @staticmethod
    def none(n: int) -> "Hits":
        return Hits(
            tri_id=jnp.full((n,), INVALID_ID, jnp.int32),
            t=jnp.full((n,), jnp.inf, jnp.float32),
            u=jnp.zeros((n,), jnp.float32),
            v=jnp.zeros((n,), jnp.float32),
        )


@pytree_dataclass
class Triangles:
    """Triangle soup, SoA, precomputed for Moller-Trumbore.

    v0: f32[T,3] first vertex; e1 = v1 - v0; e2 = v2 - v0; n = cross(e1, e2)
    (unnormalized geometric normal — same precompute as reference src/tri.h).
    """

    v0: jnp.ndarray
    e1: jnp.ndarray
    e2: jnp.ndarray
    n: jnp.ndarray

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def from_vertices(v0, v1, v2) -> "Triangles":
        v0 = jnp.asarray(v0, jnp.float32)
        e1 = jnp.asarray(v1, jnp.float32) - v0
        e2 = jnp.asarray(v2, jnp.float32) - v0
        return Triangles(v0=v0, e1=e1, e2=e2, n=jnp.cross(e1, e2))

    @staticmethod
    def from_mesh(vertices, faces) -> "Triangles":
        """vertices f32[V,3], faces i32[T,3] -> Triangles."""
        vertices = jnp.asarray(vertices, jnp.float32)
        faces = jnp.asarray(faces, jnp.int32)
        tri = vertices[faces]  # [T,3,3]
        return Triangles.from_vertices(tri[:, 0], tri[:, 1], tri[:, 2])

    def bounds(self):
        """Per-triangle AABBs: (lo f32[T,3], hi f32[T,3])."""
        v1 = self.v0 + self.e1
        v2 = self.v0 + self.e2
        lo = jnp.minimum(jnp.minimum(self.v0, v1), v2)
        hi = jnp.maximum(jnp.maximum(self.v0, v1), v2)
        return lo, hi


@pytree_dataclass
class AABB:
    """Axis-aligned bounding box; lo/hi are f32[3] (or batched f32[...,3])."""

    lo: jnp.ndarray
    hi: jnp.ndarray

    @staticmethod
    def of_points(pts) -> "AABB":
        pts = jnp.asarray(pts, jnp.float32)
        return AABB(lo=pts.min(axis=0), hi=pts.max(axis=0))

    @staticmethod
    def of_triangles(tris: Triangles) -> "AABB":
        lo, hi = tris.bounds()
        return AABB(lo=lo.min(axis=0), hi=hi.max(axis=0))

    def extents(self) -> jnp.ndarray:
        return self.hi - self.lo

    def half_area(self) -> jnp.ndarray:
        """SAH surface-area metric (reference src/bbox.h half_area())."""
        e = self.extents()
        return e[..., 0] * (e[..., 1] + e[..., 2]) + e[..., 1] * e[..., 2]

    def pad(self, eps: float = 1e-4) -> "AABB":
        """Slightly enlarged box so boundary triangles bin robustly."""
        d = self.extents() * eps + eps
        return AABB(lo=self.lo - d, hi=self.hi + d)
