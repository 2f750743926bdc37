"""The Triton sweep kernel (Pallas interpreter on the CPU) against the
plain-XLA sweep, its early-out, its lowering for CUDA, and the rule that
trace_sweep never picks interpret mode by itself."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hagrid import oracle, scenes
from hagrid.core.camera import primary_rays
from hagrid.core.types import Rays, Triangles
from hagrid.grid.packet import build_packet
from hagrid.ops import sweep_trace as st
from hagrid.ops.sweep_trace import trace_sweep


def _scene(name):
    if name == "cornell":
        v, f = scenes.cornell_box()
    else:
        v, f = scenes.random_soup(300, seed=3)
    tris = Triangles.from_mesh(v, f)
    return tris, build_packet(tris, dims=(5, 6, 4))


def _random_rays(n, tris, seed):
    lo = np.asarray(tris.v0).min(0)
    hi = np.asarray(tris.v0).max(0)
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays.make(org, d)


@pytest.mark.parametrize("scene", ["cornell", "soup"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain_sweep(scene, any_hit):
    """Same plan, both implementations: closest-hit ids and t agree, and
    any-hit occlusion agrees (any-hit ids are SOME occluder, which the
    kernel's early-out may pick differently). 1000 rays at tile 256
    leave padding lanes in the last tile and 4 ray sub-tiles per tile."""
    tris, g = _scene(scene)
    rays = _random_rays(1000, tris, seed=5)
    kw = dict(any_hit=any_hit, tile=256, slab=2, bmax=1024)
    plain = trace_sweep(g, rays, impl="xla", **kw)
    kern = trace_sweep(g, rays, impl="triton", interpret=True, **kw)
    pid, kid = np.asarray(plain.tri_id), np.asarray(kern.tri_id)
    if any_hit:
        np.testing.assert_array_equal(kid >= 0, pid >= 0)
        want = np.asarray(oracle.any_hit(rays, tris))
        np.testing.assert_array_equal(kid >= 0, want)
    else:
        np.testing.assert_array_equal(kid, pid)
        hit = pid >= 0
        np.testing.assert_allclose(np.asarray(kern.t)[hit],
                                   np.asarray(plain.t)[hit], rtol=1e-6)
        np.testing.assert_array_equal(
            kid, np.asarray(oracle.closest_hit(rays, tris).tri_id))


def test_kernel_dead_tile_and_coherent_wave():
    """A coherent primary wave whose first tile is all dead (tmax 0) and
    whose length leaves padding lanes: the dead tile gets no blocks and
    reports misses; the rest matches the plain sweep."""
    tris, g = _scene("cornell")
    rays = primary_rays(scenes.cornell_camera(), 30, 30)
    dead = jnp.arange(rays.count) < 128
    rays = Rays(org=rays.org, dir=rays.dir, tmin=rays.tmin,
                tmax=jnp.where(dead, 0.0, rays.tmax))
    kw = dict(coherent=True, tile=128, bmax=512)
    kern = trace_sweep(g, rays, impl="triton", interpret=True, **kw)
    plain = trace_sweep(g, rays, impl="xla", **kw)
    kid = np.asarray(kern.tri_id)
    assert (kid[:128] == -1).all()
    assert (kid[128:] >= 0).mean() > 0.9
    np.testing.assert_array_equal(kid, np.asarray(plain.tri_id))


def _one_block(tris, g, n_rays, best_t):
    """Inputs of one kernel call: one tile of rays, one block holding
    the first 768 refs of layout 0, every lane seeded with best_t."""
    rays = primary_rays(scenes.cornell_camera(), 8, 8)
    xp = st.rays_to_x(rays.org, rays.dir, rays.tmin, rays.tmax)
    xt = jnp.concatenate([xp, jnp.zeros((n_rays, 16))]).T  # + dummy tile
    best = (jnp.full((1, n_rays), best_t, jnp.float32),
            jnp.full((1, n_rays), -1, jnp.int32),
            jnp.zeros((1, n_rays), jnp.float32),
            jnp.zeros((1, n_rays), jnp.float32))
    gidx = jnp.arange(st._UPB, dtype=jnp.int32)
    return rays, xt, best, gidx


@pytest.mark.parametrize("skip", [False, True])
def test_kernel_block_early_out(skip):
    """The per-block early-out really skips: with the block's threshold
    at or above every lane's cut the block is not swept (lanes keep
    their seed), below it the same block yields the oracle's hits. The
    seed is large but finite so no hit is filtered by it."""
    tris, g = _scene("cornell")
    n = st._RS
    rays, xt, best, gidx = _one_block(tris, g, n, 1e30)
    thr = np.float32(1e30 if skip else 0.0).view(np.int32)
    out = st._sweep_triton(best, xt, g.cols, gidx,
                           jnp.zeros((1,), jnp.int32),
                           jnp.full((1,), thr, jnp.int32), n,
                           any_hit=False, interpret=True)
    got = np.asarray(out[1][0])
    assert out[0].shape == (1, n)
    if skip:
        assert (got == -1).all()
        np.testing.assert_array_equal(np.asarray(out[0][0]),
                                      np.float32(1e30))
    else:
        want = np.asarray(oracle.closest_hit(rays, tris).tri_id)
        # Layout 0's first block holds every Cornell ref of that layout.
        np.testing.assert_array_equal(got, want)


def test_trace_sweep_never_interprets_by_itself(monkeypatch):
    """On the CPU the default is the plain sweep; the kernel runs only
    when named, and interpret mode only when asked for."""
    assert st.default_impl() == "xla"
    tris, g = _scene("cornell")
    rays = primary_rays(scenes.cornell_camera(), 16, 16)

    def no_kernel(*a, **k):
        raise AssertionError("the Triton kernel ran")

    monkeypatch.setattr(st, "_sweep_triton", no_kernel)
    hits = trace_sweep(g, rays, tile=128, slab=4, bmax=512)
    assert (np.asarray(hits.tri_id) >= 0).mean() > 0.9
    with pytest.raises(ValueError):
        trace_sweep(g, rays, impl="xla", interpret=True)
    with pytest.raises(ValueError):
        trace_sweep(g, rays, impl="mosaic")


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_lowers_for_cuda(any_hit):
    """The whole frame, kernel included, lowers for the CUDA platform on
    a machine without one: the Pallas Triton lowering accepts every op
    of the kernel (the card's compiler runs only on the card)."""
    from jax import export

    tris, g = _scene("cornell")
    rays = primary_rays(scenes.cornell_camera(), 32, 32)
    fn = jax.jit(functools.partial(trace_sweep, impl="triton",
                                   any_hit=any_hit, coherent=not any_hit))
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(g, rays)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(gpu):
    """On the card: the compiled kernel against the plain sweep."""
    tris, g = _scene("soup")
    rays = _random_rays(4096, tris, seed=9)
    kw = dict(tile=256, slab=2, bmax=2048)
    kern = trace_sweep(g, rays, impl="triton", **kw)
    plain = trace_sweep(g, rays, impl="xla", **kw)
    np.testing.assert_array_equal(np.asarray(kern.tri_id),
                                  np.asarray(plain.tri_id))
