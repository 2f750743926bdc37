#!/usr/bin/env python
"""Proof that the ray tracer's main path runs on a GPU card.

    python chip_smoke.py              # phases 0-5 on one card
    python chip_smoke.py --cards 4    # the ray-sharded path on four cards

Phases (each raises on failure; nothing is caught and turned into
success):

0. device: JAX's platform must be "gpu"; prints the card and checks the
   compile cache honours JAX_COMPILATION_CACHE_DIR.
1. compile: the Sponza primary frame (tile 512) and an AO wave (tile
   256) at 1024x1024, with compile seconds and memory_analysis().
2. kernel vs plain: the same primary frame and AO wave through
   RenderSession.trace with the Triton sweep kernel and the plain-XLA
   sweep, same calibrated budgets, overflow clear; agreement and times.
3. oracle: 16,384 evenly strided rays of the primary frame and of one AO
   wave against the brute-force oracle.
4. main path: rebuild, primary frame, AO at 4 samples, a 4-bounce path
   frame and 3 dynamic frames (rebuild each), each complete.
5. other structures: irregular and uniform grids on the Cornell box.

With --cards N only the sharded path runs (phase 6): shard_trace over an
N-card mesh against the same waves on one card. The last line of stdout
is the JSON result, printed only when every phase passed. Without a GPU
the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from hagrid.utils import cache, device

SCENE = "sponza"
SIZE = 1024
AO_SAMPLES = 4
PATH_BOUNCES = 4
DYN_FRAMES = 3
ORACLE_RAYS = 16384
CARD = "card not read"


def log(msg: str) -> None:
    print(msg, flush=True)


def num(msg: str) -> None:
    """A line with a measured number: it names the card."""
    log(f"[{CARD}] {msg}")


def timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def host(hits):
    return np.asarray(hits.tri_id), np.asarray(hits.t)


# ----------------------------------------------------------------------
# Phase 0: device
# ----------------------------------------------------------------------

def phase_device():
    global CARD
    cache_dir = cache.enable()
    devs = device.require_gpu()
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env and os.path.realpath(cache_dir) != os.path.realpath(env):
        raise RuntimeError(f"compile cache at {cache_dir}, but "
                           f"JAX_COMPILATION_CACHE_DIR is {env}")
    CARD = device.card()
    log(f"phase 0 device: {devs[0].device_kind} x{len(devs)} "
        f"(platform {devs[0].platform}); nvidia-smi: {CARD}; "
        f"compile cache: {cache_dir}")
    return devs


# ----------------------------------------------------------------------
# Shared set-up
# ----------------------------------------------------------------------

def load(scene: str, size: int):
    from hagrid import scenes
    from hagrid.core.camera import primary_rays
    from hagrid.core.types import Triangles
    from hagrid.render.session import RenderSession

    v, f, cam = scenes.load_scene(scene)
    tris = Triangles.from_mesh(v, f)
    (session, dt) = timed(lambda: RenderSession.create(
        tris, structure="packet", verts=v))
    rays = jax.device_put(primary_rays(cam, size, size, order="block"))
    num(f"{scene}: {len(f)} tris; first build {dt:.3f} s "
        f"({session.describe()})")
    return dict(v=v, f=f, cam=cam, tris=tris, session=session, rays=rays,
                size=size)


def ao_rays(s, prim_hits, seed=0):
    """One AO sample's wave from the primary hits, and the same wave in
    the origin-major order the integrators trace it in."""
    from hagrid.ops import sortrays
    from hagrid.render import integrators

    grid = s["session"].grid
    sec, _ = integrators.ao_wave(grid.tris.n, s["rays"], prim_hits,
                                 jax.random.PRNGKey(seed),
                                 integrators.ao_max_dist(grid))
    srt, perm = sortrays.sort_rays(sec, grid.bbox_lo, grid.bbox_hi,
                                   bits=10, origin_major=True)
    return sec, srt, perm


def require_complete(session, what):
    if session.poll_overflow(recalibrate=False):
        raise RuntimeError(f"{what}: the sweep dropped work (block "
                           f"budget overflow)")


# ----------------------------------------------------------------------
# Phase 1: compile
# ----------------------------------------------------------------------

def phase_compile(s):
    from hagrid.core.types import Rays
    from hagrid.ops.sweep_trace import default_impl, trace_sweep

    grid = s["session"].grid
    n = s["rays"].count
    f32 = functools.partial(jax.ShapeDtypeStruct, dtype=jnp.float32)
    wave = Rays(org=f32((n, 3)), dir=f32((n, 3)), tmin=f32((n,)),
                tmax=f32((n,)))
    for name, kw, rays in (
            ("primary frame (coherent, tile 512)",
             dict(coherent=True), s["rays"]),
            ("AO wave (compact, any-hit, tile 256)",
             dict(any_hit=True), wave)):
        fn = jax.jit(functools.partial(trace_sweep, **kw))
        t0 = time.perf_counter()
        compiled = fn.lower(grid, rays).compile()
        dt = time.perf_counter() - t0
        m = compiled.memory_analysis()
        num(f"phase 1 compile {name}, impl {default_impl()}: {dt:.3f} s; "
            f"memory_analysis: temp {m.temp_size_in_bytes} B, "
            f"arguments {m.argument_size_in_bytes} B, "
            f"outputs {m.output_size_in_bytes} B, "
            f"code {m.generated_code_size_in_bytes} B")


# ----------------------------------------------------------------------
# Phase 2: Triton kernel vs plain XLA
# ----------------------------------------------------------------------

def _time_impls(session, what, trace, reps=5):
    """Each implementation's first call (compile + run) and the median of
    `reps` calls, in turns kernel, plain, kernel, plain."""
    out, first, runs = {}, {}, {"triton": [], "xla": []}
    for impl in ("triton", "xla", "triton", "xla"):
        session.impl = impl
        if impl not in first:
            out[impl], first[impl] = timed(trace)
            require_complete(session, f"{what} ({impl})")
        for _ in range(reps):
            runs[impl].append(timed(trace)[1])
        require_complete(session, f"{what} ({impl})")
    session.impl = None
    for impl in ("triton", "xla"):
        num(f"phase 2 {what}, {impl}: first call (compile + run) "
            f"{first[impl]:.3f} s; median of {len(runs[impl])} "
            f"{np.median(runs[impl]) * 1e3:.3f} ms")
    return out


def _agree(a, b, what, min_rate=0.9999, rtol=1e-5):
    (ia, ta), (ib, tb) = host(a), host(b)
    same = ia == ib
    both = same & (ia >= 0)
    t_ok = np.isclose(ta[both], tb[both], rtol=rtol, atol=0)
    log(f"  {what}: ids differ on {int((~same).sum())} of {ia.size} rays; "
        f"t beyond rtol {rtol} on {int((~t_ok).sum())} of "
        f"{int(both.sum())} agreeing hits")
    if same.mean() < min_rate or not t_ok.all():
        raise AssertionError(f"{what}: kernel and plain sweep disagree")


def phase_kernel_vs_plain(s):
    session, rays = s["session"], s["rays"]
    prim = session.trace(rays, coherent=True)      # calibrates
    require_complete(session, "primary calibration")
    _, srt, _ = ao_rays(s, prim)
    session.trace(srt, any_hit=True, cal_key="ao")
    require_complete(session, "AO calibration")
    p = _time_impls(session, "primary frame",
                    lambda: session.trace(rays, coherent=True))
    _agree(p["triton"], p["xla"], "primary frame")
    a = _time_impls(session, "AO wave (any-hit)",
                    lambda: session.trace(srt, any_hit=True, cal_key="ao"))
    # Any-hit returns SOME occluder: the kernel stops a sub-tile at its
    # first hits, the plain sweep tests every planned block, so only
    # occlusion is comparable.
    occ = [np.asarray(a[i].tri_id) >= 0 for i in ("triton", "xla")]
    diff = int((occ[0] != occ[1]).sum())
    log(f"  AO wave: occlusion differs on {diff} of {occ[0].size} rays")
    if diff > 1e-4 * occ[0].size:
        raise AssertionError("AO wave: kernel and plain sweep disagree")


# ----------------------------------------------------------------------
# Phase 3: oracle
# ----------------------------------------------------------------------

def oracle_agreement(got_id, got_t, ref_id, ref_t, rays, tris, what,
                     min_rate):
    """Ids agree on >= min_rate of the rays, every disagreement is a tie
    (the oracle also hits the tracer's triangle, at a t within rtol 1e-4
    of its own best), and agreeing hits agree in t to rtol 1e-4."""
    from hagrid.core.intersect import moller_trumbore

    agree = got_id == ref_id
    mism = np.flatnonzero(~agree)
    tie = np.zeros(mism.size, bool)
    if mism.size:
        gi = got_id[mism]
        k = np.maximum(gi, 0)
        hit, t, _, _ = moller_trumbore(
            np.asarray(rays.org)[mism], np.asarray(rays.dir)[mism],
            np.asarray(tris.v0)[k], np.asarray(tris.e1)[k],
            np.asarray(tris.e2)[k], np.asarray(rays.tmin)[mism],
            np.asarray(rays.tmax)[mism])
        tie = ((gi >= 0) & (ref_id[mism] >= 0) & np.asarray(hit)
               & np.isclose(np.asarray(t), ref_t[mism], rtol=1e-4, atol=0))
    both = agree & (ref_id >= 0)
    t_ok = np.isclose(got_t[both], ref_t[both], rtol=1e-4, atol=0)
    log(f"  {what}: ids agree on {int(agree.sum())} of {agree.size} rays; "
        f"{int(tie.sum())} ties, {int((~tie).sum())} other mismatches; "
        f"t beyond rtol 1e-4 on {int((~t_ok).sum())} of "
        f"{int(both.sum())} hits")
    if agree.mean() < min_rate or not tie.all() or not t_ok.all():
        raise AssertionError(f"{what}: tracer and oracle disagree "
                             f"(mismatched rays {mism[~tie][:8]})")


def phase_oracle(s, n_rays=ORACLE_RAYS):
    from hagrid import oracle
    from hagrid.ops import sortrays

    session, rays, tris = s["session"], s["rays"], s["tris"]
    idx = np.arange(n_rays) * (rays.count // n_rays)
    pick = functools.partial(jax.tree.map, lambda a: a[idx])
    prim = session.trace(rays, coherent=True)
    sub = pick(rays)
    ref, dt = timed(lambda: oracle.closest_hit(sub, tris, chunk=1024))
    num(f"phase 3 oracle closest-hit, {n_rays} rays x {tris.count} tris: "
        f"{dt:.3f} s")
    got_id, got_t = host(prim)
    ref_id, ref_t = host(ref)
    oracle_agreement(got_id[idx], got_t[idx], ref_id, ref_t, sub, tris,
                     "primary frame", 0.999)
    sec, srt, perm = ao_rays(s, prim)
    occ = np.asarray(sortrays.unsort(
        session.trace(srt, any_hit=True, cal_key="ao"), perm).tri_id) >= 0
    require_complete(session, "oracle waves")
    want, dt = timed(lambda: oracle.any_hit(pick(sec), tris, chunk=1024))
    want = np.asarray(want)
    num(f"phase 3 oracle any-hit, {n_rays} AO rays: {dt:.3f} s")
    agree = occ[idx] == want
    log(f"  AO wave: occlusion agrees on {int(agree.sum())} of "
        f"{agree.size} rays ({int(want.sum())} occluded)")
    if agree.mean() < 0.999:
        raise AssertionError("AO wave: tracer and oracle disagree")


# ----------------------------------------------------------------------
# Phase 4: main path end to end
# ----------------------------------------------------------------------

def _workload(session, what, fn):
    """Warm up (compile, calibrate, grow budgets that overflowed), then
    one complete, timed run."""
    for _ in range(3):
        jax.block_until_ready(fn())
        if not session.poll_overflow():
            break
    _, dt = timed(fn)
    require_complete(session, what)
    num(f"phase 4 {what}: {dt * 1e3:.3f} ms")


def phase_main_path(s, ao_samples=AO_SAMPLES, bounces=PATH_BOUNCES,
                    dyn_frames=DYN_FRAMES):
    from hagrid.render import integrators
    from hagrid.render.dynamic import AnimatedScene
    from hagrid.render.session import RenderSession
    from hagrid.core.types import Triangles

    session, rays, tris, w = s["session"], s["rays"], s["tris"], s["size"]
    _workload(session, "warm rebuild", lambda: session.rebuild(tris))
    _workload(session, f"primary frame {w}x{w}",
              lambda: session.trace(rays, coherent=True).t)
    hits = session.trace(rays, coherent=True)
    key = jax.random.PRNGKey(1)
    _workload(session, f"AO {ao_samples} samples",
              lambda: integrators.ambient_occlusion(
                  session, rays, hits, key, n_samples=ao_samples))
    _workload(session, f"path frame, {bounces} bounces",
              lambda: integrators.path_trace(session, s["cam"], w, w,
                                             max_bounces=bounces))
    if bool(jax.device_get(session.grid.overflowed)):
        raise RuntimeError("packet grid ref capacity overflowed")
    # Dynamic: a deforming mesh rebuilt every frame, with the motion
    # margin bench.py uses (wave_deform moves vertices <= 0.25 units).
    v, f = s["v"], s["f"]
    ext = np.asarray(v, np.float32).max(0) - np.asarray(v, np.float32).min(0)
    anim = AnimatedScene(v, f)
    dyn = RenderSession.create(Triangles.from_mesh(v, f), structure="packet",
                               verts=v,
                               bbox_margin=float(0.26 / max(ext.min(), 1e-6)))

    def frames():
        out = []
        for i in range(dyn_frames):
            dyn.rebuild(anim.frame(0.1 * (i + 1)))
            out.append(dyn.trace(rays, coherent=True).t)
        return out

    _workload(dyn, f"{dyn_frames} dynamic frames (rebuild + primary each)",
              frames)
    if bool(jax.device_get(dyn.grid.overflowed)):
        raise RuntimeError("dynamic packet grid ref capacity overflowed")
    stats = jax.devices()[0].memory_stats() or {}
    num(f"phase 4 peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


# ----------------------------------------------------------------------
# Phase 5: other structures
# ----------------------------------------------------------------------

def phase_structures(size=256):
    from hagrid import oracle, scenes
    from hagrid.core.camera import primary_rays
    from hagrid.core.types import Triangles
    from hagrid.render.session import RenderSession

    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f)
    rays = primary_rays(scenes.cornell_camera(), size, size)
    ref_id, ref_t = host(oracle.closest_hit(rays, tris))
    for structure in ("irregular", "uniform"):
        session = RenderSession.create(tris, structure=structure, verts=v)
        got, dt = timed(lambda: session.trace(rays))
        num(f"phase 5 {structure} Cornell {size}x{size}: first trace "
            f"{dt:.3f} s")
        got_id, got_t = host(got)
        oracle_agreement(got_id, got_t, ref_id, ref_t, rays, tris,
                         structure, 1.0 - 1e-3)


# ----------------------------------------------------------------------
# Phase 6 (--cards N): ray-sharded path vs one card
# ----------------------------------------------------------------------

def phase_sharded(s, n_cards):
    from hagrid.ops.sweep_trace import trace_sweep
    from hagrid.parallel import mesh as pmesh

    session, rays = s["session"], s["rays"]
    mesh = pmesh.make_mesh(n_cards)
    prim = session.trace(rays, coherent=True)
    _, srt, _ = ao_rays(s, prim)
    waves = (("primary frame", rays, dict(coherent=True), None),
             ("AO wave, any-hit", srt, dict(any_hit=True), "ao"),
             ("AO wave, closest-hit", srt, dict(), "ao"))
    for what, wave, kw, cal_key in waves:
        session.trace(wave, cal_key=cal_key, **kw)     # calibrate
        one, dt1 = timed(lambda: session.trace(wave, cal_key=cal_key, **kw))
        require_complete(session, f"{what}, one card")
        key = (kw.get("any_hit", False), kw.get("coherent", False),
               wave.count, cal_key)
        bmax, rowmax = session._bmax_cal[key]

        def shard_fn(g, r, kw=kw, bmax=bmax, rowmax=rowmax):
            hits, ovf = trace_sweep(g, r, bmax=bmax, rowmax=rowmax,
                                    return_overflow=True, **kw)
            return hits, ovf.reshape(1)

        padded, n = pmesh.pad_rays(wave, n_cards)
        fn = pmesh.shard_trace(shard_fn, mesh)
        jax.block_until_ready(fn(session.grid, padded))  # compile
        (many, ovf), dtn = timed(lambda: fn(session.grid, padded))
        if np.asarray(ovf).any():
            raise RuntimeError(f"{what}: a shard dropped work")
        num(f"phase 6 {what}: one card {dt1 * 1e3:.3f} ms, "
            f"{n_cards} cards {dtn * 1e3:.3f} ms")
        (i1, t1), (i4, t4) = host(one), host(many)
        i4, t4 = i4[:n], t4[:n]
        if kw.get("any_hit"):
            diff = int(((i1 >= 0) != (i4 >= 0)).sum())
            log(f"  {what}: occlusion differs on {diff} of {n} rays")
        else:
            diff = int(((i1 != i4) | ((i1 >= 0) & (t1 != t4))).sum())
            log(f"  {what}: ids or t differ on {diff} of {n} rays")
        if diff:
            raise AssertionError(f"{what}: sharded and one-card results "
                                 f"differ")


# ----------------------------------------------------------------------

PHASES = ("device", "compile", "kernel", "oracle", "main", "structures")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="run only the ray-sharded path over this many "
                         "cards, against one card")
    ap.add_argument("--phases", default=",".join(PHASES[1:]),
                    help="comma-separated subset of "
                         f"{','.join(PHASES[1:])} (device always runs)")
    args = ap.parse_args(argv)
    devs = phase_device()
    s = load(SCENE, SIZE)
    if args.cards:
        if len(devs) < args.cards:
            raise RuntimeError(f"--cards {args.cards}: JAX sees "
                               f"{len(devs)} devices")
        phase_sharded(s, args.cards)
    else:
        run = args.phases.split(",")
        unknown = set(run) - set(PHASES)
        if unknown:
            raise ValueError(f"unknown phases {sorted(unknown)}")
        if "compile" in run:
            phase_compile(s)
        if "kernel" in run:
            phase_kernel_vs_plain(s)
        if "oracle" in run:
            phase_oracle(s)
        if "main" in run:
            phase_main_path(s)
        if "structures" in run:
            phase_structures()
        if len(run) < len(PHASES) - 1:
            log(f"phases {','.join(run)} passed (subset: no result line)")
            return 0
    print(json.dumps({"ok": True, "device": device.describe(devs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
