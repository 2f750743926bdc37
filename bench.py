#!/usr/bin/env python
"""Benchmark harness. Prints ONE JSON line with the headline metric.

Headline (BASELINE.md): Mrays/s of primary rays on the Sponza-scale
scene, plus grid rebuild ms, on one GPU card. The default run also
measures the AO, path-tracing and dynamic-rebuild workloads (BASELINE
configs #2-4) and records them in extra["workloads"]. Stage breakdown
goes to stderr; stdout gets exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "extra": {...}}
extra names the device (platform, device_kind, device count, and the
card's name and power limit from nvidia-smi).

The headline `value` is the SINGLE-FRAME Mrays/s (one trace + one device
sync); extra["primary_mrays_pipelined"] times PIPE frames back-to-back
with one sync, and extra["latency_ms"] the single frame.

Without a GPU the harness exits non-zero and prints no metric; any
failure propagates.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

from hagrid.utils import cache

cache.enable()

PIPE = 8  # frames per sync in pipelined timing


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, *args, warmup=2, iters=5, **kw):
    """Median wall time of fn(*args) with block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timed_pipelined(fn, *args, k=PIPE, warmup=1, iters=3, **kw):
    """Median per-call wall time over k back-to-back calls + one sync."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        outs = [fn(*args, **kw) for _ in range(k)]
        jax.block_until_ready(outs)
        ts.append((time.perf_counter() - t0) / k)
    return float(np.median(ts))


def bench_primary(session, rays, w, h, iters, extra):
    lat_s = timed(session.trace, rays, coherent=True, warmup=2,
                  iters=iters)
    thr_s = timed_pipelined(session.trace, rays, coherent=True)
    mrays = (w * h) / lat_s / 1e6          # headline: single-frame
    mrays_pipe = (w * h) / thr_s / 1e6
    log(f"primary rays {w}x{h}: {lat_s * 1e3:.2f} ms single-frame "
        f"= {mrays:.1f} Mrays/s ({thr_s * 1e3:.2f} ms/frame pipelined "
        f"= {mrays_pipe:.1f} Mrays/s)")
    hits = session.trace(rays, coherent=True)
    frac = float(np.mean(np.asarray(hits.tri_id) >= 0))
    log(f"hit fraction: {frac:.3f}")
    extra.update(rays=w * h, hit_fraction=round(frac, 4),
                 latency_ms=round(lat_s * 1e3, 2),
                 primary_mrays_pipelined=round(mrays_pipe, 3))
    if session.structure == "irregular":
        from hagrid.ops.wavefront import last_trace_stats
        ms = last_trace_stats["mean_steps"]
        log(f"mean marched steps/ray: {ms:.1f}")
        extra["mean_steps_per_ray"] = round(ms, 2)
    return mrays


def overflow_free(session, run, name, extra, retries=2):
    """Run a workload's timing function, then poll the session's
    accumulated overflow flag (one D2H sync, off the timed path). If any
    timed wave outgrew its calibrated budget, poll_overflow drops the
    calibrations, so a re-run re-probes each wave shape at the observed
    (grown) demand — the recorded number is then from COMPLETE frames.
    The reference never drops occluders (SURVEY §3.3 traverse_grid);
    this is the benchmark-side contract that our numbers describe
    complete frames too. Returns (value, final_overflow_flag)."""
    value = run()
    if session.structure != "packet":
        return value, False
    for _ in range(retries):
        if not session.poll_overflow():      # also recalibrates if set
            extra.setdefault("workload_overflow", {})[name] = False
            return value, False
        log(f"WARNING: {name} overflowed its calibrated budget; "
            f"recalibrated — re-timing for a complete-frame number")
        value = run()
    ovf = session.poll_overflow(recalibrate=False)
    if ovf:
        log(f"WARNING: {name} still overflows after {retries} "
            f"recalibrations; demand exceeds the memory cap "
            f"(number describes incomplete frames)")
    extra.setdefault("workload_overflow", {})[name] = bool(ovf)
    return value, bool(ovf)


def bench_ao(session, cam, w, h, iters):
    from hagrid.core.camera import primary_rays
    from hagrid.render import integrators

    n_samples = 4
    rays = primary_rays(cam, w, h, order="block")
    hits = session.trace(rays, coherent=True)
    key = jax.random.PRNGKey(0)

    def run():
        return integrators.ambient_occlusion(
            session, rays, hits, key, n_samples=n_samples)

    ao_s = timed(run, warmup=1, iters=iters)
    sec = w * h * n_samples
    mrays = sec / ao_s / 1e6
    log(f"AO ({n_samples} spp) {w}x{h}: {ao_s * 1e3:.1f} ms "
        f"= {mrays:.1f} M secondary rays/s")
    return mrays


def bench_path(session, cam, w, h, iters):
    from hagrid.render import integrators

    bounces = 4

    def run():
        return integrators.path_trace(session, cam, w, h, spp=1,
                                      max_bounces=bounces)

    pt_s = timed(run, warmup=1, iters=max(2, iters // 2))
    total = w * h * (bounces + 1)  # upper bound; waves shrink
    mrays = total / pt_s / 1e6
    log(f"path {w}x{h} {bounces} bounces: {pt_s * 1e3:.1f} ms "
        f"<= {mrays:.1f} Mrays/s")
    return mrays


def bench_dynamic(session, v, f, rays, iters, extra):
    from hagrid.render.dynamic import AnimatedScene
    from hagrid.render.session import RenderSession

    scene_anim = AnimatedScene(v, f)
    if session.structure == "packet":
        # Fresh session with a motion margin: warm rebuilds reuse the
        # frame-1 bbox, so deformed geometry must stay inside it.
        # wave_deform moves vertices by <=0.25 units.
        from hagrid.core.types import Triangles
        ext = np.asarray(v, np.float32).max(0) - np.asarray(
            v, np.float32).min(0)
        session = RenderSession.create(
            Triangles.from_mesh(v, f), session.params,
            structure="packet", verts=v,
            bbox_margin=float(0.26 / max(ext.min(), 1e-6)))

    def frame(t):
        session.rebuild(scene_anim.frame(t))
        return session.trace(rays, coherent=True).t

    def run():
        t0 = time.perf_counter()
        n_frames = max(3, iters)
        outs = [frame(0.1 * (i + 1)) for i in range(n_frames)]
        jax.block_until_ready(outs)
        fps = n_frames / (time.perf_counter() - t0)
        log(f"dynamic: {fps:.2f} fps (rebuild+trace per frame, "
            f"{n_frames} frames one sync)")
        return fps

    jax.block_until_ready(frame(0.0))  # compile
    # Deforming geometry drifts the wave's block demand across frames;
    # overflow_free polls the per-frame calibrated budgets and re-times
    # with recalibrated (grown) budgets if any frame clipped.
    return overflow_free(session, run, "dynamic", extra)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small scene + image for a fast smoke run")
    ap.add_argument("--scene", default=None,
                    help="scene name or .obj path (default sponza-like)")
    ap.add_argument("--size", default=None, help="WxH, default 1024x1024")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--workload", default="all",
                    choices=("all", "primary", "ao", "path", "dynamic"),
                    help="BASELINE.json config to run (default: all)")
    ap.add_argument("--structure", default="packet",
                    choices=("packet", "irregular", "uniform"),
                    help="acceleration structure / tracer path")
    args = ap.parse_args()

    from hagrid import scenes
    from hagrid.core.camera import primary_rays
    from hagrid.core.types import Triangles
    from hagrid.render.session import RenderSession

    from hagrid.utils import device

    devs = device.require_gpu()
    card = device.card()
    log(f"device: {devs[0].device_kind} x{len(devs)}; nvidia-smi: {card}")

    if args.quick:
        scene_name = args.scene or "cornell"
        size = args.size or "256x256"
        iters = 2
    else:
        scene_name = args.scene or "sponza"
        size = args.size or "1024x1024"
        iters = args.iters
    w, h = (int(x) for x in size.split("x"))

    t0 = time.perf_counter()
    v, f, cam = scenes.load_scene(scene_name)
    log(f"scene {scene_name}: {len(f)} tris "
        f"({time.perf_counter() - t0:.2f}s to generate)")

    from hagrid.utils.config import BuildParams

    if args.workload == "dynamic" and args.structure == "irregular":
        params = BuildParams.dynamic()  # rebuild-dominated workload
    else:
        params = BuildParams()
    tris = Triangles.from_mesh(v, f)
    session = RenderSession.create(tris, params,
                                   structure=args.structure, verts=v)

    # --- build benchmark -------------------------------------------------
    build_s = timed(session.rebuild, tris, warmup=1, iters=max(2, iters))
    log(f"grid rebuild: {build_s * 1e3:.2f} ms "
        f"({session.describe()})")

    extra = {
        "rebuild_ms": round(build_s * 1e3, 2),
        "tris": int(len(f)),
        "device": dict(device.describe(devs), card=card),
        "structure": args.structure,
        "grid": session.describe(),
    }

    rays = primary_rays(cam, w, h, order="block")
    rays = jax.block_until_ready(jax.device_put(rays))

    workloads = {}
    any_ovf = False
    run_all = args.workload == "all"
    if run_all or args.workload == "primary":
        val, ovf = overflow_free(
            session,
            lambda: bench_primary(session, rays, w, h, iters, extra),
            "primary", extra)
        workloads["primary_mrays"] = round(val, 3)
        any_ovf |= ovf
    if run_all or args.workload == "ao":
        val, ovf = overflow_free(
            session, lambda: bench_ao(session, cam, w, h, iters),
            "ao", extra)
        workloads["ao_mrays"] = round(val, 3)
        any_ovf |= ovf
    if run_all or args.workload == "path":
        val, ovf = overflow_free(
            session, lambda: bench_path(session, cam, w, h, iters),
            "path", extra)
        workloads["path_mrays_upper"] = round(val, 3)
        any_ovf |= ovf
    if run_all or args.workload == "dynamic":
        # bench_dynamic traces through its own session (motion-margin
        # bbox); it polls and re-runs internally and returns its flag.
        val, ovf = bench_dynamic(session, v, f, rays, iters, extra)
        workloads["dynamic_fps"] = round(val, 3)
        any_ovf |= ovf
    extra["workloads"] = workloads

    if args.workload in ("all", "primary"):
        metric = f"primary_mrays_{scene_name}"
        value = workloads["primary_mrays"]
        unit = "Mrays/s"
    elif args.workload == "dynamic":
        metric, value = f"dynamic_fps_{scene_name}", workloads[
            "dynamic_fps"]
        unit = "fps"
    else:
        key = "ao_mrays" if args.workload == "ao" else "path_mrays_upper"
        metric, value = f"{args.workload}_mrays_{scene_name}", workloads[
            key]
        unit = "Mrays/s"

    if args.structure == "packet":
        # Deferred validity checks (the hot path never reads back).
        assert not bool(jax.device_get(session.grid.overflowed)), \
            "packet grid ref capacity overflowed; raise ref_capacity"
        # OR of the per-workload FINAL flags (each workload polled its
        # own flag and re-ran with recalibrated budgets on overflow —
        # see overflow_free). True only when a wave's demand exceeded
        # the memory cap even after growth: the recorded number then
        # describes frames with dropped occluder panels.
        extra["trace_overflow"] = bool(any_ovf)
        if any_ovf:
            log("WARNING: sweep block budget overflowed during "
                "tracing; some far panels were dropped")

    print(json.dumps({
        "metric": metric,
        "value": round(value, 3),
        "unit": unit,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
