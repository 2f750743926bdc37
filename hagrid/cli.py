"""Command-line interface, mirroring the reference binary's flags.

The reference main.cpp exposes: scene path, camera (eye/center/up/fov),
image size, build params (--top-density, --snd-density, merge alpha,
expansion passes), benchmark iteration counts. Same surface here, plus
the structure choice and a platform override.

  python -m hagrid.cli render --scene sponza --size 1024x1024 \
      --out out.png
  python -m hagrid.cli bench --scene sponza --iters 5
  python -m hagrid.cli stats --scene cornell
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _common(ap: argparse.ArgumentParser):
    ap.add_argument("--scene", default="cornell",
                    help="scene name (cornell|sponza|san_miguel) or .obj path")
    ap.add_argument("--size", default="512x512", help="WxH")
    ap.add_argument("--eye", type=float, nargs=3, default=None)
    ap.add_argument("--center", type=float, nargs=3, default=None)
    ap.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0))
    ap.add_argument("--fov", type=float, default=None)
    ap.add_argument("--top-density", type=float, default=0.12,
                    help="top-level grid density (lambda1, ref default 0.12)")
    ap.add_argument("--snd-density", type=float, default=2.4,
                    help="second-level density (lambda2, ref default 2.4)")
    ap.add_argument("--alpha", type=float, default=0.995,
                    help="SAH merge acceptance factor")
    ap.add_argument("--expansion-passes", type=int, default=3)
    # Default matches BuildParams (the benched configuration): one SAH pass
    # after the cheap buddy/air coalescing passes.
    ap.add_argument("--merge-passes", type=int, default=1)
    ap.add_argument("--levels", type=int, default=3, choices=range(0, 7),
                    help="max per-cell subdivision log2 (0..6: the packed "
                         "top_info word keeps 3 bits, and over-dense "
                         "cells may take one demand-gated extra level)")
    ap.add_argument("--sanitize", action="store_true",
                    help="replay the sweep planning under checkify "
                         "(NaN/index/div) before tracing (packet only)")
    ap.add_argument("--structure",
                    choices=("packet", "irregular", "uniform"),
                    default="packet")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="force the JAX platform")


def _setup(args):
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from hagrid.utils import cache

    cache.enable()

    from hagrid import scenes
    from hagrid.core.camera import Camera
    from hagrid.core.types import Triangles
    from hagrid.render.session import RenderSession
    from hagrid.utils.config import BuildParams

    v, f, cam = scenes.load_scene(args.scene)
    if args.eye is not None or args.center is not None or args.fov:
        cam = Camera(eye=tuple(args.eye or cam.eye),
                     center=tuple(args.center or cam.center),
                     up=tuple(args.up), fov_deg=args.fov or cam.fov_deg)
    tris = Triangles.from_mesh(v, f)
    params = BuildParams(top_density=args.top_density,
                         snd_density=args.snd_density, alpha=args.alpha,
                         expansion_passes=args.expansion_passes,
                         merge_passes=args.merge_passes, levels=args.levels)
    session = RenderSession.create(tris, params,
                                   structure=args.structure, verts=v)
    return session, cam, tris


def cmd_render(args):
    session, cam, tris = _setup(args)  # sets the platform — import first
    from hagrid.core.camera import block_index, primary_rays
    from hagrid.io.image import shade_eyelight, write_png, write_ppm
    w, h = (int(x) for x in args.size.split("x"))
    rays = primary_rays(cam, w, h, order="block")
    if getattr(args, "sanitize", False) and session.structure == "packet":
        from hagrid.utils.sanitize import check_sweep_plan
        stats = check_sweep_plan(session.grid, rays)
        print(f"sanitizer: plan clean ({stats})")
    t0 = time.perf_counter()
    hits = session.trace(rays)
    dt = time.perf_counter() - t0
    tri_id = np.asarray(hits.tri_id)
    t_arr = np.asarray(hits.t)
    dirs = np.asarray(rays.dir)
    if w % 32 == 0 and h % 32 == 0:
        # Undo the packet-friendly block ordering for the image.
        idx = block_index(w, h)
        inv = np.empty_like(idx)
        inv[idx] = np.arange(idx.size)
        tri_id, t_arr, dirs = tri_id[inv], t_arr[inv], dirs[inv]
    img = shade_eyelight(tri_id, t_arr,
                         np.asarray(tris.n), dirs, w, h)
    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)
    frac = float(np.mean(np.asarray(hits.tri_id) >= 0))
    print(f"rendered {args.out}: {w}x{h} in {dt * 1e3:.1f} ms "
          f"({w * h / dt / 1e6:.2f} Mrays/s incl. warmup), "
          f"hit fraction {frac:.3f}")
    _warn_overflow(session)


def _warn_overflow(session):
    """Surface the sweep tracer's deferred block-budget overflow flag
    (surplus blocks are dropped -> geometry can be missing from the
    image). Same check bench.py makes."""
    if session.trace_overflow is not None:
        import jax
        if bool(jax.device_get(session.trace_overflow)):
            print("WARNING: sweep block budget overflowed during "
                  "tracing; some far panels were dropped (geometry may "
                  "be missing — raise bmax)", file=sys.stderr)


def cmd_bench(args):
    session, cam, tris = _setup(args)
    import jax

    from hagrid.core.camera import primary_rays
    w, h = (int(x) for x in args.size.split("x"))
    rays = primary_rays(cam, w, h, order="block")

    def timed(fn, *a, iters=args.iters):
        jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    build_s = timed(session.rebuild, tris)
    trace_s = timed(lambda r: session.trace(r).t, rays)
    print(json.dumps({
        "scene": args.scene, "tris": tris.count, "rays": w * h,
        "build_ms": round(build_s * 1e3, 2),
        "mrays_per_s": round(w * h / trace_s / 1e6, 2),
        "structure": args.structure,
        "grid": session.describe(),
    }))


def cmd_stats(args):
    session, cam, tris = _setup(args)
    print(session.describe())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hagrid")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to an image")
    _common(r)
    r.add_argument("--out", default="out.png")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="build + trace benchmark")
    _common(b)
    b.add_argument("--iters", type=int, default=5)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("stats", help="print grid statistics")
    _common(s)
    s.set_defaults(fn=cmd_stats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
