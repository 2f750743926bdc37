"""RenderSession: the engine facade (build + trace under one object).

Counterpart of the reference's main.cpp orchestration: owns the current
acceleration structure, rebuilds it per frame (static capacities take
the place of the reference's MemManager slot allocator: iteration 2+ is
allocation-free because shapes never change), and dispatches traversal
on the best available path. bench.py, chip_smoke.py, the CLI, and
__graft_entry__ all go through this facade so the default path is always
the one benched.

Structures:
- "packet"    (default): slice-major packet grid + planned-sweep tracer
              (ops/sweep_trace.py).
- "irregular": two-level irregular grid (reference parity structure)
              + wavefront gather tracer.
- "uniform":  single-level grid, the BASELINE config #1 reference path.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ..core.types import Hits, Rays, Triangles
from ..grid import irregular, packet, uniform
from ..ops.sweep_trace import trace_sweep
from ..utils.config import BuildParams

# Hard ceiling on the calibrated sweep block budget, derived from
# memory: the frame's per-round planning arrays scale with the budget
# (gidx 128 B/block, two unit-wide forward-fill cumsums 256 B/block,
# tile_of/tminb 8 B/block; the per-round ladder sums to ~2.25x bmax), so
# 2^20 blocks plan in ~1 GiB. What a card's memory allows beyond that is
# not measured. Demand beyond this cap keeps the overflow flag set and
# warns.
_BMAX_CAP = 1 << 20
# Calibration refinement attempts before giving up (each step grows
# budgets by >= the margin factor, so demand up to margin^N times the
# first probe's reading converges; N=6 covers > 10x underestimates).
_CAL_TRIES = 6


def _rung(x: int, base: int) -> int:
    """Round x up to base * {1, 1.5} * 2^k (1024 -> 1536 -> 2048 -> 3072
    -> 4096 ...). Budgets are static shapes, so every distinct value is
    a frame compile; a geometric ladder bounds the distinct budgets per
    wave class to O(log demand) across calibration growth steps AND
    across runs, at <= 33% budget slack (planning costs O(budget)).
    Linear 1024-steps made near-miss demands (57k vs 59k) compile
    separately."""
    u = max(1, -(-x // base))
    k = max(0, (u - 1).bit_length() - 1)
    for g in (1 << k, 3 << max(k - 1, 0), 2 << k, 3 << k):
        if g >= u:
            return g * base
    return (4 << k) * base


@dataclasses.dataclass
class RenderSession:
    params: BuildParams
    structure: str  # "packet" (default) | "irregular" | "uniform"
    grid: object
    bbox: tuple | None = None  # host-side scene bounds (packet rebuilds)
    # Sweep intersection implementation for the packet path ("triton" |
    # "xla"); None takes ops.sweep_trace.default_impl().
    impl: str | None = None
    # Device scalar: OR of the sweep tracer's block-budget overflow
    # flags since session start. Never read on the hot path; bench
    # checks it once at the end (D2H reads are deferred by design).
    trace_overflow: object = None
    # Demand-calibrated sweep block budgets per wave shape. Planning
    # costs O(budget) whether blocks are live or not, so the first
    # trace of each wave
    # shape runs with the generous default budget, reads the true peak
    # demand once (one host sync, outside any timed frame), and later
    # frames run with demand * margin. The overflow flag still reports
    # any frame whose demand outgrows the calibrated budget.
    _bmax_cal: dict = dataclasses.field(default_factory=dict)
    # Per-wave-key accumulated overflow flags (device scalars), read
    # only by poll_overflow at frame boundaries.
    _ovf: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(tris: Triangles, params: BuildParams | None = None,
               structure: str = "packet",
               verts=None, bbox_margin: float = 0.0) -> "RenderSession":
        """verts: optional host vertex array; gives the packet build its
        bounds without a device->host read.

        bbox_margin: fraction of the scene extent added on every side of
        the session bbox. Warm packet rebuilds reuse this frame-1 bbox
        without a device read, so animated geometry that deforms OUTSIDE
        it is clamped into boundary cells and hits can be silently
        missed; callers animating geometry must pass a margin covering
        the expected motion (bench's wave deform uses 0.3)."""
        params = params or BuildParams()
        s = RenderSession(params=params, structure=structure, grid=None)
        if verts is not None and len(verts):
            v = np.asarray(verts, np.float32)
            lo, hi = v.min(0), v.max(0)
            pad = (hi - lo) * np.float32(bbox_margin)
            s.bbox = (lo - pad, hi + pad)
        s.rebuild(tris)
        return s

    def rebuild(self, tris: Triangles):
        """Per-frame rebuild. Capacity buckets are stable across frames,
        so only the first frame compiles, and (packet path) frames after
        the first run with zero host synchronisation."""
        if self.structure == "uniform":
            kw = {}
            if self.grid is not None:
                kw = dict(ref_capacity=self.grid.ref_ids.shape[0],
                          dims=self.grid.dims)
            self.grid = uniform.build_uniform(
                tris, density=self.params.snd_density, **kw)
        elif self.structure == "irregular":
            kw = {}
            if self.grid is not None:
                kw = dict(top_dims=self.grid.top_dims)
            self.grid = irregular.build_irregular(tris, self.params,
                                                  **kw)
        else:
            kw = dict(bbox=self.bbox)
            if self.grid is not None:
                # Sync-free warm rebuild: frame-1 capacity, deferred
                # overflow detection via grid.overflowed.
                kw.update(ref_capacity=self.grid.ref_capacity,
                          dims3=self.grid.dims3, check=False)
            self.grid = packet.build_packet(tris, **kw)
            if self.bbox is None:
                self.bbox = (np.asarray(self.grid.bbox_lo),
                             np.asarray(self.grid.bbox_hi))
        return self.grid.total_refs  # something to block on

    def trace(self, rays: Rays, any_hit: bool = False,
              coherent: bool = False, cal_key=None) -> Hits:
        """coherent=True: rays are already direction-coherent in order
        (camera primaries) — the packet path then skips its binning
        permutation. Ignored by the other structures.

        cal_key: extra identity for the demand calibration. Different
        wave KINDS have very different block demands (a primary frame
        vs the 3rd path bounce), so callers issuing several waves of
        the same shape per frame must distinguish them — sharing one
        calibrated budget across AO samples / path bounces was exactly
        what overflowed round 3's AO and path numbers (the budget was
        calibrated on whichever wave ran first)."""
        if self.structure == "uniform":
            return uniform.trace_uniform_fast(self.grid, rays,
                                              any_hit=any_hit)
        if self.structure == "irregular":
            return irregular.trace_irregular_fast(self.grid, rays,
                                                  any_hit=any_hit)
        key = (any_hit, coherent, rays.count, cal_key)
        cal = self._bmax_cal.get(key)
        if cal is None:
            cal = self._calibrate(key, rays, any_hit, coherent)
        bmax, rowmax = cal
        hits, ovf = trace_sweep(self.grid, rays, any_hit=any_hit,
                                impl=self.impl, coherent=coherent,
                                bmax=bmax, rowmax=rowmax,
                                return_overflow=True)
        # Per-key accumulated device flags (never read on the hot
        # path): poll_overflow can then grow exactly the offending
        # wave's budgets instead of re-probing everything.
        prev = self._ovf.get(key)
        self._ovf[key] = ovf if prev is None else prev | ovf
        self.trace_overflow = ovf if self.trace_overflow is None \
            else self.trace_overflow | ovf
        return hits

    def _calibrate(self, key, rays: Rays, any_hit: bool, coherent: bool):
        """Demand calibration, run once per wave shape OFF any timed
        frame (each probe costs one D2H sync). Converges to budgets the
        wave COMPLETES under: the probe reads the true (unclamped) peak
        block demand and live-row count, budgets are set to
        demand * margin, and the trace is re-probed until its own
        overflow flag is CLEAR — a truncated first probe (row-stream
        overflow underestimates demand) or a peak round that lands on a
        reduced rung of the per-round budget ladder both just trigger
        another growth step.

        Intermediate probes' overflow flags are deliberately NOT folded
        into self.trace_overflow: their dropped work never reaches
        returned hits (callers get the final, verified trace). The final
        probe's flag (clear, unless demand exceeds _BMAX_CAP) is folded
        by trace()."""
        # Incoherent waves (AO/path bounces) vary frame to frame; give
        # them more slack than fixed-camera primaries. Both margins
        # exceed the steepest round-ladder step they must cover once
        # the retry loop has seen the true peak round demand.
        margin = 1.3 if (coherent and not any_hit) else 1.5
        bmax = rowmax = None            # first probe: generous defaults
        for attempt in range(_CAL_TRIES):
            _, ovf, demand = trace_sweep(
                self.grid, rays, any_hit=any_hit, impl=self.impl,
                coherent=coherent, bmax=bmax, rowmax=rowmax,
                return_overflow=True, return_demand=True)
            ovf_h, dm = jax.device_get((ovf, demand))
            d, rows = int(dm[0]), int(dm[1])
            # Quantize to geometric rungs (see _rung): wave kinds with
            # similar demand share one compiled frame, and budgets stay
            # log-bounded in number across growth steps.
            want_b = _rung(int(d * margin), 1024)
            want_r = _rung(int(rows * margin), 8192) if rows else None
            if bmax is not None and not bool(ovf_h):
                # Wave completed under the current budgets. Keep them
                # unless they are grossly oversized (> 2 growth steps
                # above what the verified demand asks for) — planning
                # costs O(budget) every frame.
                if bmax <= max(want_b * 2, 2048):
                    break
                bmax, rowmax = want_b, want_r
                continue
            grow_b = max(want_b, _rung(int((bmax or 0) * 3 // 2), 1024))
            if grow_b > _BMAX_CAP:
                import sys
                print(f"WARNING: sweep demand ({d} blocks) needs a "
                      f"budget beyond the {_BMAX_CAP}-block memory cap;"
                      f" wave will trace incomplete (flagged)",
                      file=sys.stderr)
                bmax, rowmax = _BMAX_CAP, want_r
                break
            bmax, rowmax = grow_b, want_r
        cal = (bmax, rowmax)
        self._bmax_cal[key] = cal
        return cal

    def poll_overflow(self, recalibrate: bool = True) -> bool:
        """Read the accumulated per-wave overflow flags (one host sync
        — call at frame boundaries, never on the timed path). If a
        steady-state wave outgrew its calibrated budget and
        recalibrate=True, GROW exactly that wave's budgets one rung
        step (x2, quantized) and clear its flag, so the next trace of
        that shape runs complete without any re-probe sync — the
        production adapt-after-overflow mechanism for waves whose
        demand drifts frame to frame (deforming geometry, deeper path
        bounces sharing a calibration key). Geometric growth converges
        in O(log shortfall) frames. Returns the OR of the flags; the
        caller decides whether to re-trace the tainted frame (bench
        re-runs it; an interactive viewer would just let the next
        frame be complete)."""
        if not self._ovf:
            return False
        flags = jax.device_get(self._ovf)
        any_ovf = any(bool(v) for v in flags.values())
        if any_ovf and recalibrate:
            for key, v in flags.items():
                if not bool(v):
                    continue
                bmax, rowmax = self._bmax_cal.get(key, (None, None))
                if bmax is None:
                    continue
                grown = min(_rung(bmax * 2, 1024), _BMAX_CAP)
                grown_r = _rung(rowmax * 2, 8192) if rowmax else rowmax
                self._bmax_cal[key] = (grown, grown_r)
                del self._ovf[key]
            self.trace_overflow = None
        return any_ovf

    def describe(self) -> str:
        if self.structure == "uniform":
            g = self.grid
            return (f"uniform dims={g.dims} cells={g.num_cells} "
                    f"refs={int(jax.device_get(g.total_refs))}")
        if self.structure == "irregular":
            st = self.grid.stats()
            return (f"irregular top={st['top_dims']} "
                    f"levels={st['levels']} "
                    f"cells={st['cells']} refs={st['refs']} "
                    f"mean_refs={st['refs_per_cell_mean']:.2f} "
                    f"empty={st['empty_cell_frac']:.2f}")
        g = self.grid
        # No device reads here: describe() runs before trace timing.
        return (f"packet dims3={g.dims3} ref_capacity={g.ref_capacity}")
