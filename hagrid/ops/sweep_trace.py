"""Planned-sweep packet traversal: the packet grid's tracer.

Counterpart of the reference's traverse_grid hot loop (src/traverse.cu).
Instead of one ray per thread chasing per-ray gathers, tiles of rays
sweep the packet grid (grid/packet.py) slice by slice, and every
triangle some ray of a tile might hit is tested densely against the
whole tile. Control flow and ref selection are hoisted out of the
intersection stage:

1. **Planning (XLA, vectorized over ray tiles).** Rays are binned into
   TILE-sized packets by (major axis, sign), image/origin coherent. Per
   round, each live tile advances one SLAB of S slices along its major
   axis; per-quarter frustum rects (pure interval arithmetic) turn into
   REF-level ranges via the build-time `rs` tables, two gathers per
   rect row, no device-wide scatters.

2. **Block stream.** Ref ranges round outward to 24-ref gather UNITS
   (4 group rows of the `cols` table, 6 refs x 20 coefficients + 8 pad
   lanes per row). Units pack into 768-ref BLOCKS per tile: each block
   is 32 unit indices (`gidx`), its tile (`tile_of`, blocks of a tile
   are contiguous) and an early-out threshold (`tminb`): no ref of the
   block can hit a ray earlier than it.

3. **Intersection.** Every ray of a block's tile against the block's
   768 refs, exact f32 linear-form Moller-Trumbore (grid/packet.py),
   reduced per ray to the closest candidate: smaller t wins, equal t
   goes to the smaller tri id (the oracle's rule), so results do not
   depend on block order. Two implementations, chosen by
   `trace_sweep(impl=...)`:
   - "xla": plain jnp. Chunks of blocks run under a lax.while_loop with
     a dynamic trip count; each chunk gathers its units, evaluates every
     pair in one fused reduction, and folds the per-block results into
     the running best with scatter-min merges.
   - "triton": a Pallas kernel through Triton. One program per
     (tile, ray sub-tile) loops over its tile's contiguous block run,
     loads each block's units itself via `gidx`, keeps per-lane best
     (t, id, u, v) in registers, and skips a block outright once every
     lane's best is at or below the block's threshold (the reference
     hot loop's `hit.t <= t_exit` break at block granularity).

4. **Device-side round loop.** The whole frame (every round's plan,
   block stream and sweep) is ONE jitted computation with no
   device->host reads. The block budget is a static capacity with an
   overflow flag checked once at the end of the frame.

Numerics: plain f32 on the CUDA cores, parity with the oracle (no
matrix units: TF32 or bf16 products flip hits).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..core.types import Hits, Rays
from ..grid.packet import MT_COLS, PacketGrid, rays_to_x
from .segment import expand_by_counts

_BIG = 3e38
_BIG_BITS = int(np.float32(3e38).view(np.int32))  # bit pattern of _BIG
_BIGID = 2 ** 30
_SUB = 4        # ray quarters per tile (tighter union rects)
_RMAX = 4       # c-trimmed row ranges per (tile, slice); taller rects
#                 fall back to one untrimmed multi-row tail range
#                 (Sponza primary rects span ~2.7 rows on average).
_G = 6           # refs per group row (one 128-lane row of `cols`:
#                 6 x 20 coefficient floats + 8 zero pad lanes)
_GW = 128        # group-row lane width
_U = 4           # group rows per gather unit (24 refs). Ranges round
#                 outward to whole units: the round-out rows are real
#                 refs of the same layout (conservative) or zero pad
#                 rows (never hit).
_NGROUPS = 7       # (axis, sign) groups + 1 dead group
_NGROUPS_FINE = 25  # (axis, sign, minor-sign quadrant) groups + dead
_BROWS = 128      # group rows per block
_UPB = _BROWS // _U  # gather units per block
_BREF = _BROWS * _G  # refs per block (768)
# Blocks per chunk of the plain-XLA sweep. Each chunk materializes its
# gathered units (64 KiB per block) and its rays (tile * 64 B per block):
# ~200 MiB at tile 512, a small fraction of a GPU's memory, while one
# chunk still holds 2048 * 512 * 768 = 8e8 pairs of parallel work.
_CHUNK = 2048
# Triton kernel shape: rays per program (a sub-tile of the ray tile, so
# tile 256 and tile 512 compile to the same per-program code) and refs
# per inner step (32 group rows of one ref slot).
_RS = 64
_KC = 32
_WARPS = 4


def default_impl() -> str:
    """The sweep implementation used when trace_sweep is given none."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


# ----------------------------------------------------------------------
# Intersection: one ray tile x one block of gathered refs
# ----------------------------------------------------------------------

def _ray_terms(col):
    """(o, d, m, tmin, tmax) of the packed X rows (grid/packet.rays_to_x)
    as a tuple; `col(c)` extracts column c broadcastable against the
    coefficients."""
    return tuple(col(c) for c in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13))


def _mt_pairs(ray, cf):
    """Linear-form Moller-Trumbore (grid/packet.py module docstring):
    det, t*det, u*det, v*det are dots of per-ref coefficient rows with
    (o, d, m = o x d). `ray` from _ray_terms, `cf` the 16 coefficient
    columns; both broadcast to the pair shape. Shared by the XLA sweep
    and the Triton kernel, so both evaluate the same f32 expression."""
    ox, oy, oz, dx, dy, dz, mx, my, mz, tmin, tmax = ray
    (n0, n1, n2, b0, b1, b2, c0, c1, c2,
     d0, d1, d2, e0, e1, e2, f) = cf
    det = dx * n0 + dy * n1 + dz * n2      # = -det_MT
    tt = f - (ox * n0 + oy * n1 + oz * n2)
    uu = mx * b0 + my * b1 + mz * b2 + dx * c0 + dy * c1 + dz * c2
    vv = mx * d0 + my * d1 + mz * d2 + dx * e0 + dy * e1 + dz * e2
    inv = 1.0 / det  # det = 0 -> inf/NaN, self-filtered
    t = tt * inv
    u = uu * inv
    v = vv * inv
    # min-form barycentric test; NaN/inf compare false. The eps guard
    # keeps near-parallel slivers from phantom far hits.
    edge = jnp.minimum(jnp.minimum(u, v), 1.0 - (u + v))
    ok = ((edge >= 0.0) & (jnp.abs(det) > 1e-12) & (t > tmin)
          & (t < tmax))
    return ok, t, u, v


def _lex_better(t, i, bt, bi):
    """(t, i) precedes (bt, bi): smaller t, then smaller id."""
    return (t < bt) | ((t == bt) & (i < bi))


def _lexmin(a, b):
    ta, ia, ua, va = a
    tb, ib, ub, vb = b
    take = _lex_better(tb, ib, ta, ia)
    return (jnp.where(take, tb, ta), jnp.where(take, ib, ia),
            jnp.where(take, ub, ua), jnp.where(take, vb, va))


def _block_hits(xp_ext, cols_u, gidx_c, tile_of_c, tile):
    """Plain-XLA intersection of a chunk of blocks: per block, every ray
    of its tile against the block's 768 refs, reduced over refs to the
    lexicographically smallest (t, id) candidate. Returns (t, id, u, v),
    each (w, tile); id _BIGID (t inf) where no ref hit."""
    w = tile_of_c.shape[0]
    g = cols_u[gidx_c.reshape(w, _UPB)].reshape(w, _BROWS, _GW)
    g = g[..., :_G * MT_COLS].reshape(w, _BREF, MT_COLS)
    x = xp_ext.reshape(-1, tile, 16)[tile_of_c]           # (w, tile, 16)
    ray = _ray_terms(lambda c: x[:, :, c:c + 1])
    ok, t, u, v = _mt_pairs(ray, tuple(g[:, None, :, c]
                                       for c in range(16)))
    ids = jnp.broadcast_to(g[:, None, :, 16].astype(jnp.int32), t.shape)
    return jax.lax.reduce(
        (jnp.where(ok, t, jnp.inf), jnp.where(ok, ids, _BIGID), u, v),
        (np.float32(np.inf), np.int32(_BIGID), np.float32(0),
         np.float32(0)),
        _lexmin, (2,))


def _merge_blocks(best, res, tile_of_c):
    """Fold per-block candidates (w, tile) into the running per-ray best
    (nt, tile) of their tiles: a lexicographic (t, id) min done as
    scatter-min on t, then on id among equal t, then u/v of the winner.
    Blocks past the demand carry tile_of == nt and land in a pad row.
    Duplicate (t, id) candidates (a tri referenced by two blocks) carry
    identical u/v, so the scatter-max picks either."""
    bt, bid, bu, bv = best
    rt, rid, ru, rv = res
    nt = bt.shape[0]

    def pad(a, fill):
        return jnp.concatenate([a, jnp.full((1,) + a.shape[1:], fill,
                                            a.dtype)])

    bt_p = pad(bt, _BIG)
    bid_p = pad(jnp.where(bid < 0, _BIGID, bid), _BIGID)
    new_t = bt_p.at[tile_of_c].min(rt)
    cand_t = new_t[tile_of_c]
    new_id = jnp.where(bt_p == new_t, bid_p, _BIGID).at[tile_of_c].min(
        jnp.where(rt == cand_t, rid, _BIGID))
    keep = (bt_p == new_t) & (bid_p == new_id)
    sel = (rt == cand_t) & (rid == new_id[tile_of_c])

    def pick(b, r):
        return jnp.where(keep, pad(b, 0.0), -jnp.inf).at[tile_of_c].max(
            jnp.where(sel, r, -jnp.inf))

    found = new_id < _BIGID
    return (jnp.where(found, new_t, bt_p)[:nt],
            jnp.where(found, new_id, -1)[:nt],
            jnp.where(found, pick(bu, ru), 0.0)[:nt],
            jnp.where(found, pick(bv, rv), 0.0)[:nt])


def _sweep_xla(best, xp_ext, cols_u, gidx, tile_of, n_blocks, tile):
    """One round's blocks through the plain-XLA intersection, in chunks
    of _CHUNK blocks under a dynamic-trip while_loop (only live chunks
    run; the program holds one chunk body whatever the budget)."""
    bcap = tile_of.shape[0]
    w = min(_CHUNK, bcap)

    def body(state):
        i, best = state
        # Edge chunks clamp to [bcap - w, bcap): re-merging blocks
        # already merged is exact (the merge is a lexicographic min).
        off = jnp.minimum(i * w, bcap - w)
        t_c = jax.lax.dynamic_slice_in_dim(tile_of, off, w)
        gi_c = jax.lax.dynamic_slice_in_dim(gidx, off * _UPB, w * _UPB)
        res = _block_hits(xp_ext, cols_u, gi_c, t_c, tile)
        return i + 1, _merge_blocks(best, res, t_c)

    def cond(state):
        return state[0] * w < n_blocks

    return jax.lax.while_loop(cond, body, (jnp.int32(0), best))[1]


def _sweep_kernel(x_ref, bt_ref, bid_ref, bu_ref, bv_ref, bstart_ref,
                  bcount_ref, thr_ref, gidx_ref, cols_ref,
                  ot_ref, oid_ref, ou_ref, ov_ref, *, any_hit):
    """One program: _RS rays of one tile against the tile's whole block
    run. Per-lane accumulators (_RS, _KC) start at the rays' current
    best and take a candidate when it is lexicographically better; the
    flush reduces them over the _KC slots."""
    tile_i = pl.program_id(0)
    ray = _ray_terms(lambda c: x_ref[c, :][:, None])
    tmax = x_ref[13, :]
    shape = (_RS, _KC)
    bid = bid_ref[...]
    acc = (jnp.broadcast_to(bt_ref[...][:, None], shape),
           jnp.broadcast_to(jnp.where(bid < 0, _BIGID, bid)[:, None],
                            shape),
           jnp.broadcast_to(bu_ref[...][:, None], shape),
           jnp.broadcast_to(bv_ref[...][:, None], shape))
    r = jnp.arange(_KC, dtype=jnp.int32)
    zero = jnp.zeros((_KC,), jnp.int32)
    steps_per_slot = np.int32(_BROWS // _KC)

    def block(i, acc):
        b = bstart_ref[tile_i] + i
        cut = jnp.min(acc[0], axis=1)
        if not any_hit:
            cut = jnp.minimum(cut, tmax)
        done = jnp.max(cut) <= thr_ref[b]

        def step(j, acc):
            # lax.div/rem: jnp's floor-division sign fix-ups do not lower
            # to Triton, and every operand here is non-negative.
            rows = jax.lax.rem(j, steps_per_slot) * _KC + r
            unit = gidx_ref[b * _UPB + jax.lax.div(rows, _U)]
            crow = unit * _U + jax.lax.rem(rows, _U)
            lane = jax.lax.div(j, steps_per_slot) * MT_COLS + zero
            cf = tuple(cols_ref[crow, lane + c][None, :]
                       for c in range(17))
            ok, t, u, v = _mt_pairs(ray, cf[:16])
            ids = jnp.broadcast_to(cf[16].astype(jnp.int32), shape)
            at, aid, au, av = acc
            better = ok & _lex_better(t, ids, at, aid)
            return (jnp.where(better, t, at), jnp.where(better, ids, aid),
                    jnp.where(better, u, au), jnp.where(better, v, av))

        def sweep(acc):
            return jax.lax.fori_loop(0, _G * steps_per_slot, step, acc)

        return jax.lax.cond(done, lambda a: a, sweep, acc)

    at, aid, au, av = jax.lax.fori_loop(0, bcount_ref[tile_i], block, acc)
    t_best = jnp.min(at, axis=1)
    at_min = at == t_best[:, None]
    id_best = jnp.min(jnp.where(at_min, aid, _BIGID), axis=1)
    sel = at_min & (aid == id_best[:, None])
    found = id_best < _BIGID
    ot_ref[...] = jnp.where(found, t_best, bt_ref[...])
    oid_ref[...] = jnp.where(found, id_best, -1)
    ou_ref[...] = jnp.where(
        found, jnp.max(jnp.where(sel, au, -jnp.inf), axis=1), 0.0)
    ov_ref[...] = jnp.where(
        found, jnp.max(jnp.where(sel, av, -jnp.inf), axis=1), 0.0)


def _sweep_triton(best, xt_ext, cols, gidx, tile_of, tminb, tile,
                  any_hit, interpret):
    """One round's blocks through the Triton kernel; returns the new
    per-ray best. Grid (tile, ray sub-tile); blocks of a tile are
    contiguous in the stream (tile_of is non-decreasing), so each
    program's run is [bstart, bstart + bcount)."""
    nt = best[0].shape[0]
    cnt = jnp.zeros((nt + 1,), jnp.int32).at[tile_of].add(1)
    bstart = (jnp.cumsum(cnt) - cnt)[:nt]
    bcount = cnt[:nt]
    thr = jax.lax.bitcast_convert_type(tminb, jnp.float32)
    sub = tile // _RS

    def rays(i, s):
        return (i * sub + s,)

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i, s: (0,) * a.ndim)

    flat = [a.reshape(-1) for a in best]
    vec = pl.BlockSpec((_RS,), rays)
    out = pl.pallas_call(
        functools.partial(_sweep_kernel, any_hit=any_hit),
        grid=(nt, sub),
        in_specs=[pl.BlockSpec((16, _RS), lambda i, s: (0, i * sub + s)),
                  vec, vec, vec, vec, whole(bstart), whole(bcount),
                  whole(thr), whole(gidx), whole(cols)],
        out_specs=[vec, vec, vec, vec],
        out_shape=[jax.ShapeDtypeStruct(a.shape, a.dtype) for a in flat],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="sweep_block_run",
    )(xt_ext, *flat, bstart, bcount, thr, gidx, cols)
    return tuple(a.reshape(nt, tile) for a in out)


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# Binning and per-tile precompute (all XLA)
# ----------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_pad", "tile", "fine"))
def _bin_rays(org, dir, tmin, tmax, n_pad, tile, fine=False):
    """Group rays by (major axis, sign) into tile-aligned segments via
    masked cumsums (stable counting sort; no device-wide lax.sort).
    Returns (xp_ext (rows, 16), inv) with a trailing all-dead dummy
    tile; inv maps row -> original ray (-1 padding).

    Masked-dead rays (tmax <= 0) go to a final dead group so live tiles
    stay densely packed — sort-based compaction with static shapes.
    Within groups the stable sort PRESERVES caller order, which for
    camera-derived secondary waves carries image-block origin locality
    finer than any scene-space code: re-ordering an AO wave by
    (direction octant, 7-bit origin Morton) was measured to cost +33%
    block demand (Sponza 256^2 wave-1, plan-only probe), so no Morton
    pass here; ops/sortrays stays available for caller-side sorting of
    genuinely orderless waves.

    fine=True: subdivide each (axis, sign) group by the SIGNS of the
    two minor direction components (24 live groups + dead). Hemisphere-
    sampled waves (AO, diffuse bounces) have tile direction cones
    spanning the whole axis quadrant, so their frustum rects cover most
    of each slice's cross-section (measured 173k-block demand on a
    Sponza AO wave = 35x primaries); quartering the cone trades a ~2x
    wider per-quarter origin box (the subgroup's rays come from 4x the
    image area) for a 4x narrower direction fan."""
    x = rays_to_x(org, dir, tmin, tmax)
    n = x.shape[0]
    d = x[:, 4:7]
    ad = jnp.abs(d)
    axis = jnp.where(ad[:, 0] >= jnp.maximum(ad[:, 1], ad[:, 2]), 0,
                     jnp.where(ad[:, 1] >= ad[:, 2], 1, 2))
    sign = (jnp.take_along_axis(d, axis[:, None], axis=1)[:, 0]
            < 0).astype(jnp.int32)
    g6 = axis * 2 + sign
    if fine:
        d1 = jnp.take_along_axis(d, ((axis + 1) % 3)[:, None],
                                 axis=1)[:, 0]
        d2 = jnp.take_along_axis(d, ((axis + 2) % 3)[:, None],
                                 axis=1)[:, 0]
        sub = (d1 < 0).astype(jnp.int32) * 2 + (d2 < 0).astype(jnp.int32)
        glive, ng = g6 * 4 + sub, _NGROUPS_FINE
    else:
        glive, ng = g6, _NGROUPS
    g = jnp.where(x[:, 13] > 0, glive, ng - 1)

    ranks = jnp.zeros((n,), jnp.int32)
    counts = []
    for k in range(ng):
        mk = (g == k).astype(jnp.int32)
        ck = jnp.cumsum(mk)
        ranks = jnp.where(g == k, ck - 1, ranks)
        counts.append(ck[-1])
    counts = jnp.stack(counts)
    padded = -(-counts // tile) * tile
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(padded)[:-1].astype(jnp.int32)])
    pos = offs[g] + ranks

    # Scatter a 1-int permutation, then GATHER the 16-float rows (a
    # 64MB row scatter lowers poorly). inv == -1 rows -> the dead ray.
    inv = jnp.full((n_pad + tile,), -1, jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    dead = jnp.zeros((16,), jnp.float32)
    dead = dead.at[0].set(1.0).at[1].set(-1e30).at[4].set(1.0)
    xp_ext = jnp.where((inv >= 0)[:, None],
                       x[jnp.maximum(inv, 0)], dead[None, :])
    return xp_ext, inv[:n_pad]


@functools.partial(jax.jit, static_argnames=("n_pad", "tile"))
def _pad_coherent(org, dir, tmin, tmax, n_pad, tile):
    """Bin-free packet layout for rays that are already coherent (e.g.
    block-Morton primaries): keep ray order, pad with dead rays, append
    the all-dead dummy tile. Skips _bin_rays' whole-wave permutation
    gather. Tiles need not be (axis, sign)-pure: the
    per-tile axis comes from ray 0 and stray rays only widen that
    tile's rects (correct, just less efficient), so callers should only
    use this for camera-coherent waves."""
    x = rays_to_x(org, dir, tmin, tmax)
    n = x.shape[0]
    dead = jnp.zeros((16,), jnp.float32)
    dead = dead.at[0].set(1.0).at[1].set(-1e30).at[4].set(1.0)
    pad = jnp.broadcast_to(dead, (n_pad + tile - n, 16))
    return jnp.concatenate([x, pad], axis=0)


def _tile_tabs(bbox_lo, bbox_hi, dims3):
    """Per-layout (cs, dims, lo) tables in (slice, row, col) order.
    Traced (tiny) — called inside the frame jit."""
    ext = bbox_hi - bbox_lo
    cs_rows, n_rows, lo_rows = [], [], []
    for a in range(3):
        da, db, dc = dims3[a]
        b, c = (a + 1) % 3, (a + 2) % 3
        cs_rows.append(jnp.stack([ext[a] / da, ext[b] / db, ext[c] / dc]))
        n_rows.append(jnp.array([da, db, dc], jnp.int32))
        lo_rows.append(jnp.stack([bbox_lo[a], bbox_lo[b], bbox_lo[c]]))
    return (jnp.stack(cs_rows), jnp.stack(n_rows), jnp.stack(lo_rows))


def _precompute(xp, cs_tab, n_tab, lo_tab, bbox_lo, bbox_hi, tile,
                planes):
    """Static per-ray / per-tile quantities for the round loop.
    Traced — called inside the frame jit."""
    nt = xp.shape[0] // tile
    x3 = xp.reshape(nt, tile, 16)
    o = x3[..., 1:4]
    d = x3[..., 4:7]
    tmin = x3[..., 12]
    tmax = x3[..., 13]

    # Tile-uniform axis/sign from ray 0 (tiles are pure by binning).
    ad0 = jnp.abs(x3[:, 0, 4:7])
    axis = jnp.where(ad0[:, 0] >= jnp.maximum(ad0[:, 1], ad0[:, 2]), 0,
                     jnp.where(ad0[:, 1] >= ad0[:, 2], 1, 2))
    d0 = jnp.take_along_axis(x3[:, 0, 4:7], axis[:, None], 1)[:, 0]
    step = jnp.where(d0 < 0, -1, 1).astype(jnp.int32)

    def perm(arr, ax):  # (nt, tile, 3) -> (nt, tile) at per-tile axis
        return jnp.take_along_axis(arr, ax[:, None, None], 2)[..., 0]

    a1 = (axis + 1) % 3
    a2 = (axis + 2) % 3
    o_a, o_b, o_c = perm(o, axis), perm(o, a1), perm(o, a2)
    d_a, d_b, d_c = perm(d, axis), perm(d, a1), perm(d, a2)

    def inv(dv):
        nz = jnp.abs(dv) > 1e-30
        return jnp.where(nz, 1.0 / jnp.where(nz, dv, 1.0),
                         jnp.where(dv < 0, -_BIG, _BIG))

    inv_a = inv(d_a)

    # Scene slab test (bbox identical across layouts).
    def slab1(oc, dc_, lo, hi):
        i = inv(dc_)
        t0 = (lo - oc) * i
        t1 = (hi - oc) * i
        bad = jnp.isnan(t0 * t1)
        return (jnp.where(bad, -_BIG, jnp.minimum(t0, t1)),
                jnp.where(bad, _BIG, jnp.maximum(t0, t1)))

    nx, fx = slab1(o[..., 0], d[..., 0], bbox_lo[0], bbox_hi[0])
    ny, fy = slab1(o[..., 1], d[..., 1], bbox_lo[1], bbox_hi[1])
    nz_, fz = slab1(o[..., 2], d[..., 2], bbox_lo[2], bbox_hi[2])
    enter = jnp.maximum(jnp.maximum(nx, ny), jnp.maximum(nz_, tmin))
    leave = jnp.minimum(jnp.minimum(fx, fy), jnp.minimum(fz, tmax))
    alive = enter <= leave

    # Per-tile grid constants.
    n_a = n_tab[axis, 0]

    # Entry slice from the packet's entry points: slice k spans
    # [P_k, P_{k+1}) of the per-layout (possibly non-uniform) plane
    # table, so the containing slice = count of interior planes <= pos.
    pa_in = o_a + enter * d_a
    pa_sel = jnp.where(alive, pa_in, jnp.where(step[:, None] > 0,
                                               _BIG, -_BIG))
    front = jnp.where(step > 0, jnp.min(pa_sel, axis=1),
                      jnp.max(pa_sel, axis=1))
    p_tile = planes[axis]                       # (nt, PMAX)
    pidx = jnp.arange(planes.shape[1], dtype=jnp.int32)
    interior = (pidx[None, :] >= 1) & (pidx[None, :] <= n_a[:, None] - 1)
    k0 = jnp.sum(((p_tile <= front[:, None]) & interior).astype(
        jnp.int32), axis=1)
    k0 = jnp.clip(k0, 0, n_a - 1)

    per_ray = dict(o_a=o_a, o_b=o_b, o_c=o_c, d_a=d_a, d_b=d_b, d_c=d_c,
                   inv_a=inv_a, enter=enter, leave=leave, alive=alive,
                   tmax=tmax)
    per_tile = dict(axis=axis, step=step, k0=k0, p_tile=p_tile)
    return per_ray, per_tile


# ----------------------------------------------------------------------
# Round planning (all XLA, inside the frame jit)
# ----------------------------------------------------------------------

def _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka,
                best_t, dims3, slab, any_hit):
    """Dense per-(tile, slice) phase shared by the dense slot planner
    (_plan) and the compacted row-stream planner (_plan_items2):
    per-tile axis tables, per-quarter frustum bounds, per-slice
    t-windows and row rects. Reductions and elementwise math only —
    no device-wide gathers or scatters."""
    axis = per_tile["axis"]
    step = per_tile["step"]
    nt = axis.shape[0]
    cs_b = cs_tab[axis, 1]
    cs_c = cs_tab[axis, 2]
    lo_b = lo_tab[axis, 1]
    lo_c = lo_tab[axis, 2]
    n_a = n_tab[axis, 0]
    n_b = n_tab[axis, 1]
    n_c = n_tab[axis, 2]

    # Ray liveness: best hit precedes the slab's entry plane -> done.
    # Plane positions come from the per-layout table (non-uniform
    # slice spacing; see grid/packet._slice_planes).
    p_tile = per_tile["p_tile"]                         # (nt, PMAX)
    plane0 = jnp.take_along_axis(
        p_tile, jnp.clip(ka + (step < 0), 0, n_a)[:, None],
        axis=1)[:, 0]
    t_entry = (plane0[:, None] - per_ray["o_a"]) * per_ray["inv_a"]
    lim = jnp.minimum(per_ray["tmax"], per_ray["leave"])
    if any_hit:
        done = best_t < jnp.minimum(per_ray["tmax"], _BIG)
    else:
        done = best_t <= t_entry
    live = per_ray["alive"] & ~done & (t_entry < lim) \
        & (ka[:, None] >= 0) & (ka[:, None] < n_a[:, None])

    # Frustum bounds per QUARTER tile (rays are Morton-ordered, so
    # quarters are spatially coherent); the rect is the live union —
    # quarters that terminate early stop widening it.
    def q(v):  # (nt, tile) -> (nt, SUB, tile/SUB)
        return v.reshape(nt, _SUB, -1)

    liveq = q(live)

    def mnq(v):
        return jnp.min(jnp.where(liveq, q(v), _BIG), axis=2)

    def mxq(v):
        return jnp.max(jnp.where(liveq, q(v), -_BIG), axis=2)

    ob_lo, ob_hi = mnq(per_ray["o_b"]), mxq(per_ray["o_b"])
    oc_lo, oc_hi = mnq(per_ray["o_c"]), mxq(per_ray["o_c"])
    db_lo, db_hi = mnq(per_ray["d_b"]), mxq(per_ray["d_b"])
    dc_lo, dc_hi = mnq(per_ray["d_c"]), mxq(per_ray["d_c"])
    oa_lo, oa_hi = mnq(per_ray["o_a"]), mxq(per_ray["o_a"])
    ia_lo, ia_hi = mnq(per_ray["inv_a"]), mxq(per_ray["inv_a"])
    t_lo0 = jnp.maximum(mnq(per_ray["enter"]), 0.0)
    t_cap = mxq(jnp.minimum(jnp.minimum(best_t, per_ray["tmax"]),
                            per_ray["leave"]))

    # Slab slices: (nt, S); per-quarter per-slice t range and rect.
    ks = ka[:, None] + step[:, None] * jnp.arange(slab, dtype=jnp.int32)
    k_ok = (ks >= 0) & (ks < n_a[:, None])
    ks_cl = jnp.clip(ks, 0, n_a[:, None])
    pl0 = jnp.take_along_axis(p_tile, ks_cl, axis=1)   # (nt, S)
    pl1 = jnp.take_along_axis(
        p_tile, jnp.minimum(ks_cl + 1, n_a[:, None]), axis=1)

    def tq(p):  # (nt,S) plane x (nt,SUB) bounds -> (nt,SUB,S)
        cands = []
        for oe in (oa_lo, oa_hi):
            for ie in (ia_lo, ia_hi):
                cands.append((p[:, None, :] - oe[:, :, None])
                             * ie[:, :, None])
        return cands

    cands = tq(pl0) + tq(pl1)
    tl = functools.reduce(jnp.minimum, cands)
    th = functools.reduce(jnp.maximum, cands)
    tl = jnp.maximum(tl, t_lo0[:, :, None])
    th = jnp.minimum(th, t_cap[:, :, None])
    t_ok = tl <= th                                     # (nt,SUB,S)

    def minor(olo, ohi, dlo, dhi, lo_m, cs_m, n_m):
        x00 = tl * dlo[:, :, None]
        x01 = tl * dhi[:, :, None]
        x10 = th * dlo[:, :, None]
        x11 = th * dhi[:, :, None]
        vlo = olo[:, :, None] + jnp.minimum(jnp.minimum(x00, x01),
                                            jnp.minimum(x10, x11))
        vhi = ohi[:, :, None] + jnp.maximum(jnp.maximum(x00, x01),
                                            jnp.maximum(x10, x11))
        ics = (1.0 / cs_m)[:, None, None]
        lo_i = ((vlo - lo_m[:, None, None]) * ics).astype(jnp.int32)
        hi_i = ((vhi - lo_m[:, None, None]) * ics).astype(jnp.int32)
        return (jnp.clip(lo_i, 0, n_m[:, None, None] - 1),
                jnp.clip(hi_i, 0, n_m[:, None, None] - 1))

    b0q, b1q = minor(ob_lo, ob_hi, db_lo, db_hi, lo_b, cs_b, n_b)
    rect_okq = t_ok & k_ok[:, None, :]                  # (nt,SUB,S)
    # Full-tile row range = union over live quarters.
    ibig = jnp.int32(2 ** 20)
    b0 = jnp.min(jnp.where(rect_okq, b0q, ibig), axis=1)   # (nt,S)
    b1 = jnp.max(jnp.where(rect_okq, b1q, -1), axis=1)
    rect_ok = jnp.any(rect_okq, axis=1)
    b0 = jnp.where(rect_ok, b0, 0)
    b1 = jnp.where(rect_ok, b1, 0)

    # rowinfo flat indexing: per-layout row-index base + per-tile
    # strides (the rs offsets themselves live IN rowinfo — rows are
    # ragged under per-row column refinement, grid/packet.py).
    qbase_list = []
    off = 0
    for a in range(3):
        da_, db_, _ = dims3[a]
        qbase_list.append(off)
        off += da_ * db_
    qbase = jnp.array(qbase_list, jnp.int32)[axis]          # (nt,)
    k_cl = jnp.clip(ks, 0, n_a[:, None] - 1)

    return dict(
        axis=axis, step=step, nt=nt, cs_b=cs_b, cs_c=cs_c, lo_b=lo_b,
        lo_c=lo_c, n_a=n_a, n_b=n_b, n_c=n_c, qbase=qbase,
        ob_lo=ob_lo, ob_hi=ob_hi, oc_lo=oc_lo, oc_hi=oc_hi,
        db_lo=db_lo, db_hi=db_hi, dc_lo=dc_lo, dc_hi=dc_hi,
        tl=tl, th=th, t_ok=t_ok, rect_okq=rect_okq, rect_ok=rect_ok,
        b0q=b0q, b1q=b1q, b0=b0, b1=b1, ks=ks, k_cl=k_cl)


def _plan(per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo, ka,
          best_t, dims3, slab, any_hit, rmax=_RMAX):
    """One slab's plan, DENSE slot form: per-tile frustum rect per
    slice, turned into REF-level ranges via the rs tables (2 gathers
    per rect row). Returns (range_start, range_count, thr_bits)
    flattened over (tile, slice, rmax row slots + 1 tail slot);
    thr_bits is the i32 bit pattern of the slice's tile-entry t (the
    kernel's early-out threshold: no ref of the slot can hit earlier
    than it). Cost scales with nt*S*(rmax+1) SLOTS, live or not — the
    right trade for coherent waves (few live rows, tiny slot space);
    incoherent waves use _plan_items2.
    """
    D = _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka,
                    best_t, dims3, slab, any_hit)
    nt = D["nt"]
    cs_b, cs_c = D["cs_b"], D["cs_c"]
    lo_b, lo_c = D["lo_b"], D["lo_c"]
    n_a, n_b, n_c = D["n_a"], D["n_b"], D["n_c"]
    ob_lo, ob_hi = D["ob_lo"], D["ob_hi"]
    oc_lo, oc_hi = D["oc_lo"], D["oc_hi"]
    db_lo, db_hi = D["db_lo"], D["db_hi"]
    dc_lo, dc_hi = D["dc_lo"], D["dc_hi"]
    tl, th = D["tl"], D["th"]
    rect_okq, rect_ok = D["rect_okq"], D["rect_ok"]
    b0q, b1q, b0, b1 = D["b0q"], D["b1q"], D["b0"], D["b1"]
    ks, k_cl = D["ks"], D["k_cl"]
    qbase = D["qbase"]
    ibig = jnp.int32(2 ** 20)

    # Per-ROW column trim (the big pair cut): the frustum sweeps
    # diagonally through the (row, col) cross-section, so a slice-wide
    # [c0, c1] rect overcovers every row. For each of the _RMAX row
    # slots, restrict each quarter's slice t-interval to the t's where
    # some ray is inside that row's b-band (outer interval hull; when a
    # quarter's d_b interval straddles 0 the band time is unbounded and
    # the trim falls back to the slice interval), then derive the
    # column interval from the restricted t's. Measured on Sponza
    # primaries this cuts gathered refs ~=1.4x vs the slice-wide rect.
    rr = jnp.arange(rmax, dtype=jnp.int32)
    j_r = b0[:, :, None] + rr[None, None, :]                # (nt,S,R)
    db_pos = db_lo > 1e-30
    db_neg = db_hi < -1e-30
    db_ok = db_pos | db_neg                                  # (nt,SUB)
    safe_db_lo = jnp.where(db_ok, db_lo, 1.0)
    safe_db_hi = jnp.where(db_ok, db_hi, 1.0)
    idb_a = 1.0 / safe_db_lo
    idb_b = 1.0 / safe_db_hi
    # Broadcast shapes: quarter bounds (nt,SUB,1,1), slice t (nt,SUB,
    # S,1), rows (nt,1,S,R) -> all (nt,SUB,S,R).
    wb0 = (lo_b[:, None, None, None]
           + j_r[:, None, :, :].astype(jnp.float32)
           * cs_b[:, None, None, None])
    wb1 = wb0 + cs_b[:, None, None, None]
    nlo0 = wb0 - ob_hi[:, :, None, None]
    nhi0 = wb0 - ob_lo[:, :, None, None]
    nlo1 = wb1 - ob_hi[:, :, None, None]
    nhi1 = wb1 - ob_lo[:, :, None, None]
    ia = idb_a[:, :, None, None]
    ib = idb_b[:, :, None, None]

    def hull4(na, nb):
        p0, p1 = na * ia, na * ib
        p2, p3 = nb * ia, nb * ib
        return (jnp.minimum(jnp.minimum(p0, p1), jnp.minimum(p2, p3)),
                jnp.maximum(jnp.maximum(p0, p1), jnp.maximum(p2, p3)))

    e0_lo, e0_hi = hull4(nlo0, nhi0)     # crossing times of band lo
    e1_lo, e1_hi = hull4(nlo1, nhi1)     # crossing times of band hi
    tb_lo = jnp.minimum(e0_lo, e1_lo)
    tb_hi = jnp.maximum(e0_hi, e1_hi)
    dbok4 = db_ok[:, :, None, None]
    tj_lo = jnp.where(dbok4, jnp.maximum(tl[:, :, :, None], tb_lo),
                      tl[:, :, :, None])
    tj_hi = jnp.where(dbok4, jnp.minimum(th[:, :, :, None], tb_hi),
                      th[:, :, :, None])
    row_okq = (rect_okq[:, :, :, None] & (tj_lo <= tj_hi)
               & (j_r[:, None, :, :] <= b1q[:, :, :, None])
               & (j_r[:, None, :, :] >= b0q[:, :, :, None]))
    # Column interval of each quarter within the row's t window.
    x00 = tj_lo * dc_lo[:, :, None, None]
    x01 = tj_lo * dc_hi[:, :, None, None]
    x10 = tj_hi * dc_lo[:, :, None, None]
    x11 = tj_hi * dc_hi[:, :, None, None]
    vlo = oc_lo[:, :, None, None] + jnp.minimum(
        jnp.minimum(x00, x01), jnp.minimum(x10, x11))
    vhi = oc_hi[:, :, None, None] + jnp.maximum(
        jnp.maximum(x00, x01), jnp.maximum(x10, x11))
    # Per-row rowinfo (ragged rs offset + column multiplier — the
    # per-row refinement of grid/packet.py): one (nt, S, R) gather.
    j_cl = jnp.minimum(j_r, n_b[:, None, None] - 1)
    ri = rowinfo[qbase[:, None, None]
                 + k_cl[:, :, None] * n_b[:, None, None] + j_cl]
    roff = ri & 0x0FFFFFFF
    lgm = (ri >> 28)[:, None, :, :]                         # (nt,1,S,R)
    ics = (1.0 / cs_c)[:, None, None, None] * jnp.exp2(
        lgm.astype(jnp.float32))
    lo4 = lo_c[:, None, None, None]
    ncl = (n_c[:, None, None, None] << lgm) - 1
    c0q_r = jnp.clip(((vlo - lo4) * ics).astype(jnp.int32), 0, ncl)
    c1q_r = jnp.clip(((vhi - lo4) * ics).astype(jnp.int32), 0, ncl)
    c0_r = jnp.min(jnp.where(row_okq, c0q_r, ibig), axis=1)  # (nt,S,R)
    c1_r = jnp.max(jnp.where(row_okq, c1q_r, -1), axis=1)
    row_any = jnp.any(row_okq, axis=1)
    c0_r = jnp.where(row_any, c0_r, 0)
    c1_r = jnp.where(row_any, c1_r, -1)  # empty range when uncovered

    # Per-row c-trimmed ranges + untrimmed multi-row tail.
    row_ok = (j_r <= b1[:, :, None]) & rect_ok[:, :, None] & row_any
    g1 = rs[roff + c0_r]
    g2 = rs[roff + jnp.maximum(c1_r, 0) + 1]

    has_tail = rect_ok & (b1 - b0 + 1 > rmax)
    jt = jnp.minimum(b0 + rmax, n_b[:, None] - 1)
    ri_t = rowinfo[qbase[:, None] + k_cl * n_b[:, None] + jt]
    ri_b = rowinfo[qbase[:, None] + k_cl * n_b[:, None] + b1]
    t1 = rs[ri_t & 0x0FFFFFFF]
    t2 = rs[(ri_b & 0x0FFFFFFF) + (n_c[:, None] << (ri_b >> 28))]

    # Emit in GATHER UNITS (32 refs): round the ref range outward — the
    # extra refs at each end are real triangles of the same layout or
    # zero pad rows (conservative-correct; layout offsets in rs are
    # 768-multiples so units never straddle layouts).
    refs_u = _G * _U
    lo_r = jnp.concatenate([g1, t1[:, :, None]], axis=2)
    hi_r = jnp.concatenate([g2, t2[:, :, None]], axis=2)
    lo_g = lo_r // refs_u
    hi_g = -(-hi_r // refs_u)
    ok3 = jnp.concatenate([row_ok, has_tail[:, :, None]], axis=2)
    valid = ok3 & (hi_r > lo_r)
    # Boundary-unit dedup: a slice's slots (rows ascending, then the
    # tail) are DISJOINT ascending ref spans, so their unit round-outs
    # can only overlap by the single unit shared at each boundary.
    # Clamping each slot's start unit to the running max end of the
    # slice's earlier slots drops exactly those double-gathered units
    # (the dropped unit is always fully covered by the earlier slot's
    # emission — conservative-correct). Measured: the per-row column
    # trim makes ranges short (mean 2.8 units), so boundary units are
    # a real fraction of the stream.
    hi_m = jnp.where(valid, hi_g, 0)
    run = jnp.zeros(hi_m.shape[:2], hi_m.dtype)
    lo_cl = []
    for r in range(rmax + 1):
        lo_cl.append(jnp.maximum(lo_g[:, :, r], run))
        run = jnp.maximum(run, hi_m[:, :, r])
    lo_g = jnp.stack(lo_cl, axis=2)
    cnt_g = jnp.where(valid, jnp.maximum(hi_g - lo_g, 0), 0)

    # Early-out thresholds: closest-hit slots can't improve a ray once
    # its best <= the slot's tile-entry t (>= 0, so int bit order ==
    # float order). Row slots use the row-restricted entry time tj_lo
    # (tighter than the slice entry); the tail slot uses the slice
    # entry. Any-hit is done the moment any hit exists: threshold =
    # largest float < _BIG.
    if any_hit:
        thr = jnp.full(cnt_g.shape, _BIG_BITS - 1, jnp.int32)
    else:
        t_thr = jnp.min(jnp.where(rect_okq, tl, _BIG), axis=1)  # (nt,S)
        t_thr_r = jnp.min(jnp.where(row_okq, tj_lo, _BIG),
                          axis=1)                             # (nt,S,R)
        t_all = jnp.concatenate([t_thr_r, t_thr[:, :, None]], axis=2)
        # Threshold safety for shared boundary units: the running-max
        # clamp above hands a later slot's first unit to an EARLIER
        # slot's emission, so each slot's threshold must lower-bound
        # every later valid slot of its slice whose refs it may carry
        # — a suffix-min across the slot axis. No-op when tj_lo
        # ascends with j (single-quarter/coherent tiles); mixed-sign
        # tiles lose a few skips, never hits.
        t_all = jnp.where(valid, t_all, _BIG)
        t_all = jax.lax.cummin(t_all[:, :, ::-1], axis=2)[:, :, ::-1]
        thr = jax.lax.bitcast_convert_type(t_all, jnp.int32)
    return lo_g.reshape(-1), cnt_g.reshape(-1), thr.reshape(-1)


def _bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _fbits(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _plan_items2(per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo,
                 ka, best_t, dims3, slab, any_hit, rowcap, bcap,
                 dead_idx):
    """Compacted row-stream planner + unit packer.

    The dense slot planner's gathers and item streams scale with
    nt * S * (rmax + 1) SLOTS whether rows are live or not. Coherent
    primaries live happily in that regime (tiny slot space, ~8% live),
    but incoherent waves need BOTH many trimmed rows (tall rects — the
    untrimmed tail carried most of their demand) and small tiles, which
    inflate the dense slot space by two orders of magnitude. This path:

    1. dense phase (_plan_dense): per-(tile, slice) rects — cheap
       elementwise math, no gathers;
    2. expands exactly the LIVE rect rows into a static row stream
       (`rowcap` capacity, overflow-flagged) via scatter+cumsum;
    3. gathers ONE packed 64-lane feature row per row item and derives
       the per-quarter column trim for EVERY row (no untrimmed tail);
    4. packs gather units block-by-block from the compact stream (the
       roff/thr forward-fill scatters are rowcap-long instead of
       slot-space-long).

    Returns (gidx, tile_of, tminb, n_blocks, demand_units, row_ovf).
    Slot order is (tile, slice-march, row-ascending), so consecutive
    rows of one slice have ascending, disjoint ref spans (shared
    boundary units are clamped away pairwise)."""
    D = _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka,
                    best_t, dims3, slab, any_hit)
    nt = D["nt"]
    S = slab

    nrows_d = jnp.where(D["rect_ok"], D["b1"] - D["b0"] + 1, 0)
    counts = nrows_d.reshape(-1)                        # (nt*S,)
    src, rank, valid_row, total_rows = expand_by_counts(counts, rowcap)
    tile_i = src // S

    # One packed feature table, gathered once per row item. Lanes:
    #  0:4 tl_q | 4:8 th_q | 8:12 b0q^ | 12:16 b1q^ | 16 k_cl^
    #  17 b0^ | 18 rbase^ (rs row base for (k_cl, j=0)) | 19 nc1^
    #  20 cs_b | 21 lo_b | 22 icc (1/cs_c) | 23 lo_c | 24 ncm1^
    #  32:36 ob_lo | 36:40 ob_hi | 40:44 db_lo | 44:48 db_hi
    #  48:52 oc_lo | 52:56 oc_hi | 56:60 dc_lo | 60:64 dc_hi
    # (^ = i32 bit pattern; quarter-bound lanes are per-tile values
    # broadcast across slices so ONE gather serves everything.)
    def t2s(v):  # (nt, SUB, S) -> (nt, S, SUB)
        return jnp.swapaxes(v, 1, 2)

    def bc(v):  # per-tile (nt,) or (nt, SUB) -> (nt, S, ...)
        return jnp.broadcast_to(
            v[:, None] if v.ndim == 1 else v[:, None, :],
            (nt, S) + v.shape[1:])

    nc1 = D["n_c"] + 1
    # Lane 18: rowinfo index base of the slice (qbase is the per-layout
    # ROW base; the ragged rs offset itself comes from rowinfo per row).
    rbase = D["qbase"][:, None] + D["k_cl"] * D["n_b"][:, None]
    fs = jnp.concatenate([
        t2s(D["tl"]), t2s(D["th"]),
        _fbits(t2s(D["b0q"])), _fbits(t2s(D["b1q"])),
        _fbits(D["k_cl"])[:, :, None],
        _fbits(D["b0"])[:, :, None],
        _fbits(rbase)[:, :, None],
        jnp.broadcast_to(_fbits(nc1)[:, None, None], (nt, S, 1)),
        jnp.broadcast_to(D["cs_b"][:, None, None], (nt, S, 1)),
        jnp.broadcast_to(D["lo_b"][:, None, None], (nt, S, 1)),
        jnp.broadcast_to((1.0 / D["cs_c"])[:, None, None], (nt, S, 1)),
        jnp.broadcast_to(D["lo_c"][:, None, None], (nt, S, 1)),
        jnp.broadcast_to(_fbits(D["n_c"] - 1)[:, None, None],
                         (nt, S, 1)),
        jnp.zeros((nt, S, 7), jnp.float32),
        bc(D["ob_lo"]), bc(D["ob_hi"]), bc(D["db_lo"]), bc(D["db_hi"]),
        bc(D["oc_lo"]), bc(D["oc_hi"]), bc(D["dc_lo"]), bc(D["dc_hi"]),
    ], axis=2).reshape(nt * S, 64)
    F = fs[src]                                          # (rowcap, 64)

    j = _bits(F[:, 17]) + rank                           # row index
    wb0 = F[:, 21] + j.astype(jnp.float32) * F[:, 20]
    wb1 = wb0 + F[:, 20]
    # Per-row refinement: rowinfo gather on the compact stream (the
    # column scale and the ragged rs offset are PER ROW now).
    ri = rowinfo[jnp.where(valid_row, _bits(F[:, 18]) + j, 0)]
    roff = ri & 0x0FFFFFFF
    lgm = ri >> 28
    icc = F[:, 22] * jnp.exp2(lgm.astype(jnp.float32))
    lo_c_r = F[:, 23]
    ncl = ((_bits(F[:, 24]) + 1) << lgm) - 1

    c0 = jnp.full((rowcap,), 2 ** 20, jnp.int32)
    c1 = jnp.full((rowcap,), -1, jnp.int32)
    row_any = jnp.zeros((rowcap,), bool)
    thr_t = jnp.full((rowcap,), _BIG, jnp.float32)
    for qq in range(_SUB):
        tlq = F[:, qq]
        thq = F[:, 4 + qq]
        b0qv = _bits(F[:, 8 + qq])
        b1qv = _bits(F[:, 12 + qq])
        oblo = F[:, 32 + qq]
        obhi = F[:, 36 + qq]
        dblo = F[:, 40 + qq]
        dbhi = F[:, 44 + qq]
        oclo = F[:, 48 + qq]
        ochi = F[:, 52 + qq]
        dclo = F[:, 56 + qq]
        dchi = F[:, 60 + qq]
        db_ok = (dblo > 1e-30) | (dbhi < -1e-30)
        ia = 1.0 / jnp.where(db_ok, dblo, 1.0)
        ib = 1.0 / jnp.where(db_ok, dbhi, 1.0)
        nlo0 = wb0 - obhi
        nhi0 = wb0 - oblo
        nlo1 = wb1 - obhi
        nhi1 = wb1 - oblo

        def hull4(na, nb, ia=ia, ib=ib):
            p0, p1 = na * ia, na * ib
            p2, p3 = nb * ia, nb * ib
            return (jnp.minimum(jnp.minimum(p0, p1),
                                jnp.minimum(p2, p3)),
                    jnp.maximum(jnp.maximum(p0, p1),
                                jnp.maximum(p2, p3)))

        e0_lo, e0_hi = hull4(nlo0, nhi0)
        e1_lo, e1_hi = hull4(nlo1, nhi1)
        tb_lo = jnp.minimum(e0_lo, e1_lo)
        tb_hi = jnp.maximum(e0_hi, e1_hi)
        tj_lo = jnp.where(db_ok, jnp.maximum(tlq, tb_lo), tlq)
        tj_hi = jnp.where(db_ok, jnp.minimum(thq, tb_hi), thq)
        okq = ((tlq <= thq) & (tj_lo <= tj_hi)
               & (j >= b0qv) & (j <= b1qv))
        x00 = tj_lo * dclo
        x01 = tj_lo * dchi
        x10 = tj_hi * dclo
        x11 = tj_hi * dchi
        vlo = oclo + jnp.minimum(jnp.minimum(x00, x01),
                                 jnp.minimum(x10, x11))
        vhi = ochi + jnp.maximum(jnp.maximum(x00, x01),
                                 jnp.maximum(x10, x11))
        c0q = jnp.clip(((vlo - lo_c_r) * icc).astype(jnp.int32), 0, ncl)
        c1q = jnp.clip(((vhi - lo_c_r) * icc).astype(jnp.int32), 0, ncl)
        c0 = jnp.minimum(c0, jnp.where(okq, c0q, 2 ** 20))
        c1 = jnp.maximum(c1, jnp.where(okq, c1q, -1))
        row_any = row_any | okq
        thr_t = jnp.minimum(thr_t, jnp.where(okq, tj_lo, _BIG))

    # rs span of the trimmed row (two gathers on the compact stream).
    safe0 = jnp.where(row_any, roff + jnp.minimum(c0, ncl), 0)
    safe1 = jnp.where(row_any, roff + jnp.maximum(c1, 0) + 1, 0)
    g1 = rs[safe0]
    g2 = rs[safe1]

    refs_u = _G * _U
    lo_g = g1 // refs_u
    hi_g = -(-g2 // refs_u)
    valid = valid_row & row_any & (g2 > g1)
    # Adjacent rows of one slice have ascending disjoint ref spans;
    # their unit round-outs can only share the single boundary unit,
    # clamped away pairwise (same argument as the dense planner's
    # running-max, restricted to distance 1 because spans of rows
    # r, r+2 can no longer touch after rounding out by < one unit).
    hi_m = jnp.where(valid, hi_g, 0)
    same_slot = jnp.concatenate(
        [jnp.zeros((1,), bool), src[1:] == src[:-1]])
    prev_hi = jnp.concatenate([jnp.zeros((1,), hi_m.dtype), hi_m[:-1]])
    lo_g = jnp.where(same_slot, jnp.maximum(lo_g, prev_hi), lo_g)
    cnt = jnp.where(valid, jnp.maximum(hi_g - lo_g, 0), 0)
    if any_hit:
        thr_row = jnp.full((rowcap,), _BIG_BITS - 1, jnp.int32)
    else:
        # Same threshold-safety suffix-min as the dense planner's
        # (see _plan): a clamped row's boundary unit rides under an
        # earlier row's emission, so thresholds must be non-increasing
        # toward earlier rows of one slot. Segmented (per-src) reverse
        # min-scan over the compact row stream.
        v = jnp.where(valid, _bits(thr_t), jnp.int32(_BIG_BITS))
        seg_last = jnp.concatenate(
            [src[:-1] != src[1:], jnp.ones((1,), bool)])

        def _segmin(a, b):
            fa, va = a
            fb, vb = b
            return fa | fb, jnp.where(fb, vb, jnp.minimum(va, vb))

        _, sfx = jax.lax.associative_scan(
            _segmin, (seg_last[::-1], v[::-1]))
        thr_row = sfx[::-1]

    # ---- block packing from the compact stream ----
    ex = jnp.cumsum(cnt) - cnt
    rows_t = nrows_d.sum(1)                              # (nt,)
    roff_t = jnp.cumsum(rows_t) - rows_t
    last_i = jnp.clip(roff_t + rows_t - 1, 0, rowcap - 1)
    first_i = jnp.clip(roff_t, 0, rowcap - 1)
    tile_units = jnp.where(rows_t > 0,
                           (ex + cnt)[last_i] - ex[first_i], 0)
    tile_pad = -(-tile_units // _UPB) * _UPB
    tile_base = jnp.cumsum(tile_pad) - tile_pad
    demand = tile_base[-1] + tile_pad[-1]                # units

    ii = jnp.arange(rowcap, dtype=jnp.int32)
    isb = (ii == 0) | (tile_i != jnp.concatenate(
        [tile_i[:1], tile_i[:-1]]))
    # ex is non-decreasing, so the running max of boundary ex values
    # is the CURRENT tile's first ex.
    first_ex = jax.lax.associative_scan(
        jnp.maximum, jnp.where(isb, ex, 0))
    roff = tile_base[tile_i] + (ex - first_ex)

    ucap = bcap * _UPB
    sr = lo_g - roff
    d_sr = jnp.diff(sr, prepend=0)
    d_thr = jnp.diff(thr_row, prepend=0)
    sr_ff = jnp.cumsum(jnp.zeros((ucap,), jnp.int32).at[roff].add(
        d_sr, mode="drop"))
    thr_ff = jnp.cumsum(jnp.zeros((ucap,), jnp.int32).at[roff].add(
        d_thr, mode="drop"))
    tminb = thr_ff.reshape(bcap, _UPB).min(axis=1)

    n_blocks = jnp.minimum(demand // _UPB, bcap)
    bmark = jnp.zeros((bcap,), jnp.int32).at[tile_base // _UPB].add(
        1, mode="drop")
    btile = jnp.clip(jnp.cumsum(bmark) - 1, 0, nt - 1)
    tile_of = jnp.where(jnp.arange(bcap) < n_blocks, btile, nt)
    own_end = (tile_base + tile_units)[jnp.minimum(btile, nt - 1)]
    slot = (jnp.arange(bcap, dtype=jnp.int32) * _UPB)[:, None] \
        + jnp.arange(_UPB, dtype=jnp.int32)[None, :]
    valid_u = slot < own_end[:, None]
    gidx = jnp.where(valid_u, slot + sr_ff.reshape(bcap, _UPB),
                     dead_idx)
    row_ovf = total_rows > rowcap
    return (gidx.reshape(-1), tile_of, tminb, n_blocks, demand,
            row_ovf, total_rows)


def _items(starts, counts, thr, nt, slab, bcap, dead_idx, rmax=_RMAX):
    """Pack the ranges' gather units into a dense per-round stream:
    gidx (bcap*_UPB,) unit indices to gather (dead_idx for padding),
    tile_of (bcap,) the owning tile per _UPB-unit block (nt for unused
    blocks), tminb (bcap,) the per-block early-out threshold (min of
    its units' slot thresholds, i32 f32-bits), n_blocks, and the
    unclamped unit demand (overflow detection). Each tile's segment is
    padded to a block (_UPB-unit) multiple so blocks never straddle
    tiles."""
    nr = slab * (rmax + 1)
    ucap = bcap * _UPB
    cnt2 = counts.reshape(nt, nr)
    tile_tot = cnt2.sum(1)
    tile_pad = -(-tile_tot // _UPB) * _UPB
    tile_base = jnp.cumsum(tile_pad) - tile_pad
    within = jnp.cumsum(cnt2, axis=1) - cnt2
    roff = (tile_base[:, None] + within).reshape(-1)
    demand = tile_base[-1] + tile_pad[-1]

    # Per-slot (start - roff) and threshold via scatter-delta + cumsum
    # forward fill: piecewise-constant per range, NO per-slot gathers.
    # Stacked deltas of empty ranges telescope to the last range's
    # value.
    sr = starts - roff
    d_sr = jnp.diff(sr, prepend=0)
    d_thr = jnp.diff(thr, prepend=0)
    sr_ff = jnp.cumsum(jnp.zeros((ucap,), jnp.int32).at[roff].add(
        d_sr, mode="drop"))
    thr_ff = jnp.cumsum(jnp.zeros((ucap,), jnp.int32).at[roff].add(
        d_thr, mode="drop"))
    # Conservative per-block threshold: min over the block's units
    # (slice entry t is usually monotone within a tile, but quarters
    # dropping in/out of the rect union can break that; min is always
    # safe). Pad units carry a stale neighbor threshold — also safe.
    tminb = thr_ff.reshape(bcap, _UPB).min(axis=1)

    n_blocks = jnp.minimum(demand // _UPB, bcap)
    bmark = jnp.zeros((bcap,), jnp.int32).at[tile_base // _UPB].add(
        1, mode="drop")
    btile = jnp.clip(jnp.cumsum(bmark) - 1, 0, nt - 1)
    tile_of = jnp.where(jnp.arange(bcap) < n_blocks, btile, nt)
    # Unit validity from the owner tile's segment end (cheap (bcap,)
    # gathers instead of a third ucap-wide forward-fill cumsum): pad
    # units within a block and whole blocks past the demand both fall
    # beyond their owner's end.
    own_end = (tile_base + tile_tot)[jnp.minimum(btile, nt - 1)]
    slot = (jnp.arange(bcap, dtype=jnp.int32) * _UPB)[:, None] \
        + jnp.arange(_UPB, dtype=jnp.int32)[None, :]
    valid = slot < own_end[:, None]
    gidx = jnp.where(valid, slot + sr_ff.reshape(bcap, _UPB), dead_idx)
    return gidx.reshape(-1), tile_of, tminb, n_blocks, demand


# ----------------------------------------------------------------------
# Whole-frame jit: all rounds, zero device->host reads
# ----------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "dims3", "slab", "any_hit", "tile", "bcaps", "impl", "interpret",
    "rmax", "compact", "rowcaps"))
def _frame(xp_ext, bbox_lo, bbox_hi, rs, rowinfo, cols, planes,
           dims3, slab, any_hit, tile, bcaps, impl="xla", interpret=False,
           rmax=_RMAX, compact=False, rowcaps=None):
    nt = xp_ext.shape[0] // tile - 1
    cs_tab, n_tab, lo_tab = _tile_tabs(bbox_lo, bbox_hi, dims3)
    per_ray, per_tile = _precompute(xp_ext[:nt * tile], cs_tab, n_tab,
                                    lo_tab, bbox_lo, bbox_hi, tile,
                                    planes)
    # Untraceable lanes (padding, and tmax<=0 "masked dead" secondary
    # rays) get best = -BIG so the Triton kernel's all-lanes-done
    # early-out can still fire for their tiles; they never hit.
    traceable = xp_ext[:nt * tile, 13].reshape(nt, tile) > 0
    best = (jnp.where(traceable, _BIG, -_BIG),
            jnp.full((nt, tile), -1, jnp.int32),
            jnp.zeros((nt, tile), jnp.float32),
            jnp.zeros((nt, tile), jnp.float32))
    ka = per_tile["k0"]
    step = per_tile["step"]
    # Gather units: _U consecutive group rows of `cols` (a reshape, group
    # rows ARE the stored form). The zero tail group rows form exactly
    # the last unit, the dead gather target.
    cols_u = cols.reshape(-1, _U, _GW)
    dead_idx = cols_u.shape[0] - 1
    xt_ext = xp_ext.T if impl == "triton" else None
    overflow = jnp.int32(0)
    demand_max = jnp.int32(0)              # peak per-round block demand
    rows_max = jnp.int32(0)                # peak per-round live rows
    # bcaps: per-round static block budgets (round demands decay fast
    # once rays terminate, and planning costs O(bcap) whether blocks
    # are live or not).
    for ri, bcap in enumerate(bcaps):
        if compact:
            rowcap = rowcaps[ri]
            gidx, tile_of, tminb, n_blocks, demand, row_ovf, nrow = \
                _plan_items2(per_ray, per_tile, cs_tab, n_tab, lo_tab,
                             rs, rowinfo, ka, best[0], dims3, slab,
                             any_hit, rowcap, bcap, dead_idx)
            overflow = overflow | row_ovf
            rows_max = jnp.maximum(rows_max, nrow)
        else:
            starts, counts, thr = _plan(
                per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo,
                ka, best[0], dims3, slab, any_hit, rmax=rmax)
            gidx, tile_of, tminb, n_blocks, demand = _items(
                starts, counts, thr, nt, slab, bcap, dead_idx,
                rmax=rmax)
        overflow = overflow | (demand > bcap * _UPB)
        demand_max = jnp.maximum(demand_max, demand // _UPB)
        if impl == "triton":
            best = _sweep_triton(best, xt_ext, cols, gidx, tile_of, tminb,
                                 tile, any_hit, interpret)
        else:
            best = _sweep_xla(best, xp_ext, cols_u, gidx, tile_of,
                              n_blocks, tile)
        ka = ka + step * slab
    return best, overflow, jnp.stack([demand_max, rows_max])


# ----------------------------------------------------------------------
# Public entry
# ----------------------------------------------------------------------

def trace_sweep(grid: PacketGrid, rays: Rays, any_hit: bool = False,
                impl: str | None = None, interpret: bool = False,
                tile: int | None = None, slab: int | None = None,
                bmax: int | None = None, return_overflow: bool = False,
                coherent: bool = False, return_demand: bool = False,
                fine_bins: bool | None = None, rmax: int | None = None,
                compact: bool | None = None, rowmax: int | None = None):
    """Trace rays against a PacketGrid with the planned sweep.

    impl picks the intersection stage: "triton" (the Pallas kernel) or
    "xla" (plain jnp); None takes default_impl(). interpret=True runs
    the Triton kernel in the Pallas interpreter (CPU tests); it is never
    chosen implicitly.

    The frame runs as one jitted computation with no host syncs. If a
    round demands more than `bmax` 768-ref blocks, the surplus is
    dropped and the device-side overflow flag is set (request it with
    return_overflow=True, or raise bmax). coherent=True skips the
    (axis, sign) binning permutation for waves that are already
    direction-coherent in order (camera primaries). slab=None plans the
    WHOLE grid in one round: the kernel's per-block early-out replaces
    inter-round replanning; pass a smaller slab to re-plan with
    tightened t-caps between slabs."""
    if impl is None:
        impl = "triton" if interpret else default_impl()
    if impl not in ("triton", "xla"):
        raise ValueError(f"impl must be 'triton' or 'xla', got {impl!r}")
    if interpret and impl != "triton":
        raise ValueError("interpret=True applies to impl='triton' only")
    da_max = max(d[0] for d in grid.dims3)
    if compact is None:
        # Incoherent waves have TALL rects (origins at every depth):
        # with the dense planner, rows past the trimmed slots fall
        # into an untrimmed multi-row tail that carries most of their
        # demand (Sponza AO wave: 173.6k -> 62.6k blocks at rmax=16),
        # but dense slot costs scale with rmax. The compact planner
        # trims EVERY row at cost proportional to live rows.
        compact = not coherent
    if tile is None:
        # Compact incoherent waves: on the Sponza AO wave (origin-major
        # sorted, slab=8) tile 512 plans 16.1G pair-slots, 256 11.7G,
        # 128 8.6G at twice the block and row bookkeeping.
        tile = 256 if compact else 512
    if slab is None:
        # Compact waves re-plan between slabs with tightened t-caps
        # (any-hit rays terminate fast; per-round budgets then shrink
        # by the ladder below). Coherent closest-hit waves plan the
        # whole grid once and rely on the per-block early-out.
        slab = 8 if compact else da_max
    if fine_bins is None:
        # Off by default: on a Sponza AO wave the 24-group minor-sign
        # split RAISED block demand 173k -> 284k (and 103.7k -> 126.8k
        # on origin-sorted rays): the finer groups scatter each tile's
        # origins across the image. Kept for waves with no origin
        # locality at all.
        fine_bins = False
    n = rays.count
    ngroups = (_NGROUPS_FINE if fine_bins else _NGROUPS) - 1
    n_pad = (-(-n // tile) + (0 if coherent else ngroups + 1)) * tile
    nt = n_pad // tile
    max_rounds = -(-da_max // slab)
    if bmax is None:
        # Incoherent (any-hit) waves have far wider frusta per tile;
        # budget slack only costs planning work, so scale up.
        scale = 12 if any_hit else 6
        bmax = min(24576 if any_hit else 12288, max(128, scale * nt))
    if coherent:
        xp_ext = _pad_coherent(rays.org, rays.dir, rays.tmin, rays.tmax,
                               n_pad, tile)
        inv = None
    else:
        xp_ext, inv = _bin_rays(rays.org, rays.dir, rays.tmin, rays.tmax,
                                n_pad, tile, fine=fine_bins)

    # Per-round budget ladder: round demands decay fast once rays start
    # terminating (Sponza primaries: 4493/2213/0 blocks), and planning
    # costs O(budget) regardless of live blocks. Later rounds run on a
    # fraction of bmax; the overflow flag still reports any round whose
    # demand exceeded its cap.
    def _cap(r):
        if r == 0:
            f = 1.0
        elif any_hit:
            f = 0.75 if r == 1 else 0.5
        else:
            f = 0.625 if r == 1 else 0.375
        return max(128, int(bmax * f) // 128 * 128)

    bcaps = tuple(_cap(r) for r in range(max_rounds))
    if rmax is None:
        rmax = _RMAX
    if rowmax is None:
        # Live trimmed rows per round (compact planner). Rows can
        # outnumber units (rows that trim to empty still occupy
        # expansion slots), so the default is a full unit budget's
        # worth; calibrate with return_demand (which reports the true
        # peak row count) to shrink it.
        rowmax = bcaps[0] * _UPB
    rowcaps = tuple(
        max(4096, (-(-rowmax * b // bcaps[0]) // 8) * 8 + 8)
        for b in bcaps) if compact else None
    best, overflow, demand = _frame(
        xp_ext, grid.bbox_lo, grid.bbox_hi, grid.rs, grid.rowinfo,
        grid.cols, grid.planes, grid.dims3, slab, any_hit, tile, bcaps,
        impl=impl, interpret=interpret, rmax=rmax, compact=compact,
        rowcaps=rowcaps)

    # Ids stay int32 all the way out: a float bitcast round-trip here
    # can silently canonicalize the NaN-pattern id bits (-1 came back
    # as 0x7FC00000).
    t_f = best[0].reshape(-1)
    id_i = best[1].reshape(-1)
    u_f = best[2].reshape(-1)
    v_f = best[3].reshape(-1)
    if inv is None:
        tri = id_i[:n]
        found = tri >= 0
        hits = Hits(tri_id=tri, t=jnp.where(found, t_f[:n], jnp.inf),
                    u=u_f[:n], v=v_f[:n])
    else:
        hits = _unbin(t_f, id_i, u_f, v_f, inv, n)
    out = (hits,)
    if return_overflow:
        out = out + (overflow,)
    if return_demand:
        # i32[2]: [peak round block demand, peak round live rows]
        # (rows only meaningful on the compact path; 0 otherwise).
        out = out + (demand,)
    return out if len(out) > 1 else hits


@functools.partial(jax.jit, static_argnames=("n",))
def _unbin(t_f, id_i, u_f, v_f, inv, n):
    safe = jnp.where(inv >= 0, inv, n)
    t = jnp.full((n + 1,), jnp.inf, jnp.float32).at[safe].set(t_f)
    idb = jnp.full((n + 1,), -1, jnp.int32).at[safe].set(id_i)
    u = jnp.zeros((n + 1,), jnp.float32).at[safe].set(u_f)
    v = jnp.zeros((n + 1,), jnp.float32).at[safe].set(v_f)
    tri = idb[:n]
    found = tri >= 0
    return Hits(tri_id=tri, t=jnp.where(found, t[:n], jnp.inf),
                u=u[:n], v=v[:n])
