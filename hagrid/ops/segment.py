"""Device-wide parallel primitives: scan, sort-pairs, expand, segments.

This is the framework's counterpart of the reference's CUB/Thrust wrapper
layer (reference src/parallel.cu: exclusive scan, reduce, partition, sort).
There is no device-wide dynamic allocation under jit, so every
"count → scan → scatter" CUDA pattern is recast as
"count → scan → *gather-expand* → sort → segment boundaries" over
static-shape arrays. These primitives are the backbone of grid construction
(SURVEY.md §7: sort-based construction, not scatter-atomics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum along axis 0, same length as x."""
    c = jnp.cumsum(x, axis=0)
    return c - x


def expand_by_counts(counts: jnp.ndarray, capacity: int):
    """Run-length expansion without scatter-ATOMICS and without binary
    search.

    Given per-source counts i32[N], produce for each output slot
    j in [0, capacity):
      src[j]   — source index whose run j falls into
      rank[j]  — offset of j within its run (0-based)
      valid[j] — j < sum(counts)

    src is recovered by scattering a +1 marker at every run start and
    prefix-summing — O(capacity) streaming work, where a vectorized
    binary search costs log2(N) dependent gather rounds. Empty runs stack
    markers on one
    slot and the cumsum jumps past them, which is exactly right. Slots
    past the total get clamped src and valid=False.
    """
    counts = counts.astype(jnp.int32)
    if counts.shape[0] == 0:  # degenerate empty source (empty scenes)
        j = jnp.arange(capacity, dtype=jnp.int32)
        return (jnp.zeros((capacity,), jnp.int32), j,
                jnp.zeros((capacity,), bool), jnp.int32(0))
    offsets = exclusive_scan(counts)
    total = offsets[-1] + counts[-1]
    markers = jnp.zeros((capacity,), jnp.int32)
    # Runs with count 0 contribute a marker too (their start coincides
    # with the next run's); starts at/after capacity are dropped.
    markers = markers.at[offsets].add(1, mode="drop")
    src = jnp.cumsum(markers) - 1
    src = jnp.clip(src, 0, max(counts.shape[0] - 1, 0))
    j = jnp.arange(capacity, dtype=jnp.int32)
    # offsets[src] without the per-slot gather (row gathers read whole
    # (8,128) tiles — ~64x amplification for i32): delta-scatter +
    # cumsum forward fill, exact for ints; stacked deltas of empty runs
    # telescope to the last run's offset.
    d_off = jnp.diff(offsets, prepend=0)
    off_ff = jnp.cumsum(jnp.zeros((capacity,), jnp.int32).at[offsets].add(
        d_off, mode="drop"))
    rank = j - off_ff
    valid = j < total
    return src, rank, valid, total


def sort_pairs(keys: jnp.ndarray, *values: jnp.ndarray):
    """Stable ascending sort of keys, carrying values. Returns (keys, *values)."""
    out = jax.lax.sort((keys,) + tuple(values), num_keys=1, is_stable=True)
    return out


def segment_starts(sorted_keys: jnp.ndarray, num_segments: int) -> jnp.ndarray:
    """Given ascending keys i32[R] (invalid entries = key >= num_segments
    sorted to the back), return starts i32[num_segments + 1]: segment k
    occupies sorted rows [starts[k], starts[k+1]).

    Histogram + prefix sum (O(R + S) streaming) instead of binary search
    (log serial gather rounds — see expand_by_counts).
    """
    counts = jnp.zeros((num_segments + 1,), jnp.int32)
    k = jnp.clip(sorted_keys.astype(jnp.int32), 0, num_segments)
    counts = counts.at[k + 1].add(
        (sorted_keys < num_segments).astype(jnp.int32), mode="drop")
    return jnp.cumsum(counts).astype(jnp.int32)


def rows_to_segments(starts: jnp.ndarray, num_rows: int) -> jnp.ndarray:
    """Inverse of segment_starts: owner segment id per row j in
    [0, num_rows). starts i32[S+1]. Rows beyond starts[S] get S-1 clamped.
    """
    s = starts.shape[0] - 1
    markers = jnp.zeros((num_rows,), jnp.int32)
    markers = markers.at[starts[:s]].add(1, mode="drop")
    return jnp.clip(jnp.cumsum(markers) - 1, 0, s - 1)


def compact_indices(mask: jnp.ndarray):
    """Stable compaction: indices of True entries packed to the front.

    Returns (idx i32[N], count). Rows past count hold the False indices (in
    order), so gathers with idx are always in-bounds.
    """
    n = mask.shape[0]
    key = jnp.where(mask, jnp.int32(0), jnp.int32(1))
    idx = jnp.arange(n, dtype=jnp.int32)
    _, packed = sort_pairs(key, idx)
    return packed, jnp.sum(mask.astype(jnp.int32))


def segmented_unique(sorted_seg: jnp.ndarray, sorted_val: jnp.ndarray,
                     invalid_val: jnp.ndarray | int):
    """Deduplicate (segment, value) pairs that are sorted by (segment, value).

    Duplicates (same segment AND same value as the previous row) are replaced
    with ``invalid_val`` and a recomputed per-row validity mask is returned.
    Used after ref-list unions in grid merging. Returns (values, keep_mask).
    """
    prev_seg = jnp.roll(sorted_seg, 1)
    prev_val = jnp.roll(sorted_val, 1)
    first = jnp.arange(sorted_seg.shape[0]) == 0
    keep = first | (sorted_seg != prev_seg) | (sorted_val != prev_val)
    return jnp.where(keep, sorted_val, invalid_val), keep
