"""Build parameters, mirroring the reference CLI knobs (src/main.cpp).

top_density (λ1 ≈ 0.12) and snd_density (λ2 ≈ 2.4) drive the grid-dimension
density heuristic of the irregular-grids paper; alpha weights the SAH merge
test; expansion_passes bounds greedy cell expansion. All static Python
values: they determine array capacities and therefore compilation shapes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuildParams:
    top_density: float = 0.12
    snd_density: float = 2.4
    alpha: float = 0.995
    expansion_passes: int = 3
    merge_passes: int = 1
    # Cheap empty-buddy coalescing passes (no ref-array work) before SAH.
    buddy_passes: int = 3
    # Max air-octree coalescing depth over TOP cells (aligned 2^k cubes).
    air_levels: int = 5
    # Max second-level resolution per top cell (power of two), i.e. the
    # reference grid's `shift`: fine grid = top dims << levels. Cells
    # whose density demands more AND whose projected ref growth stays
    # within ref_growth get one extra level (irregular._stage_top).
    levels: int = 3
    # Per-cell refinement budget: a cell may refine only while its
    # projected refs stay <= ref_growth * its tri count. Large-triangle
    # cells (foliage) auto-coarsen instead of exploding refs.
    ref_growth: float = 4.0
    # Compact dead (merged-away) cell rows after optimization.
    compact: bool = True
    # Grow cell bboxes into non-empty neighbors whose ref list is a
    # subset of the cell's own (reference src/expand.cu full test);
    # empty-neighbor growth always runs.
    subset_expansion: bool = True
    # Capacity head-room multipliers for the static ref buffers.
    ref_slack: float = 1.5

    @staticmethod
    def dynamic() -> "BuildParams":
        """Preset for per-frame rebuilds: levels=2 shrinks the entry
        tables 8x, trading trace speed for rebuild speed."""
        return BuildParams(levels=2)


def density_dims(extent, n_prims: int, density: float):
    """The paper's grid-dimension heuristic: dims_a = e_a * cbrt(d*N/V).

    extent: 3-sequence of floats. Returns a tuple of 3 ints >= 1. Host-side
    (static) computation: array capacities derive from it.
    """
    ex, ey, ez = (max(float(e), 1e-9) for e in extent)
    vol = ex * ey * ez
    k = (density * max(n_prims, 1) / vol) ** (1.0 / 3.0)
    return (max(1, int(ex * k)), max(1, int(ey * k)), max(1, int(ez * k)))
