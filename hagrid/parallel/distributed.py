"""Multi-host initialization (SURVEY.md §5: distributed backend).

The reference has no distributed layer (single GPU); this one is
deliberately thin: `jax.distributed.initialize` wires the processes, the
scene broadcasts once per frame (it is identical in every process), and
all cross-card traffic is the ray sharding of parallel/mesh.py. There is
no NCCL/MPI code to port: XLA's collectives are the backend.

On a single-process run every function here is a no-op / passthrough, so
the same program runs unchanged from a laptop CPU to several hosts.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wire up multi-host JAX. No-op when single-process (the common case
    in tests and single-chip benches). Arguments mirror
    jax.distributed.initialize, which needs coordinator_address,
    num_processes and process_id where no cluster environment provides
    them."""
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError:
        # Already initialized (idempotent callers) — fine.
        pass


def process_count() -> int:
    return jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0


def global_mesh(axis: str = "rays"):
    """Mesh over ALL devices in the job (all hosts); rays shard over it.

    With multiple hosts each process feeds its local shard of the ray
    batch (jax.make_array_from_process_local_data) and reads back only its
    local hits — the image assembles on the coordinator."""
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))
