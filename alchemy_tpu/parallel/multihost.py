"""Multi-host initialization (SURVEY.md §2.4 communication backend).

No custom transport: XLA's collective runtime is the backend. Within a slice
collectives ride ICI; across hosts, standard `jax.distributed` over DCN.
The mesh helpers in parallel/mesh.py operate on the global device list, so
the same shard_map programs run unchanged on a multi-host pod.
"""

from __future__ import annotations

import jax


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   cpu_collectives: str | None = None) -> int:
    """Initialize jax.distributed (no-op when single-process). Returns the
    global device count.

    On GPUs the collective transport is XLA's own (NCCL); on the CPU
    backend cross-process collectives need an explicit implementation
    (`cpu_collectives="gloo"` — how tests/test_multihost.py runs the same
    shard_map programs across two OS processes)."""
    if num_processes is not None and num_processes > 1:
        if cpu_collectives is not None:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


def local_batch_slice(global_batch: int) -> slice:
    """The batch rows this process owns under pure data-parallel input
    feeding (jax.process_index-based contiguous slicing)."""
    n = jax.process_count()
    i = jax.process_index()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
