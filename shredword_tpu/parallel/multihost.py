"""Multi-host training setup — the jax.distributed layer.

The reference has no distributed code of any kind (SURVEY.md §2.D).
This module replaces the absent NCCL/MPI layer: process-group
initialization via ``jax.distributed`` plus a global mesh over every
device of every process.  Per-merge reductions ride the same
collectives as the single-host sharded paths (all_gather / psum over
the `data` axis), which XLA hands to NCCL on GPUs; integer counts keep
them bit-deterministic.

Typical multi-host launch (one process per host):

    from shredword_tpu.parallel import multihost, sharded_hist_train
    multihost.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = multihost.global_mesh()
    merges, freqs = sharded_hist_train(..., mesh=mesh)
"""

from __future__ import annotations

import numpy as np

from ..utils import logging as log

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the process group.

    Pass all three arguments on GPU/CPU hosts (a cluster manager that
    jax.distributed autodetects may supply them instead).  Idempotent.
    """
    global _initialized
    if _initialized:
        return
    import jax
    if num_processes is not None and num_processes <= 1:
        _initialized = True
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _initialized = True
    log.info("distributed: process %d/%d, %d local + %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())


def global_mesh(axis: str = "data"):
    """1-D mesh over every device in the slice (all hosts)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def host_shard(n_items: int) -> slice:
    """This host's contiguous slice of an n_items-long work list
    (corpus files, shards) — equal split by process index."""
    import jax
    p, n = jax.process_index(), jax.process_count()
    per = -(-n_items // n)
    return slice(p * per, min((p + 1) * per, n_items))
