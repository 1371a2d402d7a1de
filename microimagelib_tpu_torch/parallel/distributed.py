"""Multi-process timepoint split — the port of the JAX package's
``parallel/distributed.py``.

One launch script drives either package: ``init_distributed`` reads the
same variables as the JAX package (JAX_COORDINATOR_ADDRESS = host:port of
rank 0, JAX_NUM_PROCESSES, JAX_PROCESS_ID) and joins a
``torch.distributed`` gloo group. The group exchanges no tensors: each
process runs its own ``spim_fusion_batch`` over its share of the
timepoints (``shard_timepoints``), and the outputs land in the shared
tree keyed by timepoint, so two processes may share one card. A device
mesh (``parallel/mesh.py``) stays inside one process."""

from __future__ import annotations

import datetime
import os

# a missing peer makes the rendezvous fail after this long instead of hanging
INIT_TIMEOUT_S = 300


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     timeout_s=INIT_TIMEOUT_S):
    """Join the gloo process group of ``coordinator_address`` (host:port)
    as rank ``process_id`` of ``num_processes``, from the arguments or the
    JAX_* variables. Does nothing and returns False when no address is
    configured (a single-process run); returns True once joined."""
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False  # single-process run
    if num_processes is None:
        num_processes = os.environ.get("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the process count and this process's "
                         "id (JAX_NUM_PROCESSES, JAX_PROCESS_ID)")
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index():
    """This process's rank (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of processes (1 outside a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def shard_timepoints(timepoints, process_id=None, num_processes=None):
    """Static round-robin split of a timepoint list across processes: the
    multi-host data parallelism of the batch driver."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return [t for i, t in enumerate(timepoints) if i % n == pid]
