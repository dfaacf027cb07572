"""Multi-host (multi-process) jobs over ``torch.distributed``.

Counterpart of ``nerf_fl_tpu/parallel/multihost.py``.  The port runs one
process a device on every host (``parallel.launch`` starts a host's
``world / num_hosts`` local ranks), so a multi-host job is the one-host
job with more processes: ``initialize_distributed`` joins this process to
the job over TCP at the coordinator's address, global rank ``host_index
x local + local_rank``, ranks process-contiguous as ``make_mesh`` lays
them out.

Host-side contract, as the JAX package's: every process loads the dataset
and draws the same global batch permutation (seeded identically), then
keeps only its rows of each batch (``data.sampler.RayBatcher(host_index=
data index, host_count=data size)``).  The JAX package's ``global_batch``
assembles a global array from those per-process slices; it has no
counterpart here, because a rank's tensors already are its slice and the
train step reduces the gradients itself (``training/system.py``).  Only
global rank 0 writes checkpoints and logs; a render all-gathers its pixel
outputs so that every rank can assemble the frame.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# how long a rank waits for the others at start-up and in a collective
TIMEOUT_S = 1800


def initialize_distributed(coordinator_address: str, num_hosts: int,
                           host_index: int, *, local_rank: int = 0,
                           local_count: int = 1, backend: str = "gloo",
                           device: Optional[torch.device] = None,
                           timeout_s: float = TIMEOUT_S) -> int:
    """Join this process to the job (``init_process_group`` over
    ``tcp://<coordinator_address>``, where global rank 0 serves the
    rendezvous, or at a ``file://`` URL given as the address) as global
    rank ``host_index * local_count + local_rank`` of ``num_hosts *
    local_count``; returns the rank."""
    rank = host_index * local_count + local_rank
    world = num_hosts * local_count
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    os.environ["LOCAL_WORLD_SIZE"] = str(local_count)
    os.environ["LOCAL_RANK"] = str(local_rank)
    dist.init_process_group(
        backend, init_method=coordinator_address
        if "://" in coordinator_address else f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def is_multihost() -> bool:
    """Whether this job spans more than one host's processes."""
    if not dist.is_initialized():
        return False
    world = dist.get_world_size()
    return world > int(os.environ.get("LOCAL_WORLD_SIZE", world))


def job_devices(own: torch.device) -> List[torch.device]:
    """Every rank's device, in global rank order (each rank gives its own;
    a collective over the job)."""
    if not dist.is_initialized():
        return [torch.device(own)]
    out: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(torch.device(own)))
    return [torch.device(d) for d in out]
