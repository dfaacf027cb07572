"""Start a host's ranks of a ``torch.distributed`` job, one process each.

``spawn(fn, args, devices=...)`` runs ``fn(device, *args)`` in one
process per entry of ``devices`` (``torch.multiprocessing``, start method ``spawn``),
each joined to the job first (``multihost.initialize_distributed``) with
its device current, and returns what each rank's ``fn`` returned, in
local rank order.  The train and eval CLIs, the tests and
``chip_smoke.py`` start their ranks through it.

  * Any rank's failure (an exception, a non-zero exit) stops the others and
    raises here, so the job fails; a job that outlives ``timeout`` is
    stopped and raises ``TimeoutError``.  Every wait has a timeout.
  * On a card, the fused kernels are built here, before any rank starts
    (``ops/_build.py``): ranks never race on the build directory.
  * ``cli_devices`` is the CLIs' device plan: ``world / num_hosts`` local
    ranks, each on a card of its own (``make_mesh``'s error where the host
    has too few), or all on the CPU when the CLI runs there.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from .mesh import backend_for, make_mesh, visible_devices


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cli_devices(num_data: int, num_model: int, num_hosts: int,
                device: torch.device) -> List[torch.device]:
    """The devices of this host's ranks for a CLI job of ``num_data x
    num_model`` ranks over ``num_hosts`` hosts: cards ``cuda:0..`` (each
    host is taken to have as many as this one; too few raise
    ``make_mesh``'s error), or the CPU for every rank."""
    world = num_data * num_model
    if world % num_hosts:
        raise ValueError(f"--num_gpus x --model_parallel = {world} ranks do "
                         f"not divide over --num_hosts {num_hosts}")
    local = world // num_hosts
    if device.type == "cpu":
        return [torch.device("cpu")] * local
    make_mesh(num_data, num_model, devices=visible_devices() * num_hosts)
    return visible_devices()[:local]


def _rank_main(fn, args, local_rank, local_count, host_index, num_hosts,
               coordinator, backend, device, threads, results):
    from . import multihost
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    multihost.initialize_distributed(
        coordinator, num_hosts, host_index, local_rank=local_rank,
        local_count=local_count, backend=backend,
        device=torch.device(device))
    try:
        value = fn(torch.device(device), *args)
    except BaseException:
        text = traceback.format_exc()
        print(text, file=sys.stderr, flush=True)
        results.put((local_rank, pickle.dumps(_Failure(text))))
        results.close()
        results.join_thread()
        sys.exit(1)
    finally:
        dist.destroy_process_group()
    # plain pickle: the queue's own pickler would hand tensors over as
    # shared memory that dies with this process
    results.put((local_rank, pickle.dumps(value)))


class _Failure:
    """A rank's traceback, sent to the launcher in place of a result."""

    def __init__(self, text: str):
        self.text = text


def spawn(fn: Callable, args: Sequence[Any] = (), *,
          devices: Sequence[Any], num_hosts: int = 1, host_index: int = 0,
          coordinator: Optional[str] = None,
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(device, *args)`` in one process per device of ``devices`` (this
    host's ranks, global ranks ``host_index * len(devices) + i``) and
    return their results in local rank order.  ``fn`` must be picklable
    by name (a module-level function).  ``coordinator`` is host:port of
    global rank 0; a one-host job without one meets at a file in a
    temporary directory.  The backend is ``backend_for(devices)``.  CPU ranks share this
    process's threads."""
    from ..ops import _build
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    local = len(devices)
    store_dir = None
    if coordinator is None:
        if num_hosts > 1:
            raise ValueError("a multi-host job needs the coordinator's "
                             "address")
        # one host: the ranks meet at a file, which no other job can take
        # the way it can take a free port
        store_dir = tempfile.mkdtemp(prefix="nerf_fl_torch_job_")
        coordinator = f"file://{os.path.join(store_dir, 'store')}"
    if any(d.type == "cuda" for d in devices):
        _build.build(["fused_mlp_fwd", "fused_mlp_bwd"])
    threads = 0
    if all(d.type == "cpu" for d in devices):
        threads = max(1, torch.get_num_threads() // local)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(fn, tuple(args), i, local, host_index, num_hosts, coordinator,
              backend_for(devices), str(d), threads, results))
        for i, d in enumerate(devices)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = None if timeout is None else time.monotonic() + timeout

    def take(wait):
        """Read one result (False when none came within ``wait`` s); a
        rank's failure raises with its traceback."""
        try:
            i, value = results.get(timeout=wait)
        except queue.Empty:
            return False
        value = pickle.loads(value)
        if isinstance(value, _Failure):
            raise RuntimeError(f"local rank {i} (global "
                               f"{host_index * local + i}) failed:\n"
                               f"{value.text}")
        out[i] = value
        return True

    try:
        while len(out) < local:
            if take(0.1):              # drain before any join
                continue
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes) or all(
                    c == 0 for c in codes):
                # a rank died, or all exited: what they sent is in flight
                while len(out) < local and take(5.0):
                    pass
                if len(out) < local:
                    raise RuntimeError("rank(s) failed: " + ", ".join(
                        f"local rank {i} (global {host_index * local + i}) "
                        f"exit code {c}" for i, c in enumerate(codes)
                        if i not in out))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the job of {local} rank(s) ran past "
                                   f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        results.close()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[i] for i in range(local)]


def spawn_cli(fn: Callable, hparams, device: torch.device,
              num_data: int, num_model: int = 1, *, num_hosts: int = 1,
              host_index: int = 0, coordinator: Optional[str] = None,
              timeout: Optional[float] = None) -> List[Any]:
    """A CLI's job: this host's ranks (``cli_devices``), each calling
    ``fn(its device, hparams)``.  A multi-host job meets at
    ``coordinator``."""
    devices = cli_devices(num_data, num_model, num_hosts, device)
    return spawn(fn, (hparams,), devices=devices, num_hosts=num_hosts,
                 host_index=host_index,
                 coordinator=coordinator if num_hosts > 1 else None,
                 timeout=timeout)
