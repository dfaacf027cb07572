"""The port's own tracing: host spans and device stage marks.

``span(name)`` times a piece of host code.  It opens a
``torch.profiler.record_function`` range, which lands in a running
profiler's Chrome trace as a ``user_annotation`` event on the device
records' clock (so a trace names the card's idle gaps by the program's
spans), and adds the span's count and host seconds (``perf_counter``) to
``STORE``, which the CLIs' summary lines read.  The program's spans are
named ``nerf.*``; see PERF.md's layer table for each one.

``mark(stage, device)`` starts a stage on the device: it launches
``nerf_mark_<stage>`` (``csrc/stage_marks.cu``), an empty kernel, on the
device's current stream.  A kernel belongs to the stage of the last mark
before it on its stream.  Under a CUDA graph capture the mark becomes a
node of the graph and runs at every replay, where a ``record_function``
range is not replayed; in a profiler's trace it is an ordinary kernel
record that names its stage.  A mark touches no tensor.  On the CPU, and
on a card that the port's kernels are not built for (they target sm_90a),
it does nothing.  ``PoseMark`` marks ``pose_backward`` when the posed rays'
gradient is complete, and returns its input and its gradient as they are.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import time
from typing import Dict, Optional, Tuple

import torch

# in csrc/stage_marks.cu's order
STAGES = ("load", "pose", "sample", "coarse_mlp", "coarse_composite", "pdf",
          "fine_mlp", "fine_composite", "loss", "backward", "pose_backward",
          "optimizer", "row", "upload", "end", "cast")
_INDEX = {s: i for i, s in enumerate(STAGES)}


class Store:
    """Count and host seconds of each span name, summed over the process;
    safe to add to from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, list] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._totals.setdefault(name, [0, 0.0])
            t[0] += 1
            t[1] += seconds

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """{name: (count, seconds)}, a copy."""
        with self._lock:
            return {n: (c, s) for n, (c, s) in self._totals.items()}

    def summary(self) -> str:
        """'name count x seconds s; ...' in order of name."""
        return "; ".join(f"{n} {c} x {s:.3f} s"
                         for n, (c, s) in sorted(self.totals().items()))


STORE = Store()


class span:
    """``with span(name) as s:`` times the block into ``STORE`` and a
    profiler's trace; afterwards ``s.start`` / ``s.end`` are its
    ``perf_counter`` readings and ``s.seconds`` their difference."""

    __slots__ = ("name", "start", "end", "_range")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = None

    def __enter__(self) -> "span":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        self._range.__exit__(*exc)
        STORE.add(self.name, self.end - self.start)

    @property
    def seconds(self) -> float:
        return self.end - self.start


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    """The marks' library, or None (with one line said) where it cannot be
    built or loaded."""
    from ..ops import _build
    try:
        lib = _build.load("stage_marks")
    except (RuntimeError, OSError) as e:
        print(f"[marks] device stage marks unavailable ({e}); the trace has "
              f"no nerf_mark_* records", flush=True)
        return None
    lib.nerf_marks_names.argtypes = []
    lib.nerf_marks_names.restype = ctypes.c_char_p
    lib.nerf_marks_init.argtypes = []
    lib.nerf_marks_init.restype = ctypes.c_int
    lib.nerf_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.nerf_mark.restype = ctypes.c_int
    names = tuple(lib.nerf_marks_names().decode().rstrip(",").split(","))
    if names != STAGES:
        raise RuntimeError(f"csrc/stage_marks.cu's stages {names} are not "
                           f"spans.STAGES {STAGES}")
    err = lib.nerf_marks_init()
    if err != 0:
        raise RuntimeError(f"loading the stage marks failed: CUDA error "
                           f"{err}")
    return lib


@functools.lru_cache(maxsize=None)
def _marks_on(dev: torch.device) -> bool:
    # sm_90a code runs on compute capability 9.0 alone
    return torch.cuda.get_device_capability(dev) == (9, 0) \
        and _lib() is not None


def mark(stage: str, device: torch.device) -> None:
    """Start ``stage`` on ``device``'s current stream (see the module's
    docstring); nothing on the CPU."""
    i = _INDEX.get(stage)
    if i is None:
        raise ValueError(f"no stage {stage!r}; the stages are {STAGES}")
    if device.type != "cuda":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not _marks_on(device):
        return
    err = _lib().nerf_mark(i, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the {stage} mark's launch failed: CUDA error "
                           f"{err}")


class PoseMark(torch.autograd.Function):
    """The identity on the posed rays; its backward marks ``pose_backward``
    when their gradient is complete, so the pose path's backward is a stage
    of its own."""

    @staticmethod
    def forward(ctx, rays):
        return rays

    @staticmethod
    def backward(ctx, grad):
        mark("pose_backward", grad.device)
        return grad
