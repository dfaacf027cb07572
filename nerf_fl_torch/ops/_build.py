"""Build the CUDA sources under ``nerf_fl_torch/csrc/`` with nvcc at first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
``nerf_fl_torch/_build/<name>-<hash>.so``, loaded with ctypes.  The hash
covers the source, the shared headers under ``csrc/`` and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
# no --use_fast_math: it would contract the Cody-Waite reduction into FMAs
# and swap in __sinf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nerf_fl_torch: nvcc not found; the CUDA kernels are "
                       "built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``, keyed by the source, every
    header under ``csrc/`` (the sources share them) and the flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(
            p for p in CSRC.iterdir() if p.suffix in (".cuh", ".h")):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (process or None, target, log path)."""
    target = _target(name)
    log = target.with_suffix(".log")
    if target.exists():
        return None, target, log
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return (proc, tmp), target, log


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources in parallel (one nvcc each).  Waits for
    every job, then raises with each failed source's name and nvcc output.
    Returns name -> library path."""
    started = {n: _start(n) for n in names}
    out, failed = {}, []
    for name, (job, target, log) in started.items():
        if job is not None:
            proc, tmp = job
            rc = proc.wait()
            if rc != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n"
                              + log.read_text())
                continue
            os.replace(tmp, target)
        out[name] = target
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    current build of ``name``, or '' if it has not been built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build([name])[name]))


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))
