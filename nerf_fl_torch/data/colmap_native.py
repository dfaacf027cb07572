"""The native COLMAP points decoder: ``csrc/colmap_fast.c`` through ctypes.

The port's counterpart of ``nerf_fl_tpu/data/colmap_native.py``.
``read_points3d_arrays`` returns the columnar arrays the Phototourism
dataset consumes; the C decoder reads a million-point reconstruction in
tens of milliseconds, where the pure-Python reader
(``colmap.read_points3d_arrays``) takes seconds.

The library is built at first use with the C compiler (``cc -O3 -shared
-fPIC``) into ``nerf_fl_torch/_build/colmap_fast-<hash>.so``, keyed by the
source and the flags as ``ops/_build.py`` keys the CUDA builds, or ahead of
time by ``python -m nerf_fl_torch.tools.build_native``.  Where no compiler
is found or the build fails, the pure-Python reader runs instead, and one
line says so.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD, CSRC
from .colmap import Points3DArrays, points3d_from_bytes

SRC = CSRC / "colmap_fast.c"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_unavailable = None   # why the library cannot be had, once it has failed


def _compiler():
    """The C compiler's path, or None."""
    return shutil.which("cc")


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + b"\0" + " ".join(CC_FLAGS).encode())
    return BUILD / f"colmap_fast-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiling it unless it is built; raises
    ``RuntimeError`` without a compiler or when the compile fails."""
    target = _target()
    if target.exists():
        return target
    cc = _compiler()
    if cc is None:
        raise RuntimeError("no C compiler (cc) found")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{cc} failed on {SRC.name} (rc={out.returncode}):"
                           f" {out.stderr.strip()[-500:]}")
    os.replace(tmp, target)
    return target


def _load():
    """The loaded library, building it at first use; None (after one line
    on stdout) where it cannot be built."""
    global _lib, _unavailable
    if _lib is None and _unavailable is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _unavailable = str(e)
            print(f"[colmap] native points decoder unavailable ({e}); "
                  "reading points3D.bin with the pure-Python reader",
                  flush=True)
            return None
        lib.colmap_points3d_count.restype = ctypes.c_longlong
        lib.colmap_points3d_count.argtypes = [ctypes.c_char_p,
                                              ctypes.c_longlong]
        lib.colmap_points3d_decode.restype = ctypes.c_int
        lib.colmap_points3d_tracks.restype = ctypes.c_int
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_points3d_arrays(path: str, *, with_tracks: bool = False
                         ) -> Points3DArrays:
    """Columnar points3D.bin decode, native where the library builds.  A
    truncated file raises ``ValueError`` on either path."""
    with open(path, "rb") as f:
        buf = f.read()
    lib = _load()
    if lib is None:
        return points3d_from_bytes(buf, with_tracks, path)

    n = lib.colmap_points3d_count(buf, len(buf))
    if n < 0:
        raise ValueError(f"corrupt points3D file: {path}")
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    error = np.empty(n, np.float64)
    track_len = np.empty(n, np.int64)
    rc = lib.colmap_points3d_decode(
        buf, ctypes.c_longlong(len(buf)), ctypes.c_longlong(n),
        _ptr(ids, ctypes.c_int64), _ptr(xyz, ctypes.c_double),
        _ptr(rgb, ctypes.c_ubyte), _ptr(error, ctypes.c_double),
        _ptr(track_len, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"corrupt points3D file: {path}")
    tracks = None
    if with_tracks:
        tracks = np.empty((int(track_len.sum()), 2), np.int32)
        rc = lib.colmap_points3d_tracks(
            buf, ctypes.c_longlong(len(buf)), ctypes.c_longlong(n),
            _ptr(tracks, ctypes.c_int32))
        if rc != 0:
            raise ValueError(f"corrupt points3D file: {path}")
    return Points3DArrays(ids, xyz, rgb, error, track_len, tracks)

