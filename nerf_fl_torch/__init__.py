"""PyTorch + CUDA port of nerf_fl_tpu for NVIDIA Hopper (sm_90a).

The module layout mirrors ``nerf_fl_tpu`` (core/, ops/, models/, render/,
training/) so each counterpart is easy to find.  The package imports torch,
numpy and the standard library only; CUDA kernels under ``csrc/`` are built
with nvcc at first use (``ops/_build.py``), never at import.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
