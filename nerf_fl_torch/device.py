"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  Without a
GPU and without an explicit ``device="cpu"`` they raise: the port never
carries on silently on the CPU.  The train and eval CLIs also take the
request from the environment, ``NERF_FL_TORCH_DEVICE=cpu`` (``entry_device``).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerf_fl_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU explicitly")
    return dev


def entry_device(device: Optional[Union[str, torch.device]] = None
                 ) -> torch.device:
    """The device of a CLI entry point: ``device``, else the environment's
    ``NERF_FL_TORCH_DEVICE``, else ``cuda`` (which must be present)."""
    if device is None:
        device = os.environ.get("NERF_FL_TORCH_DEVICE") or None
    return resolve_device(device)
