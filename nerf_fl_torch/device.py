"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  Without a
GPU and without an explicit ``device="cpu"`` they raise: the port never
carries on silently on the CPU.
"""
from __future__ import annotations

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
