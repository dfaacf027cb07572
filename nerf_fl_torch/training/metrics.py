"""Image quality metrics (subset): mse and psnr.

Counterpart of ``nerf_fl_tpu/training/metrics.py``.
"""
from __future__ import annotations

from typing import Optional

import torch


def mse(image_pred, image_gt, valid_mask: Optional[torch.Tensor] = None,
        reduction: str = "mean"):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        if reduction == "mean":
            m = valid_mask.to(value.dtype)
            if m.dim() < value.dim():
                m = m[..., None]
            m = m.expand(value.shape)
            return torch.sum(value * m) / torch.clamp(torch.sum(m), min=1.0)
        value = value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr(image_pred, image_gt, valid_mask: Optional[torch.Tensor] = None,
         reduction: str = "mean"):
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask,
                                   reduction))
