"""Image quality metrics: mse, psnr and ssim.

Counterpart of ``nerf_fl_tpu/training/metrics.py``.  ``ssim`` is kornia's
windowed SSIM (Gaussian window of sigma 1.5, data range 1) as a depthwise
``conv2d`` with reflect padding, in [-1, 1] as the JAX package reports it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    """(size, size) window, float64 on the host: the window's f32 rounding
    is amplified up to 1/C2 in near-flat patches, so it is cast to the
    images' dtype only at the end, as in the JAX package."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / np.sum(g)
    return np.outer(g, g)


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D filter with reflect padding; img (B, C, H, W)."""
    C, k = img.shape[1], kernel.shape[0]
    pad = k // 2
    img = F.pad(img, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(img, kernel.expand(C, 1, k, k), groups=C)


def ssim(image_pred, image_gt, window_size: int = 3, reduction: str = "mean",
         max_val: float = 1.0):
    """SSIM in [-1, 1]; image_pred, image_gt (B, C, H, W) in [0, 1]
    (tensors, or arrays taken as CPU tensors)."""
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    image_pred = torch.as_tensor(image_pred)
    image_gt = torch.as_tensor(image_gt, dtype=image_pred.dtype,
                               device=image_pred.device)
    window = torch.as_tensor(_gaussian_window(window_size, 1.5)).to(
        image_pred.device, image_pred.dtype)

    mu1 = _filter2d(image_pred, window)
    mu2 = _filter2d(image_gt, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(image_pred * image_pred, window) - mu1_sq
    sigma2_sq = _filter2d(image_gt * image_gt, window) - mu2_sq
    sigma12 = _filter2d(image_pred * image_gt, window) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if reduction == "mean":
        return torch.mean(ssim_map)
    return ssim_map
