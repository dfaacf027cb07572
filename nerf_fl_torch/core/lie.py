"""Batched so(3) / SE(3) helpers for the learned-pose table.

Counterpart of ``nerf_fl_tpu/core/lie.py``: ``exp_so3`` and ``make_c2w``
map over a leading batch axis, so every camera's pose is one batched
computation and a ray's pose is a gather on the device.
"""
from __future__ import annotations

import numpy as np
import torch


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    zero = torch.zeros_like(v[..., 0])
    rows = [torch.stack([zero, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], zero, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], zero], -1)]
    return torch.stack(rows, -2)


def exp_so3(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues' exponential map so(3) -> SO(3), batched.

    The deltas start at exactly zero, where sin(x) / x and (1 - cos(x)) /
    x^2 have removable singularities whose plain gradient is NaN: below
    |r|^2 = 1e-9 both take their Taylor forms, and the other branch divides
    by |r|^2 clamped to 1 there, so neither branch's gradient is NaN (the
    JAX package's double ``where``)."""
    skew = vec2skew(r)
    sq = torch.sum(r * r, dim=-1, keepdim=True)[..., None]
    small = sq < 1e-9
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    norm = torch.sqrt(safe_sq)
    A = torch.where(small, 1.0 - sq / 6.0, torch.sin(norm) / norm)
    B = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(norm)) / safe_sq)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(skew.shape)
    return eye + A * skew + B * (skew @ skew)


def convert3x4_4x4(m: torch.Tensor) -> torch.Tensor:
    """Pad (..., 3, 4) -> (..., 4, 4) with the row [0, 0, 0, 1] (made on
    the device: a CUDA graph's capture allows no copy from the host)."""
    bottom = torch.zeros_like(m[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([m, bottom], dim=-2)


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle + (..., 3) translation -> (..., 4, 4) pose."""
    top = torch.cat([exp_so3(r), t[..., None]], dim=-1)
    return convert3x4_4x4(top)


def convert3x4_4x4_np(m: np.ndarray) -> np.ndarray:
    """The numpy twin of ``convert3x4_4x4`` for host-side pose prep."""
    if m.ndim == 3:
        bottom = np.zeros_like(m[:, :1])
        bottom[:, 0, 3] = 1.0
        return np.concatenate([m, bottom], axis=1)
    bottom = np.array([[0, 0, 0, 1]], dtype=m.dtype)
    return np.concatenate([m, bottom], axis=0)
