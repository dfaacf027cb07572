"""Sinusoidal positional encoding with optional BARF coarse-to-fine annealing,
and mip-NeRF's integrated positional encoding.

Counterpart of ``nerf_fl_tpu/core/encoding.py``.  Channel order is
``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]``, each sin/cos block
spanning the C input channels.  ``integrated_pos_enc`` has no JAX
counterpart; it is ``google/mipnerf``'s (internal/mip.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

PI = float(np.pi)

# minimax odd polynomial for sin(2*pi*u) on u in [-0.5, 0.5]
SIN2PI = (6.2831834654095857, -41.341480259587343, 81.597655247118169,
          -76.594899673933057, 41.269796373562237, -12.37227202917199)
INV_2PI = 0.15915494309189535
# Cody-Waite split of 2*pi: HI has a 12-bit mantissa so n*HI is exact in f32
TWO_PI_HI = 6.28125
TWO_PI_LO = 0.0019353071795864769


def sin_cw(x: torch.Tensor, quarter_turns=0.0) -> torch.Tensor:
    """sin(x + 2*pi*quarter_turns) via Cody-Waite reduction + odd polynomial.

    The phase is added AFTER reduction, in turn units, where it is exact.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    n = torch.round(x * INV_2PI)
    r = x - n * TWO_PI_HI
    r = r - n * TWO_PI_LO
    u = r * INV_2PI + quarter_turns
    u = u - torch.round(u)
    u2 = u * u
    p = torch.full_like(u, SIN2PI[5])
    for k in (4, 3, 2, 1, 0):
        p = p * u2 + SIN2PI[k]
    return p * u


def fast_sin(x):
    return sin_cw(x)


def fast_cos(x):
    return sin_cw(x, 0.25)


def posenc_freqs(max_logscale: int, N_freqs: int,
                 logscale: bool = True) -> np.ndarray:
    if logscale:
        return 2.0 ** np.linspace(0, max_logscale, N_freqs, dtype=np.float64)
    return np.linspace(1, 2.0 ** max_logscale, N_freqs, dtype=np.float64)


_FREQS: Dict[tuple, torch.Tensor] = {}


def freqs_on(max_logscale: int, N_freqs: int, logscale: bool,
             dtype: torch.dtype, device) -> torch.Tensor:
    """``posenc_freqs`` as a tensor on ``device``, made once per setting: a
    CUDA graph captured later reads it where it lies, since a host-to-card
    copy cannot be captured (BARF's "fork" weights in a captured step)."""
    device = torch.device(device if device is not None else "cpu")
    key = (max_logscale, N_freqs, logscale, dtype, device)
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(
            posenc_freqs(max_logscale, N_freqs, logscale), dtype=dtype,
            device=device)
    return _FREQS[key]


def posenc(x: torch.Tensor, N_freqs: int, *, max_logscale: Optional[int] = None,
           logscale: bool = True, weights: Optional[torch.Tensor] = None,
           fast: bool = False) -> torch.Tensor:
    """Embed ``x`` (..., C) -> (..., C * (1 + 2*N_freqs)); ``weights``
    (N_freqs,) scales each frequency's sin/cos block (BARF)."""
    if max_logscale is None:
        max_logscale = N_freqs - 1
    freqs = freqs_on(max_logscale, N_freqs, logscale, x.dtype, x.device)
    xb = x[..., None, :] * freqs[:, None]            # (..., F, C)
    if fast:
        sin, cos = fast_sin(xb), fast_cos(xb)
    else:
        sin, cos = torch.sin(xb), torch.cos(xb)
    if weights is not None:
        w = weights.to(x.dtype)[:, None]
        sin, cos = sin * w, cos * w
    sc = torch.stack([sin, cos], dim=-2)             # (..., F, 2, C)
    sc = sc.reshape(*x.shape[:-1], 2 * N_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def barf_alpha(epoch, N_freqs: int, epoch_start: int, epoch_end: int,
               schedule: str = "fork", device=None) -> torch.Tensor:
    """BARF annealing progress ("fork": reference rule; "paper": eq. 14)."""
    epoch = torch.as_tensor(epoch, dtype=torch.float32, device=device)
    if schedule == "paper":
        prog = torch.clamp((epoch - epoch_start)
                           / max(epoch_end - epoch_start, 1e-8), 0.0, 1.0)
        return prog * float(N_freqs)
    mid = N_freqs / torch.clamp(epoch, min=1e-8)
    zero = torch.zeros_like(epoch)
    return torch.where(epoch > epoch_end, torch.full_like(epoch, N_freqs),
                       torch.where(epoch > epoch_start, mid, zero))


def barf_weights(epoch, N_freqs: int, epoch_start: int, epoch_end: int, *,
                 max_logscale: Optional[int] = None, logscale: bool = True,
                 schedule: str = "fork", device=None) -> torch.Tensor:
    """Per-frequency annealing weights (N_freqs,) f32.  "fork" compares alpha
    with the frequency value 2^k, "paper" with the index k."""
    if max_logscale is None:
        max_logscale = N_freqs - 1
    if schedule == "paper":
        freqs = torch.arange(N_freqs, dtype=torch.float32, device=device)
    else:
        freqs = freqs_on(max_logscale, N_freqs, logscale, torch.float32,
                         device)
    alpha = barf_alpha(epoch, N_freqs, epoch_start, epoch_end, schedule,
                       device=device)
    d = alpha - freqs
    ramp = (1.0 - torch.cos(d * PI)) / 2.0
    return torch.where(d < 0.0, torch.zeros_like(d),
                       torch.where(d < 1.0, ramp, torch.ones_like(d)))


def embed(x: torch.Tensor, N_freqs: int, *, barf: bool = False, epoch=None,
          epoch_start: int = 4, epoch_end: int = 8,
          max_logscale: Optional[int] = None, logscale: bool = True,
          fast: bool = False, schedule: str = "fork") -> torch.Tensor:
    """PosEmbedding / BarfPosEmbedding forward in one entry point."""
    w = None
    if barf:
        if epoch is None:
            raise ValueError("BARF embedding requires `epoch`")
        w = barf_weights(epoch, N_freqs, epoch_start, epoch_end,
                         max_logscale=max_logscale, logscale=logscale,
                         schedule=schedule, device=x.device)
    return posenc(x, N_freqs, max_logscale=max_logscale, logscale=logscale,
                  weights=w, fast=fast)


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, n_freqs: int,
                       fast: bool = False) -> torch.Tensor:
    """mip-NeRF's IPE (``integrated_pos_enc`` with ``diag=True``, degrees 0
    to ``n_freqs``) of Gaussians with ``mean`` and diagonal ``var`` (..., 3):
    (..., 6 n_freqs) = [sin(y) * w, cos(y) * w] with y the scaled means
    [2^0 m, 2^1 m, ...] (each over the 3 components) and w = exp(-y_var /
    2), y_var = [4^0 v, 4^1 v, ...]: all sines first, then all cosines.
    ``fast``: the Cody-Waite ``sin_cw`` (the IPE kernels'), else
    ``torch.sin`` / ``torch.cos`` (mip-NeRF's sin(y + pi / 2), exactly)."""
    scales = freqs_on(n_freqs - 1, n_freqs, True, mean.dtype, mean.device)
    shape = mean.shape[:-1] + (-1,)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (var[..., None, :] * (scales ** 2)[:, None]).reshape(shape)
    w = torch.exp(-0.5 * y_var)
    if fast:
        return torch.cat([fast_sin(y) * w, fast_cos(y) * w], -1)
    return torch.cat([torch.sin(y) * w, torch.cos(y) * w], -1)
