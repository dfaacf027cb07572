"""Depth sampling: stratified coarse samples and inverse-CDF importance
sampling.  Counterpart of ``nerf_fl_tpu/core/sampling.py``.

Stochastic draws come from a ``torch.Generator``, or are injected by the
caller (``u``) so that tests can feed both packages the same numbers.  A
batch that is one rank's rows of a data-parallel batch (``shard``) draws
at the global batch's shape and keeps its own rows (``draw_rows``), so a
ray gets the same numbers whatever the layout of the job.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.sorting import sorted_uniform


def draw_rows(make: Callable[[tuple], torch.Tensor], shape,
              shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``make(shape)``, or with ``shard`` = (index, count) the rows
    ``index`` of ``make`` at the shape of ``count`` such batches stacked:
    the draw of a rank that holds rows [index * n, (index + 1) * n) of a
    batch of count * n rays, as the whole batch's draw would give them (the
    JAX package's draws have the global shape, however the batch is
    sharded)."""
    if shard is None:
        return make(tuple(shape))
    index, count = shard
    n = shape[0]
    return make((n * count,) + tuple(shape[1:]))[index * n:(index + 1) * n]


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, N_samples: int, *,
                      use_disp: bool = False, perturb: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None,
                      shard: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Coarse depth samples (N_rays, N_samples); near/far are (N_rays, 1).
    ``u`` (N_rays, N_samples) overrides the jitter uniforms; ``shard`` is
    ``draw_rows``'."""
    N_rays = near.shape[0]
    z_steps = torch.linspace(0.0, 1.0, N_samples, dtype=near.dtype,
                             device=near.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(N_rays, N_samples)

    if perturb > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], z_mid], -1)
        if u is None:
            u = draw_rows(lambda s: torch.rand(
                s, generator=generator, dtype=z_vals.dtype,
                device=z_vals.device), z_vals.shape, shard)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def searchsorted_right(sorted_seq: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Per row, the number of elements of ``sorted_seq`` that are <= each
    query: (N, Q) indices in [0, S]."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(),
                              right=True)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, N_importance: int,
               det: bool = False, eps: float = 1e-5, *,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None,
               shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling; returns (N_rays, N_importance) sorted
    samples.  bins (N_rays, S+1) are bin edges, weights (N_rays, S).
    Stochastic mode draws sorted uniforms, or takes sorted ``u``; ``shard``
    is ``draw_rows``'."""
    N_rays, S = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, S+1)

    if det:
        u = torch.linspace(0.0, 1.0, N_importance, dtype=bins.dtype,
                           device=bins.device).expand(N_rays, N_importance)
    elif u is None:
        u = draw_rows(lambda s: sorted_uniform(
            s, generator=generator, device=bins.device, dtype=bins.dtype),
            (N_rays, N_importance), shard)

    inds = searchsorted_right(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=S)

    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bin_lo = torch.gather(bins, 1, below)
    bin_hi = torch.gather(bins, 1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)
