"""Depth sampling: stratified coarse samples and inverse-CDF importance
sampling.  Counterpart of ``nerf_fl_tpu/core/sampling.py``; mip-NeRF's
resampling of interval edges (``resample_intervals``,
``sorted_piecewise_constant_pdf``) has no JAX counterpart and follows
``google/mipnerf`` (internal/mip.py, internal/math.py).

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


F32_EPS = float(torch.finfo(torch.float32).eps)


def sorted_piecewise_constant_pdf(bins: torch.Tensor, weights: torch.Tensor,
                                  num_samples: int, randomized: bool, *,
                                  generator: Optional[torch.Generator] = None,
                                  u: Optional[torch.Tensor] = None,
                                  shard: Optional[Tuple[int, int]] = None
                                  ) -> torch.Tensor:
    """mip-NeRF's ``sorted_piecewise_constant_pdf``: (N, num_samples)
    sorted samples of the piecewise-constant pdf ``weights`` (N, S) over
    the edges ``bins`` (N, S + 1).  Weights summing under 1e-5 are padded
    evenly up to it; the cdf is clipped at 1 and ends in 0 and 1.
    Randomized, sample i is (i + U[0, 1)) / num_samples less a float32 eps
    in width (one uniform (N, num_samples) draw from ``generator``, or
    ``u``; ``shard`` is ``draw_rows``'), else evenly spaced over [0, 1 -
    eps].  Each sample's interval is found by a search of the cdf (the
    published code's mask and max / min finds the same one)."""
    eps = 1e-5
    n = weights.shape[0]
    weight_sum = weights.sum(-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[:, :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf,
                     torch.ones_like(cdf[:, :1])], -1)
    if randomized:
        s = 1 / num_samples
        if u is None:
            u = draw_rows(lambda sh: torch.rand(
                sh, generator=generator, dtype=bins.dtype,
                device=bins.device), (n, num_samples), shard)
        u = torch.arange(num_samples, dtype=bins.dtype,
                         device=bins.device) * s + u * (s - F32_EPS)
        u = torch.clamp(u, max=1 - F32_EPS)
    else:
        u = torch.linspace(0.0, 1.0 - F32_EPS, num_samples, dtype=bins.dtype,
                           device=bins.device).expand(n, num_samples)
    last = cdf.shape[-1] - 1
    below = torch.clamp(searchsorted_right(cdf, u) - 1, 0, last)
    above = torch.clamp(below + 1, max=last)
    bins_g0, bins_g1 = bins.gather(1, below), bins.gather(1, above)
    cdf_g0, cdf_g1 = cdf.gather(1, below), cdf.gather(1, above)
    t = torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0.0)
    t = torch.clamp(t, 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_intervals(t_vals: torch.Tensor, weights: torch.Tensor,
                       padding: float, randomized: bool, *,
                       generator: Optional[torch.Generator] = None,
                       shard: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """mip-NeRF's ``resample_along_rays``' new edges (N, S + 1) from the
    edges ``t_vals`` (N, S + 1) and the previous level's weights (N, S):
    the weights padded by their end values, the max of neighbours, then
    their mean (the "blurpool"), plus ``padding``, sampled by
    ``sorted_piecewise_constant_pdf`` at S + 1 edges.  The caller stops the
    gradient."""
    w = torch.cat([weights[:, :1], weights, weights[:, -1:]], -1)
    w = torch.maximum(w[:, :-1], w[:, 1:])
    w = 0.5 * (w[:, :-1] + w[:, 1:]) + padding
    return sorted_piecewise_constant_pdf(t_vals, w, t_vals.shape[-1],
                                         randomized, generator=generator,
                                         shard=shard)
