"""Alpha compositing for static / static+transient radiance fields.

Counterpart of ``nerf_fl_tpu/core/compositing.py``, with the reference's
quirks kept: terminal bin delta 1e2, sigma noise only on the static path,
``beta_min`` added after compositing, and the white-background blend of the
static decomposition map taken from the COMBINED opacity.
``composite_intervals`` is mip-NeRF's ``volumetric_rendering``
(``google/mipnerf`` internal/mip.py), which has no JAX counterpart.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .sampling import draw_rows

DELTA_INF = 1e2


class StaticComposite(NamedTuple):
    rgb: torch.Tensor        # (N, 3)
    depth: torch.Tensor      # (N,)
    weights: torch.Tensor    # (N, S)
    opacity: torch.Tensor    # (N,)


class TransientComposite(NamedTuple):
    rgb: torch.Tensor              # (N, 3) combined static+transient
    depth: torch.Tensor            # (N,)
    weights: torch.Tensor          # (N, S) combined weights
    opacity: torch.Tensor          # (N,)
    beta: torch.Tensor             # (N,) composited uncertainty (+beta_min)
    static_rgb: torch.Tensor       # (N, 3)
    transient_rgb: torch.Tensor    # (N, 3)


def ray_deltas(z_vals: torch.Tensor) -> torch.Tensor:
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    return torch.cat([deltas, torch.full_like(deltas[:, :1], DELTA_INF)], -1)


class _CumProd(torch.autograd.Function):
    """``torch.cumprod`` over the last dim, with a backward that never
    reads a value back to the host, so a CUDA graph can capture it (torch's
    own asks the host whether the input holds a zero).  Forward: torch's.
    Backward, per row, for y = cumprod(x) and w = g y: where k is before the
    row's first zero, reversed_cumsum(w)_k / x_k, torch's formula; at the
    first zero z, y_{z-1} sum_{i>=z} g_i prod_{z<j<=i} x_j; after it, 0."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        zeros = torch.cumsum(x == 0, dim=-1)
        before = zeros == 0
        first = (x == 0) & (zeros == 1)
        rc = (g * y).flip(-1).cumsum(-1).flip(-1)
        y_prev = torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]], -1)
        after = torch.cumprod(torch.where(before | first, torch.ones_like(x),
                                          x), dim=-1)
        at_first = y_prev * torch.sum(torch.where(before, 0.0, g * after),
                                      dim=-1, keepdim=True)
        return torch.where(before, rc / x,
                           torch.where(first, at_first, torch.zeros_like(x)))


def exclusive_transmittance(alphas: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} (1 - a_j)."""
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas[:, :-1]], dim=-1)
    return _CumProd.apply(shifted)


def composite_static(z_vals: torch.Tensor, rgbs: Optional[torch.Tensor],
                     sigmas: torch.Tensor, *, noise_std: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     white_back: bool = False,
                     weights_only: bool = False,
                     shard: Optional[Tuple[int, int]] = None
                     ) -> StaticComposite:
    """Static-only compositing; ``weights_only`` is the test-time coarse
    pass (rgbs may be None); ``shard`` draws the noise as
    ``sampling.draw_rows`` does."""
    deltas = ray_deltas(z_vals)
    sig = sigmas
    if noise_std > 0:
        sig = sig + draw_rows(lambda s: torch.randn(
            s, generator=generator, dtype=sig.dtype, device=sig.device),
            sig.shape, shard) * noise_std
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sig))
    weights = alphas * exclusive_transmittance(alphas)
    opacity = torch.sum(weights, dim=-1)
    if weights_only:
        z = torch.zeros_like(opacity)
        return StaticComposite(z_vals.new_zeros(z_vals.shape[:1] + (3,)),
                               z, weights, opacity)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    if white_back:
        rgb = rgb + (1.0 - opacity[..., None])
    depth = torch.sum(weights * z_vals, dim=-1)
    return StaticComposite(rgb, depth, weights, opacity)


def composite_transient(z_vals, static_rgbs, static_sigmas, transient_rgbs,
                        transient_sigmas, transient_betas, *, beta_min: float,
                        white_back: bool = False) -> TransientComposite:
    """Static+transient compositing under a shared transmittance (no noise,
    no relu: both sigmas come from softplus heads)."""
    deltas = ray_deltas(z_vals)
    static_alphas = 1.0 - torch.exp(-deltas * static_sigmas)
    transient_alphas = 1.0 - torch.exp(-deltas * transient_sigmas)
    alphas = 1.0 - torch.exp(-deltas * (static_sigmas + transient_sigmas))

    transmittance = exclusive_transmittance(alphas)
    static_weights = static_alphas * transmittance
    transient_weights = transient_alphas * transmittance
    weights = alphas * transmittance
    opacity = torch.sum(weights, dim=-1)

    static_rgb = torch.sum(static_weights[..., None] * static_rgbs, dim=-2)
    if white_back:
        static_rgb = static_rgb + (1.0 - opacity[..., None])
    transient_rgb = torch.sum(transient_weights[..., None] * transient_rgbs,
                              dim=-2)

    beta = torch.sum(transient_weights * transient_betas, dim=-1) + beta_min
    depth = torch.sum(weights * z_vals, dim=-1)

    return TransientComposite(static_rgb + transient_rgb, depth, weights,
                              opacity, beta, static_rgb, transient_rgb)


def composite_solo_field(z_vals, rgbs, sigmas, *, white_back: bool = False,
                         combined_opacity: Optional[torch.Tensor] = None):
    """Re-composite one field alone, with its own transmittance; returns
    (rgb_map, depth_map)."""
    deltas = ray_deltas(z_vals)
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    weights = alphas * exclusive_transmittance(alphas)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    if white_back and combined_opacity is not None:
        rgb = rgb + (1.0 - combined_opacity[..., None])
    depth = torch.sum(weights * z_vals, dim=-1)
    return rgb, depth


class IntervalComposite(NamedTuple):
    rgb: torch.Tensor        # (N, 3)
    distance: torch.Tensor   # (N,)
    acc: torch.Tensor        # (N,)
    weights: torch.Tensor    # (N, S)


def composite_intervals(t_vals: torch.Tensor, rgbs: torch.Tensor,
                        sigmas: torch.Tensor, dirs: torch.Tensor, *,
                        white_back: bool = False) -> IntervalComposite:
    """mip-NeRF's ``volumetric_rendering`` over S intervals between the
    edges ``t_vals`` (N, S + 1): delta = (t1 - t0) |d| (``dirs`` (N, 3)
    not normalised), alpha = 1 - exp(-sigma delta), the exclusive
    transmittance exp(-cumsum(sigma delta)), weights alpha T; the distance
    is the weights' mean of the interval midpoints, NaN (no opacity) taken
    as far, clipped to the edges; white background rgb + (1 - acc)."""
    t_mids = 0.5 * (t_vals[:, :-1] + t_vals[:, 1:])
    delta = (t_vals[:, 1:] - t_vals[:, :-1]) \
        * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    sd = sigmas * delta
    alpha = 1 - torch.exp(-sd)
    trans = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]),
                                  torch.cumsum(sd[:, :-1], -1)], -1))
    weights = alpha * trans
    rgb = (weights[..., None] * rgbs).sum(-2)
    acc = weights.sum(-1)
    distance = torch.nan_to_num((weights * t_mids).sum(-1) / acc,
                                nan=float("inf"))
    distance = torch.minimum(torch.maximum(distance, t_vals[:, 0]),
                             t_vals[:, -1])
    if white_back:
        rgb = rgb + (1 - acc[..., None])
    return IntervalComposite(rgb, distance, acc, weights)
