"""mip-NeRF's cone casting: each ray a cone, each interval between two
sample edges a conical frustum, approximated by a Gaussian with a diagonal
covariance in world space.

Follows ``google/mipnerf``'s ``internal/mip.py`` (Barron et al. 2021,
"Mip-NeRF", eq. 7-8): ``conical_frustum_to_gaussian`` in its stable form
and ``lift_gaussian`` with ``diag=True``; ``cast`` is ``cast_rays`` for
``ray_shape='cone'``; the cones' base radii come with the rays
(``data/rays_np.get_cone_rays``).
"""
from __future__ import annotations

from typing import Tuple

import torch


def frustum_moments(t0: torch.Tensor, t1: torch.Tensor,
                    radius: torch.Tensor):
    """(t_mean, t_var, r_var) of the frustums between depths t0 and t1 of a
    cone whose radius grows by ``radius`` per unit depth, with mu = (t0 +
    t1) / 2 and h = (t1 - t0) / 2:
    t_mean = mu + 2 mu h^2 / (3 mu^2 + h^2),
    t_var = h^2 / 3 - (4/15) h^4 (12 mu^2 - h^2) / (3 mu^2 + h^2)^2,
    r_var = r^2 (mu^2 / 4 + (5/12) h^2 - (4/15) h^4 / (3 mu^2 + h^2))."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    den = 3 * mu ** 2 + hw ** 2
    t_mean = mu + (2 * mu * hw ** 2) / den
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                         / den ** 2)
    r_var = radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                           - 4 / 15 * (hw ** 4) / den)
    return t_mean, t_var, r_var


def cast(t_vals: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor,
         radii: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Gaussians of the intervals between consecutive edges ``t_vals``
    (N, S + 1) of rays (origins, directions (N, 3), the directions not
    normalised; radii (N, 1)): (means, variances), each (N, S, 3).
    mean = o + d t_mean; var = t_var d^2 + r_var (1 - d^2 / max(1e-10,
    |d|^2))."""
    t_mean, t_var, r_var = frustum_moments(t_vals[..., :-1], t_vals[..., 1:],
                                           radii)
    d = directions[:, None, :]
    mean = d * t_mean[..., None]
    d_mag_sq = torch.clamp((directions ** 2).sum(-1, keepdim=True),
                           min=1e-10)[:, None, :]
    d_outer = d ** 2
    var = t_var[..., None] * d_outer \
        + r_var[..., None] * (1 - d_outer / d_mag_sq)
    return mean + origins[:, None, :], var
