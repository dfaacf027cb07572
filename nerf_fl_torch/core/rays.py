"""Ray-geometry primitives: pixel-corner convention, -z forward, NDC warp.

Counterpart of ``nerf_fl_tpu/core/rays.py``.
"""
from __future__ import annotations

import torch


def get_ray_directions(H: int, W: int, K, device=None) -> torch.Tensor:
    """(H, W, 3) camera-frame directions ``[(i-cx)/fx, -(j-cy)/fy, -1]``
    on a non-centred pixel grid (i = column, j = row)."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=K.device),
        torch.arange(W, dtype=torch.float32, device=K.device),
        indexing="ij")
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """World-space (rays_o, rays_d), rays_d unit-norm; ``c2w`` is one (3, 4)
    pose or (N, 3, 4) per-ray poses."""
    directions = directions.reshape(-1, 3)
    if c2w.ndim == 2:
        rays_d = directions @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand(rays_d.shape)
    else:
        rays_d = torch.einsum("nc,nrc->nr", directions, c2w[:, :3, :3])
        rays_o = c2w[:, :3, 3]
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o, rays_d):
    """Warp world-space rays into NDC for forward-facing scenes."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
