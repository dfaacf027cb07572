"""Host-side (NumPy) ray geometry for the data pipeline.

The port's own copy of ``nerf_fl_tpu/data/rays_np.py``: the same float32
numpy operations in the same order, so both packages bake the same rays
bit for bit.
"""
from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, K: np.ndarray) -> np.ndarray:
    """(H, W, 3) camera-frame directions; matches ray_utils.py:5-26 (pixel
    corners, not centers)."""
    K = np.asarray(K, np.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    return np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)],
                    axis=-1).astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space origins and unit directions; matches ray_utils.py:29-55."""
    directions = directions.reshape(-1, 3).astype(np.float32)
    c2w = np.asarray(c2w, np.float32)
    if c2w.ndim == 2:
        rays_d = directions @ c2w[:3, :3].T
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    else:
        rays_d = np.einsum("nc,nrc->nr", directions, c2w[:, :3, :3])
        rays_o = c2w[:, :3, 3].copy()
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_cone_rays(directions: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """mip-NeRF's rays of one view (google/mipnerf internal/datasets.py's
    Blender loader): (H * W, 7) [origin, direction, radius], the camera
    directions (H, W, 3) rotated into the world and not normalised, each
    cone's base radius the distance to the next row's direction (the last
    row takes the one before it) times 2 / sqrt(12).  No JAX
    counterpart."""
    c2w = np.asarray(c2w, np.float32)
    d = (directions.astype(np.float32) @ c2w[:3, :3].T).astype(np.float32)
    dx = np.sqrt(np.sum((d[:-1] - d[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1]], 0)
    radii = dx[..., None] * 2 / np.sqrt(12)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return np.concatenate([o, d, radii], -1).reshape(-1, 7) \
        .astype(np.float32)


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o, rays_d):
    """NDC warp; matches ray_utils.py:58-98."""
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
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


def to_float_rgb(img) -> np.ndarray:
    """uint8 image -> (H*W, C) float32 in [0, 1] (torchvision ToTensor
    semantics: uint8 / 255)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr.reshape(-1, arr.shape[-1]) if arr.ndim == 3 else arr.reshape(-1, 1)


def blend_alpha_to_white(rgba: np.ndarray) -> np.ndarray:
    """(N, 4) RGBA -> (N, 3) RGB blended over white (blender.py:89)."""
    rgb, a = rgba[:, :3], rgba[:, 3:4]
    return rgb * a + (1.0 - a)
