"""The cells' inputs, made on the device from the seed: the camera layouts,
the train ray pools with their target colours, and the test views' rays.

The targets are a procedural texture of each ray, a sum of seeded
sinusoids of the point four units along it, so every view is a smooth
image with structure at several scales; the weights are random, so no
target is learnable in a window, and none needs to be.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def look_at(eye: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) camera-to-world poses at `eye` (N, 3) looking at the
    origin, z up, the camera's -z forward (the Blender / nerf_pl
    convention)."""
    back = eye / torch.linalg.norm(eye, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=eye.device).expand_as(back)
    right = torch.linalg.cross(up, back, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    up = torch.linalg.cross(back, right, dim=-1)
    c2w = torch.zeros(eye.shape[0], 4, 4, device=eye.device)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2] = right, up, back
    c2w[:, :3, 3] = eye
    c2w[:, 3, 3] = 1.0
    return c2w


def pixel_dirs(w: int, h: int, focal: float, device) -> torch.Tensor:
    """(h * w, 3) camera-frame directions [(i - w/2)/f, -(j - h/2)/f, -1]
    on the pixel-corner grid (i the column, j the row)."""
    j, i = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32),
                          indexing="ij")
    return torch.stack([(i - w / 2) / focal, -(j - h / 2) / focal,
                        -torch.ones_like(i)], -1).reshape(-1, 3)


def world(c2w: torch.Tensor, dirs: torch.Tensor):
    """(origins, unit directions) of camera-frame `dirs` (P, 3) under
    every pose of `c2w` (N, 4, 4): (N, P, 3) each."""
    d = torch.einsum("pc,nrc->npr", dirs, c2w[:, :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:, None, :3, 3].expand_as(d), d


def texture(o: torch.Tensor, d: torch.Tensor, gen) -> torch.Tensor:
    """Seeded colours in [0.1, 0.9] of rays (..., 3): three sinusoids a
    channel of the point four units along the ray."""
    k = torch.randn(3, 3, 3, generator=gen, device=o.device) * 2.0
    ph = torch.rand(3, 3, generator=gen, device=o.device) * 2 * math.pi
    p = o + 4.0 * d
    arg = torch.einsum("...c,fkc->...fk", p, k) + ph
    return 0.5 + 0.4 * torch.sin(arg).mean(-2)


def _blender_poses(scene: dict, n: int, gen, device) -> torch.Tensor:
    """`n` poses on the upper hemisphere of the scene's radius."""
    az = torch.rand(n, generator=gen, device=device) * 2 * math.pi
    z = 0.05 + 0.9 * torch.rand(n, generator=gen, device=device)
    rho = torch.sqrt(1 - z * z)
    eye = scene["radius"] * torch.stack([rho * torch.cos(az),
                                         rho * torch.sin(az), z], -1)
    return look_at(eye)


def blender_focal(scene: dict) -> float:
    w = scene["img_wh"][0]
    return 0.5 * w / math.tan(0.5 * scene["camera_angle_x"])


def blender_pool(config: dict, seed: int, device) -> Dict[str, object]:
    """Every train ray of the Blender layout as the device pool holds it:
    'rays' (N, 8) world rays [o, d, near, far], 'ts' (N,) int32 image
    ids, 'rgbs' (N, 3)."""
    s = config["scene"]
    gen = torch.Generator(device).manual_seed(seed)
    w, h = s["img_wh"]
    c2w = _blender_poses(s, s["n_images"], gen, device)
    o, d = world(c2w, pixel_dirs(w, h, blender_focal(s), device))
    n = s["n_images"] * w * h
    rgbs = texture(o, d, gen).reshape(n, 3)
    nf = torch.tensor([s["near"], s["far"]], device=device).expand(n, 2)
    rays = torch.cat([o.reshape(n, 3), d.reshape(n, 3), nf], -1)
    ts = torch.arange(s["n_images"], device=device, dtype=torch.int32) \
        .repeat_interleave(w * h)
    return {"pool": {"rays": rays, "ts": ts, "rgbs": rgbs}}


def blender_test_views(config: dict, seed: int, n: int, device) -> np.ndarray:
    """(n, W * H, 8) float32 host rays of `n` consecutive views of the
    Blender test ring (test_views poses at test_elevation_deg, radius as
    the train views), starting at an azimuth from the seed."""
    s = config["scene"]
    gen = torch.Generator(device).manual_seed(seed)
    start = float(torch.rand(1, generator=gen, device=device)) * 2 * math.pi
    el = math.radians(s["test_elevation_deg"])
    az = start + 2 * math.pi * torch.arange(n, device=device) / s["test_views"]
    eye = s["radius"] * torch.stack(
        [math.cos(el) * torch.cos(az), math.cos(el) * torch.sin(az),
         torch.full_like(az, math.sin(el))], -1)
    w, h = s["img_wh"]
    o, d = world(look_at(eye), pixel_dirs(w, h, blender_focal(s), device))
    nf = torch.tensor([s["near"], s["far"]], device=device).expand(
        n, w * h, 2)
    return torch.cat([o, d, nf], -1).cpu().numpy()


def phototourism_pool(config: dict, seed: int, device) -> Dict[str, object]:
    """Every train ray of the Phototourism layout as the device pool holds
    it: 'rays' (N, 5) camera-frame [dir, near, far], 'ts' (N,) int32 sparse
    image ids, 'rgbs' (N, 3); with the pose table's initial poses
    ('init_c2w', (images, 4, 4)) and the map from image ids to its rows
    ('id_to_cam', numpy int32)."""
    s = config["scene"]
    n = s["n_images"]
    gen = torch.Generator(device).manual_seed(seed)
    # a ring around the origin; each image's near and far from the seed
    theta = 2 * math.pi * torch.arange(n, device=device) / n \
        + float(torch.rand(1, generator=gen, device=device)) * 2 * math.pi
    c2w = look_at(torch.stack([s["radius"] * torch.cos(theta),
                               s["radius"] * torch.sin(theta),
                               torch.full_like(theta, s["height"])], -1))
    near = s["near"][0] + (s["near"][1] - s["near"][0]) * torch.rand(
        n, generator=gen, device=device)
    far = s["far"][0] + (s["far"][1] - s["far"][0]) * torch.rand(
        n, generator=gen, device=device)
    ids = np.array([1 + i + i // 10 for i in range(n)], np.int64)
    sizes = np.array([s["sizes"][i % len(s["sizes"])] // s["img_downscale"]
                      for i in range(n)], np.int64)
    rays, ts, rgbs = [], [], []
    for size in sorted(set(sizes.tolist())):
        rows = np.nonzero(sizes == size)[0]
        r = torch.as_tensor(rows, device=device)
        dirs = pixel_dirs(size, size, s["focal_scale"] * size, device)
        o, d = world(c2w[r], dirs)
        k, p = len(rows), size * size
        rgbs.append(texture(o, d, gen).reshape(k * p, 3))
        rays.append(torch.cat([
            dirs.expand(k, p, 3),
            near[r][:, None, None].expand(k, p, 1),
            far[r][:, None, None].expand(k, p, 1)], -1).reshape(k * p, 5))
        ts.append(torch.as_tensor(ids[rows], device=device,
                                  dtype=torch.int32).repeat_interleave(p))
        del o, d
    id_to_cam = np.zeros(int(ids.max()) + 1, np.int32)
    id_to_cam[ids] = np.arange(len(ids), dtype=np.int32)
    return {"pool": {"rays": torch.cat(rays), "ts": torch.cat(ts),
                     "rgbs": torch.cat(rgbs)},
            "init_c2w": c2w, "id_to_cam": id_to_cam}


POOLS = {"blender": blender_pool, "phototourism": phototourism_pool}
