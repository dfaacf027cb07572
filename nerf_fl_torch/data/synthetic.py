"""A Blender-format analytic scene, built from scratch (no download).

The port's copy of ``make_blender_scene`` and its helpers from
``nerf_fl_tpu/data/synthetic.py``: the same poses, pixels and JSON, with
the PNGs written by ``image_io.write_png`` instead of PIL.  The LLFF and
phototourism scenes come with their datasets (ROADMAP A.6).
"""
from __future__ import annotations

import json
import os

import numpy as np

from .image_io import write_png


def _look_at_pose(theta: float, radius: float = 4.0, height: float = 1.0):
    """Camera on a circle looking at the origin, OpenGL convention
    (right/up/back): -z is the viewing direction."""
    eye = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    forward = -eye / np.linalg.norm(eye)          # toward origin
    up0 = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up0)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -forward                          # back
    c2w[:3, 3] = eye
    return c2w


def _render_ball(size: int, c2w: np.ndarray, focal: float,
                 texture: bool = False) -> np.ndarray:
    """Analytic RGBA render of a unit ball at the origin — enough structure
    for loss-goes-down tests.  With texture=True a checker pattern in
    spherical surface coordinates modulates the luminance: the smooth
    position gradient alone leaves the static/appearance color split
    underdetermined (a global color shift is absorbable by every NeRF-W
    appearance code), while the checker pins the static field the way
    lego's texture does."""
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="xy")
    dirs = np.stack([(i - size / 2) / focal, -(j - size / 2) / focal,
                     -np.ones_like(i)], -1).astype(np.float64)
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = c2w[:3, 3]
    b = 2 * np.sum(rd * ro, -1)
    c = np.sum(ro * ro) - 1.0
    disc = b * b - 4 * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    p = ro + rd * t[..., None]
    color = np.clip(0.5 + 0.5 * p, 0, 1)
    if texture:
        az = np.arctan2(p[..., 1], p[..., 0])          # [-pi, pi]
        pol = np.arccos(np.clip(p[..., 2], -1, 1))     # [0, pi]
        checker = (np.floor(az / (np.pi / 6))
                   + np.floor(pol / (np.pi / 12))) % 2
        color = color * (0.35 + 0.65 * checker[..., None])
    img = np.zeros((size, size, 4))
    img[hit, :3] = color[hit]
    img[hit, 3] = 1.0
    return (img * 255).astype(np.uint8)


def make_blender_scene(root: str, n_train: int = 4, n_val: int = 2,
                       n_test: int = 2, size: int = 40,
                       camera_angle_x: float = 0.8,
                       texture: bool = False) -> None:
    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    k = 0
    for split, n in counts.items():
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for idx in range(n):
            theta = 2 * np.pi * (k * 0.37 % 1.0)
            k += 1
            c2w = _look_at_pose(theta)
            img = _render_ball(size, c2w, focal, texture=texture)
            rel = f"./{split}/r_{idx}"
            write_png(os.path.join(root, f"{rel}.png"), img)
            frames.append({"file_path": rel,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
