"""Seeded NeRF-W training perturbations of Blender frames, on uint8 arrays.

The port's counterpart of ``nerf_fl_tpu/data/perturbations.py``, which
draws on PIL images; here the image is an (H, W, 4) RGBA uint8 array and
the result is byte for byte PIL's: the same ``np.random.seed`` calls and
uniform / randint / choice draws in the same order, the colour jitter's
float64 round trip ``(255 * x).astype(np.uint8)`` (which truncates, on
every channel), and ``ImageDraw.rectangle``'s fill (both corners
inclusive, so neighbouring stripes share a column; a 3-tuple fill on RGBA
sets alpha 255; clipped at the border).
"""
from __future__ import annotations

import numpy as np


def add_perturbation(img: np.ndarray, perturbation, seed: int) -> np.ndarray:
    """Apply seeded color jitter and/or a 10-stripe occluder to an
    (H, W, 4) uint8 RGBA image; returns a new array.

    color: scale s~U(0.8, 1.2), bias b~U(-0.2, 0.2) per channel under
    np.random.seed(seed); occ: 200x200 block of 10 20px stripes at
    (U{200..399}, U{200..399}), stripe i colored under seed 10*seed+i.
    """
    img = np.array(img, np.uint8)
    if "color" in perturbation:
        np.random.seed(seed)
        img_np = img / 255.0
        s = np.random.uniform(0.8, 1.2, size=3)
        b = np.random.uniform(-0.2, 0.2, size=3)
        img_np[..., :3] = np.clip(s * img_np[..., :3] + b, 0, 1)
        img = (255 * img_np).astype(np.uint8)
    if "occ" in perturbation:
        np.random.seed(seed)
        left = np.random.randint(200, 400)
        top = np.random.randint(200, 400)
        for i in range(10):
            np.random.seed(10 * seed + i)
            color = np.random.choice(range(256), 3)
            img[top:top + 201, left + 20 * i:left + 20 * (i + 1) + 1] = \
                (*color, 255)
    return img
