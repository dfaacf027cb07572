"""PFM float images: the port's copy of ``nerf_fl_tpu/data/pfm.py``.

``read_pfm`` returns (data, scale) with the rows flipped to top-down order;
``save_pfm`` writes float32 (H, W) or (H, W, 3) bottom-up, little-endian,
with the scale's sign giving the byte order as the format defines.  Eval's
``--save_depth`` writes its depth maps with it.
"""
from __future__ import annotations

import re

import numpy as np


def read_pfm(filename: str):
    """(data, scale); data float32 (H, W) or (H, W, 3), top-down rows."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{filename}: not a PFM file")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim_match:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(np.reshape(data, shape)), scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write float32 (H, W), (H, W, 1) or (H, W, 3) as PFM."""
    if image.dtype.name != "float32":
        raise ValueError("save_pfm takes float32")
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("save_pfm takes H x W x 3, H x W x 1 or H x W")
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(b"%f\n" % scale)
        image.tofile(f)
