"""Depth-map visualization.

The port's counterpart of ``nerf_fl_tpu/utils/visualization.py``, which
colours through cv2; here cv2's ``COLORMAP_JET`` is a 256-entry RGB table.
"""
from __future__ import annotations

import numpy as np

# cv2.applyColorMap(arange(256), COLORMAP_JET) as RGB, row i for level i
_JET = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"),
    np.uint8).reshape(256, 3)


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (3, H, W) float32 JET colormap in [0, 1]."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    mi, ma = np.min(x), np.max(x)
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * x).astype(np.uint8)
    return _JET[x].astype(np.float32).transpose(2, 0, 1) / 255.0
