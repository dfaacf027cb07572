"""The learned per-camera pose table: per-camera so(3) + R^3 deltas
composed onto a frozen initial c2w by the exponential map.

Counterpart of the table half of ``nerf_fl_tpu/models/poses.py``
(``init_learn_pose``, ``all_poses``, ``pose_for``).  The table is a module:
``r`` and ``t`` are parameters (trained only with pose refinement, which
freezes them otherwise), ``init_c2w`` a buffer that is never trained.  It
is sized by the number of images, and ``all_poses`` computes every
camera's pose in one batched computation; a ray's pose is a gather.  The
pose-noise harness (``perturb_poses``, ``gauge_transform``,
``pose_errors``) belongs to pose refinement (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.lie import make_c2w


class LearnPose(nn.Module):
    """``r``, ``t`` (N, 3) f32 deltas, zero at init; ``init_c2w`` (N, 4, 4)
    f32 or None."""

    def __init__(self, num_cams: int, init_c2w: Optional[np.ndarray] = None,
                 device=None):
        super().__init__()
        self.r = nn.Parameter(torch.zeros(num_cams, 3, device=device))
        self.t = nn.Parameter(torch.zeros(num_cams, 3, device=device))
        self.init_c2w: Optional[torch.Tensor]
        if init_c2w is None:
            self.register_buffer("init_c2w", None)
        else:
            self.register_buffer("init_c2w", torch.tensor(
                np.asarray(init_c2w, np.float32), device=device))


def init_learn_pose(num_cams: int, init_c2w: Optional[np.ndarray] = None,
                    device=None) -> LearnPose:
    """Zero deltas, plus the frozen initial poses (N, 4, 4) when given."""
    return LearnPose(num_cams, init_c2w, device)


def all_poses(table: LearnPose) -> torch.Tensor:
    """(N, 4, 4) refined c2w of every camera."""
    c2w = make_c2w(table.r, table.t)
    if table.init_c2w is not None:
        c2w = c2w @ table.init_c2w
    return c2w


def pose_for(table: LearnPose, cam_ids: torch.Tensor) -> torch.Tensor:
    """Per-ray (..., 4, 4) poses gathered by camera / image index."""
    poses = all_poses(table)
    return poses.index_select(0, cam_ids.reshape(-1).long()) \
        .reshape(cam_ids.shape + (4, 4))
