"""The learned per-camera pose table: per-camera so(3) + R^3 deltas
composed onto a frozen initial c2w by the exponential map, and the
pose-noise harness of BARF's evaluation protocol.

Counterpart of ``nerf_fl_tpu/models/poses.py``.  The table is a module:
``r`` and ``t`` are parameters (trained only with pose refinement, which
freezes them otherwise), ``init_c2w`` a buffer that is never trained.  It
is sized by the number of images, and ``all_poses`` computes every
camera's pose in one batched computation; a ray's pose is a gather.  The
harness (``perturb_poses``, ``gauge_transform``, ``pose_errors``) is host
numpy, a copy of the JAX package's: seeded SE(3) noise on the initial
poses, and the rotation / translation errors after a rigid alignment.
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
    """Per-ray (..., 4, 4) poses gathered by camera / image index.  An
    indexing gather, whose backward (an accumulating ``index_put_``) sums
    in the same order at every run on the card, unlike ``index_select``'s
    atomic ``index_add_``: a captured step with pose refinement stays bit
    for bit its eager step."""
    return all_poses(table)[cam_ids.long()]


def learned_poses(state: dict) -> np.ndarray:
    """(N, 4, 4) float32 refined poses of a checkpoint's ``learn_poses``
    entry ({'r', 't', ['init_c2w']} tensors or arrays)."""
    init = state.get("init_c2w")
    table = LearnPose(len(state["r"]),
                      None if init is None else np.asarray(init, np.float32))
    with torch.no_grad():
        table.r.copy_(torch.as_tensor(np.asarray(state["r"], np.float32)))
        table.t.copy_(torch.as_tensor(np.asarray(state["t"], np.float32)))
        return all_poses(table).numpy()


# ----------------------------------------------------------------------
# the pose-noise / pose-error harness (host numpy): perturb the initial
# poses, train with refinement, report the errors before and after (BARF
# paper sec. 5)
# ----------------------------------------------------------------------

def _rodrigues(rotvec: np.ndarray) -> np.ndarray:
    """(N, 3) rotation vectors -> (N, 3, 3) rotation matrices."""
    theta = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    axis = rotvec / np.maximum(theta, 1e-12)
    K = np.zeros(rotvec.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -axis[..., 2], axis[..., 1]
    K[..., 1, 0], K[..., 1, 2] = axis[..., 2], -axis[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -axis[..., 1], axis[..., 0]
    th = theta[..., None]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def perturb_poses(init_c2w: np.ndarray, rot_deg: float, trans_frac: float,
                  seed: int = 0) -> np.ndarray:
    """Seeded SE(3) noise left-composed onto (N, 4, 4) c2w matrices, the
    composition the learned deltas use (``exp(r, t) @ init``), so the
    refinement can represent the injected error exactly.  ``rot_deg`` is
    the RMS rotation angle in degrees; ``trans_frac`` scales the
    translation sigma by each camera's distance from the origin."""
    rng = np.random.default_rng([seed, 17])
    init_c2w = np.asarray(init_c2w, np.float64)
    n = len(init_c2w)
    rotvec = np.deg2rad(rot_deg) * rng.standard_normal((n, 3)) / np.sqrt(3)
    dist = np.linalg.norm(init_c2w[:, :3, 3], axis=1, keepdims=True)
    tn = trans_frac * dist * rng.standard_normal((n, 3))
    delta = np.tile(np.eye(4), (n, 1, 1))
    delta[:, :3, :3] = _rodrigues(rotvec)
    delta[:, :3, 3] = tn
    return (delta @ init_c2w).astype(np.float32)


def gauge_transform(pred_c2w: np.ndarray, true_c2w: np.ndarray) -> np.ndarray:
    """Rigid (4, 4) world transform T minimizing ||T @ pred - true|| over
    the camera centers (Procrustes without scale).  Joint pose and scene
    refinement is defined only up to a global SE(3) gauge; T maps the
    refined frame back to the true one, so a true-frame camera renders in
    the refined scene as ``inv(T) @ c2w``."""
    pred = np.asarray(pred_c2w, np.float64)[:, :3, :4]
    true = np.asarray(true_c2w, np.float64)[:, :3, :4]
    cp, ct = pred[:, :, 3], true[:, :, 3]
    mp, mt = cp.mean(0), ct.mean(0)
    H = (cp - mp).T @ (ct - mt)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    Rg = Vt.T @ D @ U.T
    T = np.eye(4)
    T[:3, :3] = Rg
    T[:3, 3] = mt - Rg @ mp
    return T


def pose_errors(pred_c2w: np.ndarray, true_c2w: np.ndarray,
                align: bool = True):
    """(mean rotation error in degrees, mean camera-center error) between
    two (N, >=3, 4) pose sets, after a rigid alignment of the camera
    centers (``gauge_transform``) when ``align`` and N >= 3."""
    pred = np.asarray(pred_c2w, np.float64)[:, :3, :4]
    true = np.asarray(true_c2w, np.float64)[:, :3, :4]
    Rp, cp = pred[:, :, :3], pred[:, :, 3]
    Rt, ct = true[:, :, :3], true[:, :, 3]
    if align and len(pred) >= 3:
        T = gauge_transform(pred, true)
        Rg, tg = T[:3, :3], T[:3, 3]
        Rp = Rg[None] @ Rp
        cp = cp @ Rg.T + tg
    rel = Rp @ np.swapaxes(Rt, 1, 2)
    cosang = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_deg = float(np.rad2deg(np.arccos(cosang)).mean())
    trans = float(np.linalg.norm(cp - ct, axis=1).mean())
    return rot_deg, trans
