"""Training losses, as functions returning named-term dicts.

Counterpart of ``nerf_fl_tpu/training/losses.py``, with the NeRF-W quirks
kept: the ``+3`` offset on the beta log-likelihood term and lambda_u = 0.01
on the transient-sigma regularizer.  The caller sums the dict values.
"""
from __future__ import annotations

from typing import Dict

import torch


def color_loss(results: Dict, targets: torch.Tensor,
               coef: float = 1.0) -> Dict[str, torch.Tensor]:
    """Plain coarse (+ fine) MSE."""
    loss = torch.mean((results["rgb_coarse"] - targets) ** 2)
    if "rgb_fine" in results:
        loss = loss + torch.mean((results["rgb_fine"] - targets) ** 2)
    return {"color": coef * loss}


def nerfw_loss(results: Dict, targets: torch.Tensor, coef: float = 1.0,
               lambda_u: float = 0.01) -> Dict[str, torch.Tensor]:
    """NeRF-W eq. 13.  Terms: c_l coarse color, f_l fine color
    (beta-weighted NLL when the transient head is active), b_l = 3 +
    mean(log beta), s_l = lambda_u * mean(transient sigma)."""
    ret = {"c_l": 0.5 * torch.mean((results["rgb_coarse"] - targets) ** 2)}
    if "rgb_fine" in results:
        if "beta" not in results:
            ret["f_l"] = 0.5 * torch.mean(
                (results["rgb_fine"] - targets) ** 2)
        else:
            beta = results["beta"][:, None]
            ret["f_l"] = torch.mean(
                (results["rgb_fine"] - targets) ** 2 / (2.0 * beta ** 2))
            ret["b_l"] = 3.0 + torch.mean(torch.log(results["beta"]))
            ret["s_l"] = lambda_u * torch.mean(results["transient_sigmas"])
    return {k: coef * v for k, v in ret.items()}


def mip_loss(results: Dict, targets: torch.Tensor,
             coarse_mult: float = 0.1) -> Dict[str, torch.Tensor]:
    """mip-NeRF's loss (``train.py:train_step`` with lossmult 1, single-scale
    Blender): each level's squared error summed over the channels and
    averaged over the rays, the coarse level's times ``coarse_mult``
    (``Config.coarse_loss_mult``).  Terms: c_l, f_l."""
    def level(rgb):
        return torch.mean(torch.sum((rgb - targets) ** 2, dim=-1))
    return {"c_l": coarse_mult * level(results["rgb_coarse"]),
            "f_l": level(results["rgb_fine"])}


loss_dict = {"color": color_loss, "nerfw": nerfw_loss, "mip": mip_loss}
