"""Optimizers and the per-epoch learning-rate schedule.

Counterpart of ``nerf_fl_tpu/training/optimizers.py`` for sgd and adam:
  * ``lr_for_epoch``: steplr (MultiStepLR), cosine (CosineAnnealingLR,
    eta_min 1e-8) and poly, each optionally behind a linear warmup over
    ``warmup_epochs`` (skipped for radam/ranger), stepped per epoch;
  * ``build_optimizer``: ``torch.optim.SGD`` / ``torch.optim.Adam`` with
    eps 1e-8.  They make the same update as the JAX package's optax chains:
    weight decay is L2 added to the gradient, and optax's ``trace`` is
    torch's momentum with dampening 0.  The scheduled lr is written into
    ``param_groups`` before each step (``set_lr``).  radam and ranger are
    not ported yet.

On the card Adam is built ``capturable``, with its lr a device tensor, so
that a CUDA graph of the train step (``system.make_train_step`` with
``steps_per_execution`` > 1) replays it: ``set_lr`` fills that tensor, and
the step count and bias corrections stay on the card.  On the CPU both
optimizers take a Python float lr, as torch builds them by default.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch import nn


def lr_for_epoch(hparams, epoch: int) -> float:
    """Learning rate for a (0-indexed) epoch."""
    lr0 = hparams.lr
    eps = 1e-8
    warmup = getattr(hparams, "warmup_epochs", 0)
    mult = getattr(hparams, "warmup_multiplier", 1.0)
    use_warmup = warmup > 0 and hparams.optimizer not in ("radam", "ranger")

    if use_warmup and epoch <= warmup:
        return lr0 * ((mult - 1.0) * epoch / warmup + 1.0)
    base = lr0 * mult if use_warmup else lr0
    e = epoch - warmup if use_warmup else epoch

    if hparams.lr_scheduler == "steplr":
        n = sum(1 for m in hparams.decay_step if e >= m)
        return base * hparams.decay_gamma ** n
    if hparams.lr_scheduler == "cosine":
        return eps + (base - eps) * (
            1 + math.cos(math.pi * e / hparams.num_epochs)) / 2
    if hparams.lr_scheduler == "poly":
        return base * (1 - e / hparams.num_epochs) ** hparams.poly_exp
    raise ValueError(f"scheduler not recognized: {hparams.lr_scheduler}")


def build_optimizer(hparams, params: Iterable[torch.Tensor]
                    ) -> torch.optim.Optimizer:
    """sgd or adam over ``params`` at ``hparams.lr``; adam is capturable
    (lr a device tensor) when the parameters lie on the card."""
    eps = 1e-8
    wd = getattr(hparams, "weight_decay", 0.0)
    name = hparams.optimizer
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=hparams.lr,
                               momentum=getattr(hparams, "momentum", 0.0),
                               dampening=0.0, weight_decay=wd)
    if name == "adam":
        if params and params[0].is_cuda:
            return torch.optim.Adam(
                params, lr=torch.tensor(hparams.lr, device=params[0].device),
                eps=eps, weight_decay=wd, capturable=True)
        return torch.optim.Adam(params, lr=hparams.lr, eps=eps,
                                weight_decay=wd)
    if name in ("radam", "ranger"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    raise ValueError(f"optimizer not recognized: {name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group: into the device tensor of a
    capturable optimizer (a fill on the card, which a captured step reads),
    else as the group's float."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def named_leaves(params: Dict[str, Any]) -> List[Tuple[str, torch.Tensor]]:
    """Every parameter tensor of the params dict, named
    ``<key>.<parameter name>`` for modules and ``<key>`` for tables."""
    out = []
    for key, v in params.items():
        if isinstance(v, nn.Module):
            out += [(f"{key}.{n}", p) for n, p in v.named_parameters()]
        else:
            out.append((key, v))
    return out


def make_trainable_mask(params: Dict[str, Any],
                        refine_pose: bool) -> Dict[str, bool]:
    """True = trainable.  Freezes learn_poses.init_c2w always, and the pose
    deltas unless refine_pose."""
    def trainable(name: str) -> bool:
        if name.split(".")[0] == "learn_poses":
            return refine_pose and "init_c2w" not in name
        return True
    return {name: trainable(name) for name, _ in named_leaves(params)}


def trainable_parameters(params: Dict[str, Any],
                         mask: Dict[str, bool]) -> List[torch.Tensor]:
    return [p for name, p in named_leaves(params) if mask[name]]
