"""Optimizers and the per-epoch learning-rate schedule.

Counterpart of ``nerf_fl_tpu/training/optimizers.py``:
  * ``lr_for_epoch``: steplr (MultiStepLR), cosine (CosineAnnealingLR,
    eta_min 1e-8) and poly, each optionally behind a linear warmup over
    ``warmup_epochs`` (skipped for radam/ranger), stepped per epoch;
    ``mip_lr``: mip-NeRF's delayed log-linear decay by the step (no JAX
    counterpart; ``--lr_scheduler mip``, set per call of the step);
  * ``build_optimizer``: ``SGD`` (the JAX package's sgd chain written out
    here: weight decay added to the gradient, then optax's ``trace``,
    heavy-ball momentum with dampening 0), ``torch.optim.Adam`` with eps
    1e-8, which makes the same update as the JAX package's optax chain
    (weight decay is L2 added to the gradient), and ``RAdam`` / ``Ranger``,
    the JAX package's ``scale_by_radam_torch`` chains written out here
    (torch_optimizer's and pytorch_ranger's arithmetic).  The scheduled lr
    is written into ``param_groups`` before each step (``set_lr``).

On the card Adam is built ``capturable``, with its lr a device tensor, so
that a CUDA graph of the train step (``system.make_train_step`` with
``steps_per_execution`` > 1) replays it: ``set_lr`` fills that tensor, and
the step count and bias corrections stay on the card.  SGD, RAdam and
Ranger are capturable everywhere and take a device lr on the card: their
state (the momentum buffer; the step count beside the parameter) lives on
the device, the rectification branch and the lookahead sync are a
``torch.where`` on it, and nothing is read back to the host.  On the CPU
every optimizer takes a Python float lr.
``param_groups`` puts the learned pose deltas in a group of their own, the
one whose updates the train step scales (``--pose_lr_mult``, the warmup).
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


def mip_lr(step: int, lr_init: float = 5e-4, lr_final: float = 5e-6,
           max_steps: int = 1_000_000, delay_steps: int = 2500,
           delay_mult: float = 0.01) -> float:
    """mip-NeRF's ``learning_rate_decay`` (internal/math.py) at ``step``:
    log-linear from ``lr_init`` to ``lr_final`` over ``max_steps``, times
    the delay ``delay_mult + (1 - delay_mult) sin(pi / 2 clip(step /
    delay_steps, 0, 1))`` (Config's Blender values by default)."""
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient; a ``None`` grad counts as zeros, as every leaf of
    the JAX tree gets a gradient."""
    return torch.zeros_like(p) if p.grad is None else p.grad


class SGD(torch.optim.Optimizer):
    """The JAX package's sgd: ``add_decayed_weights(wd)`` (the decay added
    to the gradient before any momentum), then ``optax.trace(momentum)``
    (``t = g + momentum * t``, from ``t = 0``: heavy-ball momentum with
    dampening 0, no Nesterov), then ``-lr * t``; without momentum the
    update is ``-lr * g``.  Capturable: the lr may be a device tensor and
    the buffer is updated in place."""

    def __init__(self, params, lr=1e-3, momentum=0.0, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      capturable=True))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            wd, mom = group["weight_decay"], group["momentum"]
            for p in group["params"]:
                g = _grad(p)
                if wd > 0:
                    g = g + wd * p
                if mom > 0:
                    st = self.state[p]
                    if not st:
                        st["momentum_buffer"] = torch.zeros_like(p)
                    g = st["momentum_buffer"].mul_(mom).add_(g)
                p.add_(-group["lr"] * g)
        return loss


class RAdam(torch.optim.Optimizer):
    """Rectified Adam in torch_optimizer's arithmetic: the update of the
    JAX package's ``scale_by_radam_torch`` (then decoupled weight decay,
    then ``-lr``), in float32 and in the same order of operations.

    torch divides by ``sqrt(v) + eps`` and folds the ``sqrt(1 - b2^t)``
    bias correction into the step size, unlike optax's ``scale_by_radam``.
    A step is rectified when ``rho_t >= threshold`` (``rho_t > threshold``
    with ``strict``, pytorch_ranger's test); below it the update is
    bias-corrected momentum.  ``Ranger`` adds gradient centralisation and
    lookahead.  A ``None`` grad counts as zeros, as every leaf of the JAX
    tree gets a gradient.
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, threshold=5.0, strict=False):
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            threshold=threshold, strict=strict, capturable=True))

    def _init_state(self, p):
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    @staticmethod
    def _factors(t, b1, b2, threshold, strict):
        """(rectified, r / (1 - b1^t), 1 - b1^t) as f32 tensors of step t."""
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t, b1t = torch.pow(b2, t), torch.pow(b1, t)
        ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
        rect = ro > threshold if strict else ro >= threshold
        r = torch.sqrt(torch.clamp(
            (1.0 - b2t) * (ro - 4.0) * (ro - 2.0) * ro_inf
            / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro), min=0.0))
        return rect, r / (1.0 - b1t), 1.0 - b1t

    def _direction(self, p, g, group):
        """The pre-lr update of ``p`` for grad ``g`` (the state advanced)."""
        b1, b2 = group["betas"]
        st = self._init_state(p)
        m, v = st["exp_avg"], st["exp_avg_sq"]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((1 - b2) * g * g)
        st["step"].add_(1.0)
        rect, scale, bc1 = self._factors(st["step"], b1, b2,
                                         group["threshold"], group["strict"])
        u = torch.where(rect, scale * m / (torch.sqrt(v) + group["eps"]),
                        m / bc1)
        if group["weight_decay"] > 0:
            u = u + group["weight_decay"] * p
        return u

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                u = self._direction(p, _grad(p), group)
                p.add_(-group["lr"] * u)
        return loss


class Ranger(RAdam):
    """pytorch_ranger's Ranger as the JAX package builds it: gradient
    centralisation, RAdam (betas (0.95, 0.999), the strict ``rho > 5``
    test), decoupled weight decay, then lookahead (``k`` = 6, ``alpha`` =
    0.5) on the final post-lr deltas.

    Centralisation subtracts the mean over every dim but the first of each
    >= 2-D grad: the fan-in of an ``nn.Linear`` weight (out, in), which is
    the JAX kernel's (in, out) axis 0, and the width of an embedding table.
    Lookahead counts with the RAdam step; at every k-th step the slow
    weights take ``alpha`` of the fast weights' excursion and the fast
    weights are set to them (the JAX ``lookahead``'s ``p + (slow - p)``).
    """

    def __init__(self, params, lr=1e-3, betas=(0.95, 0.999), eps=1e-8,
                 weight_decay=0.0, k=6, alpha=0.5):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, threshold=5.0,
                         strict=True)
        for group in self.param_groups:
            group.setdefault("k", k)
            group.setdefault("alpha", alpha)

    def _init_state(self, p):
        st = self.state[p]
        if not st:
            super()._init_state(p)
            st["slow_buffer"] = p.detach().clone()
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                g = _grad(p)
                if g.dim() >= 2:
                    g = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                d = -group["lr"] * self._direction(p, g, group)
                st = self.state[p]
                sync = torch.remainder(st["step"], group["k"]) == 0
                slow = st["slow_buffer"]
                new_slow = torch.where(sync, slow + group["alpha"]
                                       * ((p + d) - slow), slow)
                p.add_(torch.where(sync, new_slow - p, d))
                slow.copy_(new_slow)
        return loss


def build_optimizer(hparams, params: Iterable) -> torch.optim.Optimizer:
    """sgd, adam, radam or ranger over ``params`` (tensors, or param groups
    as ``param_groups`` makes them) at ``hparams.lr``; adam is capturable
    (lr a device tensor) when the parameters lie on the card, sgd, radam
    and ranger take a device lr there."""
    eps = 1e-8
    wd = getattr(hparams, "weight_decay", 0.0)
    name = hparams.optimizer
    params = list(params)
    tensors = [p for g in params for p in g["params"]] \
        if params and isinstance(params[0], dict) else params
    cuda = bool(tensors) and tensors[0].is_cuda
    lr = torch.tensor(hparams.lr, device=tensors[0].device) if cuda \
        else hparams.lr
    if name == "sgd":
        return SGD(params, lr=lr, momentum=getattr(hparams, "momentum", 0.0),
                   weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, eps=eps, weight_decay=wd,
                                capturable=cuda)
    if name in ("radam", "ranger"):
        cls = RAdam if name == "radam" else Ranger
        return cls(params, lr=lr, eps=eps, weight_decay=wd)
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


def param_groups(params: Dict[str, Any],
                 mask: Dict[str, bool]) -> List[Dict[str, Any]]:
    """The trainable tensors as optimizer param groups: the learned pose
    deltas (``learn_poses.r`` / ``.t``), when trainable, in a group of
    their own marked ``"pose": True``, whose updates the train step scales
    by ``--pose_lr_mult`` and the warmup (``system._train_body``); the rest
    in one group."""
    rest, poses = [], []
    for name, p in named_leaves(params):
        if mask[name]:
            (poses if name.split(".")[0] == "learn_poses" else rest).append(p)
    return [{"params": rest}] + ([{"params": poses, "pose": True}]
                                 if poses else [])
