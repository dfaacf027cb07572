"""Test-time appearance optimization (the NeRF-W paper's eval protocol).

Counterpart of ``nerf_fl_tpu/render/appearance.py``.  A held-out image's
appearance id has an embedding row that training never fit, so its score
is limited by a random vector.  The protocol fits that one (N_a,) vector
to half of the image with the weights frozen and scores the other half.

JAX runs the fit as one ``lax.scan`` of Adam steps.  The port loops eager
steps: each renders the rays (deterministic sampling, no transient field),
takes the gradient of the fine rgb MSE with respect to the vector alone
(``torch.autograd.grad``, so no weight's ``.grad`` is touched) and steps
``torch.optim.Adam``.  On the card a step runs the fused forward twice
(coarse and fine pass) and the fused backward once (the fine pass: the
coarse pass feeds the fine samples through detached weights only); the
backward kernel's weight gradients are computed and dropped.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .renderer import RenderConfig, render_rays


def optimize_appearance(params, rays, ts, rgbs, cfg: RenderConfig, *,
                        steps: int = 100, lr: float = 0.1,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit one appearance embedding to (rays, rgbs) with frozen weights.

    Returns (the fitted (N_a,) vector, the (steps,) loss curve), both f32
    on the params' device; loss k is the MSE before step k.  The start is
    row ``ts[0]`` of ``embedding_a``, so zero steps keep the unoptimized
    render.  ``rays`` (N, 8), ``ts`` (N,) and ``rgbs`` (N, 3) may be numpy
    or tensors; they are moved to ``device`` (None: the params')."""
    from ..training.system import params_device
    dev = params_device(params) if device is None else torch.device(device)
    cfg = cfg.eval_variant()
    typ = "fine" if cfg.N_importance > 0 else "coarse"

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(dev, dtype)

    rays, rgbs = on_dev(rays, torch.float32), on_dev(rgbs, torch.float32)
    ts = on_dev(ts, torch.int64)
    table = params["embedding_a"]
    a = table.detach()[int(ts[0])].clone().requires_grad_()
    opt = torch.optim.Adam([a], lr=lr, eps=1e-8)
    losses = []
    for _ in range(int(steps)):
        res = render_rays(params, rays, ts, cfg,
                          a_embedded=a.expand(len(rays), a.shape[-1]),
                          output_transient=False)
        loss = torch.mean((res[f"rgb_{typ}"] - rgbs) ** 2)
        a.grad, = torch.autograd.grad(loss, [a])
        opt.step()
        losses.append(loss.detach())
    curve = torch.stack(losses) if losses else torch.zeros(0, device=dev)
    return a.detach(), curve
