"""The NeRF-W MLP as an ``nn.Module`` plus its plain forward, and with the
skip and the heads of mip-NeRF (``skip_order`` "hidden_first") its field.

Counterpart of ``nerf_fl_tpu/models/mlp.py``.  Layer names follow the JAX
parameter tree (``xyz.0..7``, ``xyz_final``, ``dir``, ``static_sigma``,
``static_rgb``, ``transient.layers.0..3``, ``transient.sigma/rgb/beta``).
Weights use ``nn.Linear``'s (out, in) layout; ``bridge.from_jax_params``
transposes the JAX (in, out) arrays.

``apply_nerf`` keeps the JAX path's rounding points: every hidden matmul is
rounded to the compute dtype before the bias (also rounded) is added,
concatenated operands are contracted per part and summed in the compute
dtype (``_dense_cat``), per-ray conditioning is contracted per ray and
broadcast-added (``_dense_ray_cond``), and the heads emit f32.  It serves
the test-time coarse ``sigma_only`` pass where the sigma-only kernel does
not (bf16, or under autograd), tensor-parallel models, every pass on CPU
tensors unless the fused path is asked for, and every architecture the
fused kernels do not take.

Under tensor parallelism (``parallel.mesh.place_params``) a layer holds a
shard of its weight and carries a ``tp`` attribute: a column-parallel
layer's ``tp.enter`` copies its input to the model ranks (its backward
sums their input gradients) and its output is a shard of the features; a
row-parallel layer contracts that shard and ``tp.leave`` sums the partial
products over the model ranks before its bias.  The trunk alternates the
two from layer 0 (the skip at 4 is column-parallel), and a sharded output
is gathered (``tp.gather``) before the heads.  Without ``tp`` the
functions below are the plain ones.

mip-NeRF's MLP (Barron et al. 2021, google/mipnerf internal/models.py:MLP)
is the same module: its trunk concatenates [h, enc] after layer 4's ReLU
(``skips`` (5,), ``skip_order`` "hidden_first"), its density and
bottleneck are ``static_sigma`` and ``xyz_final``, its condition layer
``dir`` (on [bottleneck | PE(view direction)]) and its rgb layer
``static_rgb``; ``apply_nerf(..., raw=True)`` returns the pre-activations
and ``mip_heads`` applies mip-NeRF's activations.  ``init_nerf(...,
init="glorot")`` draws its initialisation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class NeRFConfig:
    typ: str = "coarse"
    D: int = 8
    W: int = 256
    skips: Tuple[int, ...] = (4,)
    in_channels_xyz: int = 63
    in_channels_dir: int = 27
    encode_appearance: bool = False
    in_channels_a: int = 48
    encode_transient: bool = False
    in_channels_t: int = 16
    beta_min: float = 0.03
    # the skip layer's input: [encoding | h] (nerf_pl's, "input_first") or
    # [h | encoding] (mip-NeRF's, "hidden_first")
    skip_order: str = "input_first"

    def __post_init__(self):
        if self.skip_order not in ("input_first", "hidden_first"):
            raise ValueError(f"skip_order {self.skip_order!r}")
        # the coarse model drops appearance/transient conditioning
        if self.typ == "coarse":
            object.__setattr__(self, "encode_appearance", False)
            object.__setattr__(self, "encode_transient", False)

    @property
    def a_dim(self) -> int:
        return self.in_channels_a if self.encode_appearance else 0


class TransientBranch(nn.Module):
    def __init__(self, cfg: NeRFConfig, device=None):
        super().__init__()
        h = cfg.W // 2
        self.layers = nn.ModuleList(
            [nn.Linear(cfg.W + cfg.in_channels_t, h, device=device)]
            + [nn.Linear(h, h, device=device) for _ in range(3)])
        self.sigma = nn.Linear(h, 1, device=device)
        self.rgb = nn.Linear(h, 3, device=device)
        self.beta = nn.Linear(h, 1, device=device)


class NeRF(nn.Module):
    def __init__(self, cfg: NeRFConfig, device=None):
        super().__init__()
        self.cfg = cfg
        fan_in = [cfg.in_channels_xyz if i == 0 else (
            cfg.W + cfg.in_channels_xyz if i in cfg.skips else cfg.W)
            for i in range(cfg.D)]
        self.xyz = nn.ModuleList(
            [nn.Linear(f, cfg.W, device=device) for f in fan_in])
        self.xyz_final = nn.Linear(cfg.W, cfg.W, device=device)
        self.dir = nn.Linear(cfg.W + cfg.in_channels_dir + cfg.a_dim,
                             cfg.W // 2, device=device)
        self.static_sigma = nn.Linear(cfg.W, 1, device=device)
        self.static_rgb = nn.Linear(cfg.W // 2, 3, device=device)
        self.transient = (TransientBranch(cfg, device)
                          if cfg.encode_transient else None)

    def forward(self, xyz_emb, dir_a_emb=None, t_emb=None, **kw):
        return apply_nerf(self, xyz_emb, dir_a_emb, t_emb, **kw)


def init_nerf(cfg: NeRFConfig, *, generator: Optional[torch.Generator] = None,
              device=None, init: str = "torch") -> NeRF:
    """``init`` "torch": ``nn.Linear``'s default, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weight and bias; "glorot": mip-NeRF's (flax's
    glorot_uniform kernels, U(-a, a) with a = sqrt(6 / (fan_in +
    fan_out)), and zero biases).  Drawn from ``generator``."""
    if init not in ("torch", "glorot"):
        raise ValueError(f"init {init!r}")
    model = NeRF(cfg, device=device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                if init == "glorot":
                    a = (6.0 / (m.in_features + m.out_features)) ** 0.5
                    m.weight.uniform_(-a, a, generator=generator)
                    m.bias.zero_()
                    continue
                bound = 1.0 / m.in_features ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
    return model


class _Softplus(torch.autograd.Function):
    """The forward of ``jax.nn.softplus`` = logaddexp(x, 0), written the
    same way, with its gradient sigmoid(x) everywhere.  (Autograd of the
    forward formula gives 1 at x = 0, through clamp and abs; JAX's
    logaddexp JVP gives 0.5.)"""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.sigmoid(x) * g


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: forward and gradient."""
    return _Softplus.apply(x)


def _mm(x, w_t, out_dtype):
    """x @ w_t with f32 accumulation, rounded once to ``out_dtype`` (a bf16
    matmul accumulates in f32 and rounds its result)."""
    if x.dtype == out_dtype:
        return x @ w_t
    return (x.float() @ w_t.float()).to(out_dtype)


def _tp_kind(layer: nn.Linear):
    """'col' or 'row' for a tensor-parallel layer, else None."""
    tp = getattr(layer, "tp", None)
    return None if tp is None else tp.kind


def _dense(x, layer: nn.Linear, dt, out_dtype=None):
    od = out_dtype or dt
    w = layer.weight.to(dt).t()
    tp = getattr(layer, "tp", None)
    if tp is None:
        return _mm(x.to(dt), w, od) + layer.bias.to(od)
    return tp.leave(_mm(tp.enter(x).to(dt), w, od)) + layer.bias.to(od)


def _dense_cat(parts, layer: nn.Linear, dt, out_dtype=None):
    od = out_dtype or dt
    w = layer.weight.to(dt).t()
    tp = getattr(layer, "tp", None)
    acc, lo = None, 0
    for p in parts:
        hi = lo + p.shape[-1]
        if tp is not None:
            p = tp.enter(p)
        y = _mm(p.to(dt), w[lo:hi], od)
        acc = y if acc is None else acc + y
        lo = hi
    return acc + layer.bias.to(od)


def _dense_ray_cond(x_sample, x_ray, samples_per_ray, layer: nn.Linear, dt):
    w = layer.weight.to(dt).t()
    tp = getattr(layer, "tp", None)
    if tp is not None:
        x_sample, x_ray = tp.enter(x_sample), tp.enter(x_ray)
    cs = x_sample.shape[-1]
    y_s = _mm(x_sample.to(dt), w[:cs], dt)
    y_r = _mm(x_ray.to(dt), w[cs:], dt) + layer.bias.to(dt)
    n = x_ray.shape[0]
    out = y_s.reshape(n, samples_per_ray, -1) + y_r[:, None, :]
    return out.reshape(n * samples_per_ray, -1)


def _gathered(y, layer: nn.Linear):
    """The whole features of ``layer``'s output: a column-parallel layer's
    shard gathered from the model ranks, else ``y``."""
    return layer.tp.gather(y) if _tp_kind(layer) == "col" else y


def apply_nerf(model: NeRF, xyz_emb: torch.Tensor,
               dir_a_emb: Optional[torch.Tensor] = None,
               t_emb: Optional[torch.Tensor] = None, *,
               sigma_only: bool = False, output_transient: bool = False,
               compute_dtype=torch.float32,
               samples_per_ray: Optional[int] = None, raw: bool = False
               ) -> Dict[str, torch.Tensor]:
    """Plain forward returning named heads (static_sigma (B,), static_rgb
    (B, 3), transient_sigma/rgb/beta).  With ``samples_per_ray`` the
    conditioning inputs dir_a_emb / t_emb are per ray.  ``raw``: the
    pre-activations of density and rgb instead, {"raw_sigma" (B,),
    "raw_rgb" (B, 3)} in f32 (mip-NeRF's heads are ``mip_heads``)."""
    cfg, dt, f32 = model.cfg, compute_dtype, torch.float32
    xyz_c = xyz_emb.to(dt)
    h = xyz_c
    for i, layer in enumerate(model.xyz):
        if i in cfg.skips:
            h = _dense_cat([xyz_c, h] if cfg.skip_order == "input_first"
                           else [h, xyz_c], layer, dt)
        else:
            h = _dense(h, layer, dt)
        h = torch.relu(h)
    h = _gathered(h, model.xyz[-1])    # an odd depth ends column-parallel

    raw_sigma = _dense(h, model.static_sigma, dt, out_dtype=f32)[..., 0]
    out = {"static_sigma": softplus(raw_sigma)}
    if sigma_only:
        return out

    xyz_final = _gathered(_dense(h, model.xyz_final, dt), model.xyz_final)
    if samples_per_ray is None:
        dir_h = torch.relu(_dense_cat([xyz_final, dir_a_emb], model.dir, dt))
    else:
        dir_h = torch.relu(_dense_ray_cond(
            xyz_final, dir_a_emb, samples_per_ray, model.dir, dt))
    dir_h = _gathered(dir_h, model.dir)
    raw_rgb = _dense(dir_h, model.static_rgb, dt, out_dtype=f32)
    if raw:
        return {"raw_sigma": raw_sigma, "raw_rgb": raw_rgb}
    out["static_rgb"] = torch.sigmoid(raw_rgb)
    if not output_transient:
        return out

    tp = model.transient
    first, rest = tp.layers[0], tp.layers[1:]
    if samples_per_ray is None:
        th = torch.relu(_dense_cat([xyz_final, t_emb], first, dt))
    else:
        th = torch.relu(_dense_ray_cond(xyz_final, t_emb, samples_per_ray,
                                        first, dt))
    for layer in rest:
        th = torch.relu(_dense(th, layer, dt))
    out["transient_sigma"] = softplus(
        _dense(th, tp.sigma, dt, out_dtype=f32))[..., 0]
    out["transient_rgb"] = torch.sigmoid(_dense(th, tp.rgb, dt, out_dtype=f32))
    out["transient_beta"] = softplus(
        _dense(th, tp.beta, dt, out_dtype=f32))[..., 0]
    return out


def mip_heads(raw_sigma: torch.Tensor, raw_rgb: torch.Tensor, *,
              density_bias: float = -1.0, rgb_padding: float = 0.001):
    """mip-NeRF's activations (``MipNerfModel``): density softplus(raw +
    density_bias) and rgb sigmoid(raw) (1 + 2 rgb_padding) - rgb_padding.
    Returns (sigma, rgb)."""
    sigma = softplus(raw_sigma + density_bias)
    rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * rgb_padding) - rgb_padding
    return sigma, rgb


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
