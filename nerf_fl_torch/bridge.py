"""Parameters between the JAX package's pytree and the port's modules.

The JAX tree stores every dense layer as ``{"w": (in, out), "b": (out,)}``;
``nn.Linear`` stores ``weight`` as (out, in), so every weight is transposed
on the way in and out.  Both functions take and give numpy arrays, so this
module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .models import init_nerf
from .models.mlp import NeRF
from .render import RenderConfig

_KEYS = ("nerf_coarse", "nerf_fine", "embedding_a", "embedding_t")


def _linears(model: NeRF):
    """(path in the JAX tree, nn.Linear) pairs of one field MLP."""
    out = [(("xyz", i), lin) for i, lin in enumerate(model.xyz)]
    out += [(("xyz_final",), model.xyz_final), (("dir",), model.dir),
            (("static_sigma",), model.static_sigma),
            (("static_rgb",), model.static_rgb)]
    if model.transient is not None:
        tp = model.transient
        out += [(("transient", "layers", j), lin)
                for j, lin in enumerate(tp.layers)]
        out += [(("transient", name), getattr(tp, name))
                for name in ("sigma", "rgb", "beta")]
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _leaf(t: torch.Tensor, grad: bool) -> np.ndarray:
    if grad:
        t = torch.zeros_like(t) if t.grad is None else t.grad
    return t.detach().cpu().numpy().copy()


def _dense(lin: nn.Linear, grad: bool = False) -> Dict[str, np.ndarray]:
    return {"w": _leaf(lin.weight, grad).T.copy(), "b": _leaf(lin.bias, grad)}


def from_jax_params(tree: Dict[str, Any], cfg: RenderConfig, *,
                    device="cpu") -> Dict[str, Any]:
    """JAX param pytree (numpy leaves, (in, out) weights) -> the port's
    params: NeRF modules for the fields, (N_vocab, dim) f32 ``nn.Parameter``
    tables for the embeddings.  Shapes are checked against ``cfg``."""
    unknown = set(tree) - set(_KEYS)
    if unknown:
        raise ValueError(f"not ported yet: {sorted(unknown)}")
    out: Dict[str, Any] = {}
    for key in ("nerf_coarse", "nerf_fine"):
        if key not in tree:
            continue
        model = init_nerf(cfg.nerf_config(key.split("_")[1]))
        with torch.no_grad():
            for path, lin in _linears(model):
                layer = _get(tree[key], path)
                w = torch.tensor(np.asarray(layer["w"], np.float32).T)
                b = torch.tensor(np.asarray(layer["b"], np.float32))
                if w.shape != lin.weight.shape or b.shape != lin.bias.shape:
                    raise ValueError(
                        f"{key}.{path}: shape {tuple(w.shape)} does not "
                        f"match {tuple(lin.weight.shape)}")
                lin.weight.copy_(w)
                lin.bias.copy_(b)
        out[key] = model.to(device)
    for key in ("embedding_a", "embedding_t"):
        if key in tree:
            out[key] = nn.Parameter(torch.tensor(
                np.asarray(tree[key], np.float32), device=device))
    return out


def to_numpy_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> the JAX layout with numpy leaves."""
    return _numpy_tree(params, grads=False)


def grads_to_numpy_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's ``.grad`` (zeros where it is None) in the JAX gradient
    tree's layout, numpy, so tests compare gradients leaf for leaf."""
    return _numpy_tree(params, grads=True)


def _numpy_tree(params: Dict[str, Any], grads: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in params.items():
        if isinstance(v, NeRF):
            sub = {"xyz": [_dense(lin, grads) for lin in v.xyz]}
            for name in ("xyz_final", "dir", "static_sigma", "static_rgb"):
                sub[name] = _dense(getattr(v, name), grads)
            if v.transient is not None:
                tp = v.transient
                sub["transient"] = {
                    "layers": [_dense(lin, grads) for lin in tp.layers],
                    **{n: _dense(getattr(tp, n), grads)
                       for n in ("sigma", "rgb", "beta")}}
            out[key] = sub
        else:
            out[key] = _leaf(v, grads)
    return out
