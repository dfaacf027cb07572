"""Parameters between the JAX package's pytree and the port's modules.

The JAX tree stores every dense layer as ``{"w": (in, out), "b": (out,)}``;
``nn.Linear`` stores ``weight`` as (out, in), so every weight is transposed
on the way in and out.  The learned-pose table (``learn_poses``: ``r``,
``t`` and ``init_c2w``) crosses as it is.  Both functions take and give
numpy arrays, so this module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .models import init_learn_pose, init_nerf
from .models.mlp import NeRF
from .models.poses import LearnPose
from .render import RenderConfig

_KEYS = ("nerf_coarse", "nerf_fine", "embedding_a", "embedding_t",
         "learn_poses")


def _leaf(t: torch.Tensor, grad: bool) -> np.ndarray:
    if grad:
        t = torch.zeros_like(t) if t.grad is None else t.grad
    return t.detach().cpu().numpy().copy()


def _dense(lin: nn.Linear, grad: bool = False) -> Dict[str, np.ndarray]:
    return {"w": _leaf(lin.weight, grad).T.copy(), "b": _leaf(lin.bias, grad)}


def _seq(node):
    """A list of the JAX tree, or the {"0": ..., "1": ...} dict that flax's
    serialization makes of one."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def _jax_layers(sub):
    """(module path in the port, {"w", "b"}) for each dense layer of one
    field MLP's JAX tree."""
    out = [(f"xyz.{i}", layer) for i, layer in enumerate(_seq(sub["xyz"]))]
    out += [(name, sub[name]) for name in ("xyz_final", "dir",
                                           "static_sigma", "static_rgb")]
    if "transient" in sub:
        tp = sub["transient"]
        out += [(f"transient.layers.{j}", layer)
                for j, layer in enumerate(_seq(tp["layers"]))]
        out += [(f"transient.{name}", tp[name])
                for name in ("sigma", "rgb", "beta")]
    return out


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX param pytree (numpy leaves; lists or flax's str-keyed dicts) ->
    {field: {port parameter name: (out, in) f32 array}, table: f32 array},
    the layout of the port's checkpoints.  No config is needed."""
    unknown = set(tree) - set(_KEYS)
    if unknown:
        raise ValueError(f"not ported yet: {sorted(unknown)}")
    out: Dict[str, Any] = {}
    for key in ("nerf_coarse", "nerf_fine"):
        if key in tree:
            sd = {}
            for path, layer in _jax_layers(tree[key]):
                sd[f"{path}.weight"] = np.asarray(layer["w"], np.float32).T
                sd[f"{path}.bias"] = np.asarray(layer["b"], np.float32)
            out[key] = sd
    for key in ("embedding_a", "embedding_t"):
        if key in tree:
            out[key] = np.asarray(tree[key], np.float32)
    if "learn_poses" in tree:
        out["learn_poses"] = {k: np.asarray(v, np.float32)
                              for k, v in tree["learn_poses"].items()}
    return out


def from_jax_params(tree: Dict[str, Any], cfg: RenderConfig, *,
                    device="cpu") -> Dict[str, Any]:
    """JAX param pytree (numpy leaves, (in, out) weights) -> the port's
    params: NeRF modules for the fields, (N_vocab, dim) f32 ``nn.Parameter``
    tables for the embeddings, a ``LearnPose`` for the pose table.  Shapes
    are checked against ``cfg``."""
    sds = state_dict_from_jax(tree)
    out: Dict[str, Any] = {}
    for key, sd in sds.items():
        if not isinstance(sd, dict):
            out[key] = nn.Parameter(torch.tensor(sd, device=device))
            continue
        if key == "learn_poses":
            table = init_learn_pose(len(sd["r"]), sd.get("init_c2w"),
                                    device=device)
            with torch.no_grad():
                table.r.copy_(torch.from_numpy(sd["r"]))
                table.t.copy_(torch.from_numpy(sd["t"]))
            out[key] = table
            continue
        model = init_nerf(cfg.nerf_config(key.split("_")[1]))
        with torch.no_grad():
            for name, p in model.named_parameters():
                v = torch.tensor(np.asarray(sd[name]))
                if v.shape != p.shape:
                    raise ValueError(f"{key}.{name}: shape {tuple(v.shape)} "
                                     f"does not match {tuple(p.shape)}")
                p.copy_(v)
        out[key] = model.to(device)
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
        elif isinstance(v, LearnPose):
            out[key] = {"r": _leaf(v.r, grads), "t": _leaf(v.t, grads)}
            if v.init_c2w is not None:     # a buffer: never a gradient
                c2w = v.init_c2w.detach().cpu().numpy().copy()
                out[key]["init_c2w"] = np.zeros_like(c2w) if grads else c2w
        else:
            out[key] = _leaf(v, grads)
    return out
