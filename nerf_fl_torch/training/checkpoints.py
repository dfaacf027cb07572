"""Checkpoints: the port's torch format, and the JAX package's msgpack files.

The port writes ``torch.save`` of ``{"state_dict": {submodule: tensors},
"opt_state": optimizer.state_dict(), "epoch", "global_step"}`` atomically
(a temp file, then ``os.replace``) as ``epoch=N.ckpt``.  A submodule is a
field MLP's ``state_dict()`` (``xyz.0.weight``, ...), the pose table's
(``r``, ``t``, ``init_c2w``) or an embedding table's tensor.

``load_checkpoint`` also reads the JAX package's checkpoints (flax's
``msgpack_serialize`` of the same dict), telling the two apart by their
first bytes (a zip archive against a msgpack map), with a msgpack reader
of its own: nil, bool, int, float, str, bin, array, map, and flax's ext
types 1 (ndarray: a msgpack of shape, dtype name and C-order bytes) and 3
(numpy scalar).  flax's chunked big-array leaves raise.  The JAX params
come out in the port's layout (``bridge.state_dict_from_jax``); a JAX
``opt_state`` is kept as read, and ``opt_state_from_jax`` turns the
state of its optax chain (sgd, adam, radam, ranger) into the port
optimizer's.

The other functions are the counterparts of the JAX package's
(``nerf_fl_tpu/training/checkpoints.py``): ``latest_checkpoint``,
``extract_model_state_dict``, ``load_ckpt`` and ``load_into`` (non-strict,
honouring ``prefixes_to_ignore`` against the port's parameter names).
"""
from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..bridge import state_dict_from_jax

# ----------------------------------------------------------------------
# msgpack, as flax writes it
# ----------------------------------------------------------------------


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = msgpack_unpack(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


class _Unpacker:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = data, 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == 1:
            return _ndarray(payload)
        if code == 3:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack ext type {code} is not one flax writes "
                         f"for a checkpoint (1 ndarray, 3 numpy scalar)")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}         # bin
        if b in lengths:
            return self.take(self.unpack(lengths[b]))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.string(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return self.ext(code, fixext[b])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            n = self.unpack(exts[b])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not "
                         f"a msgpack type")


def msgpack_unpack(data: bytes, raw: bool = False):
    """One msgpack object; str as str (bytes with ``raw``)."""
    u = _Unpacker(data, raw)
    out = u.value()
    if u.pos != len(data):
        raise ValueError(f"{len(data) - u.pos} bytes after the msgpack object")
    return out


def msgpack_restore(data: bytes):
    """flax's ``serialization.msgpack_restore``: the nested dicts and
    lists with numpy leaves."""
    tree = msgpack_unpack(data)

    def check(t):
        if isinstance(t, dict):
            if "__msgpack_chunked_array__" in t:
                raise NotImplementedError(
                    "flax's chunked array leaves (arrays of 2^30 bytes or "
                    "more) are not read by the port")
            for v in t.values():
                check(v)
        elif isinstance(t, list):
            for v in t:
                check(v)

    check(tree)
    return tree


# ----------------------------------------------------------------------
# the port's format
# ----------------------------------------------------------------------

def state_dict_of(params: Dict[str, Any]) -> Dict[str, Any]:
    """{submodule: its state_dict (modules) or tensor (tables)}, on the CPU."""
    out = {}
    for key, v in params.items():
        if isinstance(v, nn.Module):
            out[key] = {k: t.detach().cpu().clone()
                        for k, t in v.state_dict().items()}
        else:
            out[key] = v.detach().cpu().clone()
    return out


def save_checkpoint(path: str, params: Dict[str, Any],
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    epoch: int = 0, global_step: int = 0) -> None:
    """Write a single-file checkpoint, atomically."""
    state: Dict[str, Any] = {"state_dict": state_dict_of(params),
                             "epoch": int(epoch),
                             "global_step": int(global_step)}
    if optimizer is not None:
        state["opt_state"] = optimizer.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """Either format, as {"state_dict": {submodule: {name: tensor} or
    tensor}, "epoch", "global_step", ["opt_state"], "format": "torch" |
    "jax"}.  A JAX ``opt_state`` stays the JAX tree (numpy leaves)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(b"PK\x03\x04"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        ckpt["format"] = "torch"
        return ckpt
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        sd = tree.get("state_dict", tree)
        out = {"state_dict": _tensors(state_dict_from_jax(sd)),
               "epoch": int(tree.get("epoch", -1)),
               "global_step": int(tree.get("global_step", 0)),
               "format": "jax"}
        if "opt_state" in tree:
            out["opt_state"] = tree["opt_state"]
        return out
    raise ValueError(f"{path}: neither a torch checkpoint (zip) nor a JAX "
                     f"one (msgpack map)")


def _tensors(sd):
    return {k: ({n: torch.from_numpy(np.ascontiguousarray(a))
                 for n, a in v.items()} if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in sd.items()}


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest epoch=N.ckpt in a directory, or None; by epoch number, not
    mtime (a re-saved older checkpoint must not win)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.match(r"epoch=(\d+)\.ckpt$", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


def _flat(sub) -> Dict[str, torch.Tensor]:
    return dict(sub) if isinstance(sub, dict) else {"": sub}


def extract_model_state_dict(ckpt_path: str, model_name: str = "model",
                             prefixes_to_ignore: Sequence[str] = ()) -> Dict:
    """Flat {name: tensor} of one submodule, prefixes filtered out."""
    sd = load_checkpoint(ckpt_path)["state_dict"]
    if model_name not in sd:
        return {}
    out = {}
    for k, v in _flat(sd[model_name]).items():
        if any(k.startswith(p) for p in prefixes_to_ignore):
            print("ignore", k)
            continue
        out[k] = v
    return out


def _replace(sub, wanted: Dict[str, torch.Tensor], model_name: str):
    """Copy ``wanted``'s tensors into ``sub``'s parameters and buffers (the
    pose table's ``init_c2w``) of the same name, in place; absent names
    keep their values (non-strict)."""
    if isinstance(sub, nn.Module):
        named = dict(sub.named_parameters())
        named.update(sub.named_buffers())
    else:
        named = {"": sub}
    with torch.no_grad():
        for name, p in named.items():
            if name in wanted:
                v = wanted[name]
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(
                        f"shape mismatch for {model_name}.{name}: ckpt "
                        f"{tuple(v.shape)} vs model {tuple(p.shape)}")
                p.copy_(v.to(p.dtype))
    return sub


def load_ckpt(params_sub, ckpt_path: str, model_name: str = "model",
              prefixes_to_ignore: Sequence[str] = ()):
    """Non-strict load of one submodule (a module or a table), in place."""
    wanted = extract_model_state_dict(ckpt_path, model_name,
                                      prefixes_to_ignore)
    return _replace(params_sub, wanted, model_name) if wanted else params_sub


def load_into(params: Dict[str, Any], ckpt: Dict,
              prefixes_to_ignore: Sequence[str] = ()) -> Dict[str, Any]:
    """Non-strict whole-tree load from a read checkpoint, in place: every
    submodule in both replaces its matching tensors; missing submodules or
    tensors and ignored prefixes (a submodule's name, or a tensor's name
    with or without the submodule's in front) keep their values."""
    sd = ckpt.get("state_dict", ckpt)
    for name, sub in params.items():
        if name not in sd:
            continue
        if any(name.startswith(p) for p in prefixes_to_ignore):
            print("ignore submodule", name)
            continue
        flat = {}
        for k, v in _flat(sd[name]).items():
            if any(k.startswith(p) or f"{name}.{k}".startswith(p)
                   for p in prefixes_to_ignore):
                print("ignore", f"{name}.{k}")
                continue
            flat[k] = v
        _replace(sub, flat, name)
    return params


def _find_state(tree, fields):
    """The first dict of a JAX opt_state (depth first) that holds every key
    of ``fields``: optax's ScaleByAdamState (count, mu, nu), which
    ``scale_by_radam_torch`` also keeps, TraceState (trace) or Ranger's
    LookaheadState (slow, count)."""
    if isinstance(tree, dict):
        if set(fields) <= set(tree):
            return tree
        for v in tree.values():
            found = _find_state(v, fields)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, optimizer: torch.optim.Optimizer,
                       named: Dict[str, torch.Tensor]) -> None:
    """Set ``optimizer`` to the state of the JAX package's optax chain for
    every parameter it holds; ``named`` maps the port's names
    (``named_leaves``) to those parameters.

      * ``torch.optim.Adam``: ``mu`` / ``nu`` / ``count`` of
        ``scale_by_adam`` as ``exp_avg`` / ``exp_avg_sq`` / ``step``;
      * ``RAdam``: the same three of ``scale_by_radam_torch``; ``Ranger``
        also the lookahead's slow weights as ``slow_buffer``.  The port's
        Ranger syncs on its RAdam step, so the lookahead's count must stand
        at the same place in its sync period (both count every step);
      * ``SGD``: ``trace``'s buffer as ``momentum_buffer`` (no state
        without momentum).
    """
    from .optimizers import SGD, RAdam, Ranger
    held = [p for g in optimizer.param_groups for p in g["params"]]
    ids = {id(p) for p in held}
    mine = {name: p for name, p in named.items() if id(p) in ids}

    def trees(state, keys):
        return [_named(state_dict_from_jax(state[k])) for k in keys]

    if isinstance(optimizer, SGD):
        if optimizer.param_groups[0]["momentum"] <= 0:
            return
        trace = _find_state(opt_state, ("trace",))
        if trace is None:
            raise ValueError("the JAX opt_state holds no momentum trace")
        (buf,) = trees(trace, ("trace",))
        for name, p in mine.items():
            optimizer.state[p] = {"momentum_buffer": _on(buf[name], p)}
        return
    if not (type(optimizer) is torch.optim.Adam
            or isinstance(optimizer, RAdam)):
        raise NotImplementedError(
            f"resuming {type(optimizer).__name__} from a JAX opt_state is "
            f"not ported")
    adam = _find_state(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("the JAX opt_state holds no Adam / RAdam state")
    mu, nu = trees(adam, ("mu", "nu"))
    count = float(np.asarray(adam["count"]))
    slow = None
    if isinstance(optimizer, Ranger):
        look = _find_state(opt_state, ("slow", "count"))
        if look is None:
            raise ValueError("the JAX opt_state holds no lookahead state")
        k = optimizer.param_groups[0]["k"]
        if int(np.asarray(look["count"])) % k != int(count) % k:
            raise ValueError(
                f"the lookahead count {int(np.asarray(look['count']))} and "
                f"the RAdam count {int(count)} stand at different places "
                f"of the sync period {k}")
        (slow,) = trees(look, ("slow",))
    on_card = isinstance(optimizer, RAdam) or \
        optimizer.param_groups[0].get("capturable", False)
    for name, p in mine.items():
        st = {"step": torch.tensor(count, dtype=torch.float32,
                                   device=p.device if on_card else "cpu"),
              "exp_avg": _on(mu[name], p), "exp_avg_sq": _on(nu[name], p)}
        if slow is not None:
            st["slow_buffer"] = _on(slow[name], p)
        optimizer.state[p] = st


def _on(a: np.ndarray, p: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(p.device, p.dtype)


def _named(sd) -> Dict[str, np.ndarray]:
    out = {}
    for key, v in sd.items():
        if isinstance(v, dict):
            out.update({f"{key}.{n}": np.ascontiguousarray(a)
                        for n, a in v.items()})
        else:
            out[key] = np.ascontiguousarray(v)
    return out
