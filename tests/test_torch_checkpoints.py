"""The port's checkpoints against the JAX package's.

  * the standard-library msgpack reader against
    ``flax.serialization.msgpack_restore`` on checkpoints that the JAX
    package writes (a full one with an Adam / a Ranger ``opt_state``, and a
    weights-only one), leaf for leaf: same tree, dtypes and values; and on
    every msgpack type flax can write (ints of each width, floats, strings
    and bins of each length class, long arrays and maps, ext 1 and 3);
  * ``load_checkpoint`` of a JAX file gives the JAX params in the port's
    layout (the bridge's), and a torch round trip gives back the tensors
    and the optimizer state;
  * ``latest_checkpoint`` and ``load_into`` with ``prefixes_to_ignore``
    against the JAX package's.
"""
import os
import types

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import checkpoints as jckpt
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import build_params, checkpoints, optimizers

KW = dict(N_samples=4, N_importance=4, encode_a=True, encode_t=True,
          mlp_depth=2, mlp_width=16)


def _jparams(seed=0):
    return jax.tree_util.tree_map(np.asarray, jsys.build_params(
        jax.random.PRNGKey(seed), JRenderConfig(**KW), 6))


def _same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, np.generic)
                                  and isinstance(b, np.generic)), \
        (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("opt", [None, "adam", "ranger"])
def test_msgpack_reader_matches_flax(tmp_path, opt):
    p = _jparams()
    state = None
    if opt:
        h = types.SimpleNamespace(optimizer=opt, lr=1e-3, weight_decay=0.1)
        tx = jopt.build_optimizer(h)
        state = tx.init(p)
    path = str(tmp_path / "epoch=3.ckpt")
    jckpt.save_checkpoint(path, p, state, epoch=3, global_step=17,
                          extra={"note": "x" * 40, "f": 0.5})
    data = open(path, "rb").read()
    _same_tree(checkpoints.msgpack_restore(data),
               serialization.msgpack_restore(data))


def test_msgpack_reader_covers_every_type():
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
                 -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.5, -1e300, float("inf")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                 "e" * 65536, "ü"],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "consts": [None, True, False],
        "long": list(range(20)) + [list(range(70000))],
        "map16": {str(i): i for i in range(20)},
        "arr": np.arange(12, dtype=np.float32).reshape(3, 4),
        "scalar": np.float64(2.5),
        "i64": np.arange(5, dtype=np.int64),
        "bool": np.array([True, False]),
        "f32": np.float32(1.25),
    }
    data = serialization.msgpack_serialize(tree)
    _same_tree(checkpoints.msgpack_restore(data),
               serialization.msgpack_restore(data))
    # float32 scalars as msgpack floats, and a map32 from msgpack itself
    raw = msgpack.packb({"f": 1.5, "m": {str(i): i for i in range(70000)}},
                        use_single_float=True)
    assert checkpoints.msgpack_unpack(raw) == msgpack.unpackb(raw)


def test_msgpack_reader_refuses_chunked_leaves():
    data = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(NotImplementedError, match="chunked"):
        checkpoints.msgpack_restore(data)


def test_load_checkpoint_reads_jax_files_in_the_port_layout(tmp_path):
    jp = _jparams(1)
    h = types.SimpleNamespace(optimizer="adam", lr=1e-3, weight_decay=0.0)
    path = str(tmp_path / "epoch=2.ckpt")
    jckpt.save_checkpoint(path, jp, jopt.build_optimizer(h).init(jp),
                          epoch=2, global_step=9)
    ck = checkpoints.load_checkpoint(path)
    assert ck["format"] == "jax" and ck["epoch"] == 2
    assert ck["global_step"] == 9 and "opt_state" in ck
    want = from_jax_params(jp, RenderConfig(**KW))
    for key, v in want.items():
        if isinstance(v, torch.nn.Module):
            sd = v.state_dict()
            assert sorted(sd) == sorted(ck["state_dict"][key])
            for n, t in sd.items():
                assert torch.equal(ck["state_dict"][key][n], t)
        else:
            assert torch.equal(ck["state_dict"][key], v.detach())


def test_torch_checkpoint_round_trip(tmp_path):
    cfg = RenderConfig(**KW)
    params = build_params(cfg, 6, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    h = types.SimpleNamespace(optimizer="adam", lr=1e-3, weight_decay=0.0)
    leaves = optimizers.named_leaves(params)
    opt = optimizers.build_optimizer(h, [p for _, p in leaves])
    for _, p in leaves:
        p.grad = torch.randn_like(p)
    opt.step()
    path = str(tmp_path / "epoch=0.ckpt")
    checkpoints.save_checkpoint(path, params, opt, epoch=0, global_step=5)
    assert not os.path.exists(path + ".tmp")
    assert open(path, "rb").read(4) == b"PK\x03\x04"
    ck = checkpoints.load_checkpoint(path)
    assert ck["format"] == "torch" and ck["global_step"] == 5
    fresh = build_params(cfg, 6, generator=torch.Generator().manual_seed(9),
                         device="cpu")
    checkpoints.load_into(fresh, ck)
    for (_, a), (_, b) in zip(leaves, optimizers.named_leaves(fresh)):
        assert torch.equal(a, b)
    opt2 = optimizers.build_optimizer(
        h, [p for _, p in optimizers.named_leaves(fresh)])
    opt2.load_state_dict(ck["opt_state"])
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_latest_checkpoint_matches_jax(tmp_path):
    assert checkpoints.latest_checkpoint(str(tmp_path / "none")) is None
    for name in ("epoch=2.ckpt", "epoch=10.ckpt", "epoch=9.ckpt",
                 "epoch=11.ckpt.tmp", "other.ckpt"):
        (tmp_path / name).write_bytes(b"")
    got = checkpoints.latest_checkpoint(str(tmp_path))
    assert got == jckpt.latest_checkpoint(str(tmp_path))
    assert got.endswith("epoch=10.ckpt")


@pytest.mark.parametrize("prefixes", [(), ("nerf_fine",), ("embedding",),
                                      ("nerf_coarse.xyz.1", "xyz.0"),
                                      ("loss",)])
def test_load_into_and_load_ckpt_match_jax(tmp_path, prefixes):
    src, dst = _jparams(1), _jparams(2)
    path = str(tmp_path / "w.ckpt")
    jckpt.save_checkpoint(path, src)              # weights only
    want = jckpt.load_into(dst, jckpt.load_checkpoint(path), prefixes)
    cfg = RenderConfig(**KW)
    got = from_jax_params(dst, cfg)
    checkpoints.load_into(got, checkpoints.load_checkpoint(path), prefixes)
    for x, y in zip(jax.tree_util.tree_leaves(to_numpy_tree(got)),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray, want))):
        assert np.array_equal(x, y)
    # per submodule, by name, as eval loads
    got = from_jax_params(dst, cfg)
    for name in got:
        checkpoints.load_ckpt(got[name], path, name)
        want_sub = jckpt.load_ckpt(dst[name], path, name)
        have = to_numpy_tree({name: got[name]})[name]
        for x, y in zip(jax.tree_util.tree_leaves(have),
                        jax.tree_util.tree_leaves(want_sub)):
            assert np.array_equal(x, np.asarray(y))


def test_load_into_refuses_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "w.ckpt")
    jckpt.save_checkpoint(path, _jparams())
    wide = build_params(RenderConfig(**{**KW, "mlp_width": 32}), 6,
                        device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoints.load_into(wide, checkpoints.load_checkpoint(path))
