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
    against the JAX package's;
  * a resume from a JAX ``opt_state`` (RAdam, Ranger with its lookahead,
    SGD with momentum, Adam): the port's next steps match JAX's.
"""
import os
import types

import jax
import optax
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


RESUME_AT, RESUME_MORE = 8, 6


@pytest.mark.parametrize("name,wd", [("radam", 0.0), ("radam", 1e-2),
                                     ("ranger", 0.0), ("ranger", 1e-2),
                                     ("sgd", 1e-4), ("adam", 0.0)])
def test_resume_from_a_jax_opt_state_matches_jax(tmp_path, name, wd):
    """The JAX package trains 8 steps (RAdam's first rectified step is the
    6th, Ranger's lookahead syncs at the 6th) and saves; the port reads the
    checkpoint, rebuilds its optimizer from the JAX ``opt_state``
    (``opt_state_from_jax``) and takes the next 6 steps on the same
    gradients as JAX (across Ranger's sync at the 12th, which reads the
    restored slow weights): every leaf within f32 max |x - y| <= 1e-6
    (1 + |y|) after each step."""
    h = types.SimpleNamespace(optimizer=name, lr=1e-2, weight_decay=wd,
                              momentum=0.9)
    tx = jopt.build_optimizer(h)
    jp = _jparams()
    state = tx.init(jp)
    rng = np.random.default_rng(0)

    def grads():
        return jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1, x.shape).astype(np.float32), jp)

    def jstep(jp, state):
        deltas, state = tx.update(grads_t, state, jp, np.float32(h.lr))
        return jax.tree_util.tree_map(np.asarray,
                                      optax.apply_updates(jp, deltas)), state

    for _ in range(RESUME_AT):
        grads_t = grads()
        jp, state = jstep(jp, state)
    path = str(tmp_path / "epoch=0.ckpt")
    jckpt.save_checkpoint(path, jp, state, epoch=0, global_step=RESUME_AT)

    cfg = RenderConfig(**KW)
    ck = checkpoints.load_checkpoint(path)
    tp = build_params(cfg, 6, device="cpu")
    checkpoints.load_into(tp, ck)
    leaves = dict(optimizers.named_leaves(tp))
    opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        tp, optimizers.make_trainable_mask(tp, False)))
    checkpoints.opt_state_from_jax(ck["opt_state"], opt, leaves)
    for t in range(RESUME_MORE):
        grads_t = grads()
        jp, state = jstep(jp, state)
        mods = from_jax_params(grads_t, cfg)
        for (_, p), (_, g) in zip(optimizers.named_leaves(tp),
                                  optimizers.named_leaves(mods)):
            p.grad = g.detach().clone()
        opt.step()
        for x, y in zip(jax.tree_util.tree_leaves(to_numpy_tree(tp)),
                        jax.tree_util.tree_leaves(jp)):
            err = np.abs(x - y) / (1 + np.abs(y))
            assert err.max() <= 1e-6, (t, float(err.max()))
    if name != "sgd":
        st = next(iter(opt.state.values()))
        assert float(st["step"]) == RESUME_AT + RESUME_MORE


def test_resume_refuses_a_lookahead_out_of_step(tmp_path):
    """Ranger's sync reads the RAdam step: a JAX state whose lookahead
    count stands elsewhere in the sync period is refused."""
    h = types.SimpleNamespace(optimizer="ranger", lr=1e-2, weight_decay=0.0)
    jp = _jparams()
    inner, look = jopt.build_optimizer(h).init(jp)
    path = str(tmp_path / "epoch=0.ckpt")
    jckpt.save_checkpoint(path, jp, (inner, look._replace(
        count=np.int32(2))))
    tp = build_params(RenderConfig(**KW), 6, device="cpu")
    opt = optimizers.build_optimizer(h, [p for _, p in
                                         optimizers.named_leaves(tp)])
    with pytest.raises(ValueError, match="sync period"):
        checkpoints.opt_state_from_jax(
            checkpoints.load_checkpoint(path)["opt_state"], opt,
            dict(optimizers.named_leaves(tp)))
