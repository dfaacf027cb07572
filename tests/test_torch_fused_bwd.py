"""The port's fused PE + MLP backward against the JAX Pallas backward.

On the CPU the port runs ``fused_mlp_bwd_reference`` (the backward
kernel's plain version); the JAX kernel ``_fused_bwd`` runs in interpret
mode on one of its 512-point tiles, with JAX's own ``pack_weights`` on the
same weights.  Every unpacked weight and bias grad and the live columns of
the packed input's cotangent are compared.

Tolerances: f32 within 1e-4 of each tensor's largest magnitude (the same
exact products summed in another order).  bf16: norm-relative 2e-2 per
tensor; both round every inter-layer cotangent to bf16, and a sum that
lands near a rounding boundary flips one bf16 ulp (2^-8) on one side only,
which every later product carries (measured: <= 3e-3).  The kernel itself
is held against the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fl_tpu.core import encoding as je
from nerf_fl_tpu.models import NeRFConfig as JCfg
from nerf_fl_tpu.models import init_nerf as jinit
from nerf_fl_tpu.ops import fused_mlp as jf
from nerf_fl_torch.bridge import from_jax_params, grads_to_numpy_tree
from nerf_fl_torch.ops import fused_mlp as tf
from nerf_fl_torch.render import RenderConfig

N_TILE = 512       # one JAX backward tile: nothing pads to 2048


def _setup(a_dim, transient, n, seed=0):
    jcfg = JCfg(typ="fine", encode_appearance=a_dim > 0,
                in_channels_a=a_dim or 48, encode_transient=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit(jax.random.PRNGKey(seed), jcfg))
    rc = RenderConfig(N_importance=1, encode_a=a_dim > 0, N_a=a_dim or 48,
                      encode_t=True)
    model = from_jax_params({"nerf_fine": jp}, rc)["nerf_fine"]
    if not transient:
        jp = {k: v for k, v in jp.items() if k != "transient"}
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (n, 3))
    dirs = rng.normal(0, 1, (n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = rng.normal(0, 1, (n, a_dim)) if a_dim else None
    t = rng.normal(0, 1, (n, 16))
    return jp, model, [None if x is None else x.astype(np.float32)
                       for x in (xyz, dirs, a, t)], rng


def _port_grads(model, dws, dbs, layout):
    """Unpacked grads in the JAX tree layout, through the model's .grad."""
    transient = layout.has_transient
    flat = tf.unpack_weight_grads(dws, dbs, layout)
    params = [p for lin in tf.field_linears(model, transient)
              for p in (lin.weight, lin.bias)]
    assert len(flat) == len(params)
    for p, g in zip(params, flat):
        assert g.shape == p.shape
        p.grad = g
    out = grads_to_numpy_tree({"nerf_fine": model})["nerf_fine"]
    if not transient:
        out.pop("transient", None)
    return out


def _compare_bwd(transient, a_dim, barf, dtype, seed=0):
    jp, model, (xyz, dirs, a, t), rng = _setup(a_dim, transient, N_TILE,
                                               seed)
    parts = [xyz, dirs] + ([a] if a_dim else []) + ([t] if transient else [])
    inp = np.concatenate(parts, -1)
    live = inp.shape[1]
    inp = np.pad(inp, ((0, 0), (0, 128 - live)))
    g = np.zeros((N_TILE, 128), np.float32)
    g[:, :9] = rng.normal(0, 1, (N_TILE, 9))
    bw = (None, None)
    if barf:
        bw = (np.asarray(je.barf_weights(6.0, 10, 4, 8)),
              np.asarray(je.barf_weights(6.0, 4, 4, 8)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ws = jf.pack_weights(jax.tree_util.tree_map(jnp.asarray, jp), a_dim,
                         transient, jdt)
    jsx, jsd = jf.default_scale_rows(10, 4, a_dim, *bw)
    outs = jf._fused_bwd(ws, jnp.asarray(inp), jsx, jsd, jnp.asarray(g),
                         a_dim=a_dim, has_transient=transient,
                         dtype_name=jnp.dtype(jdt).name, interpret=True,
                         n_freq_xyz=10, n_freq_dir=4)
    ref = jf.unpack_weight_grads(outs[:len(ws)], jp, a_dim, transient)
    ref_inp = np.asarray(outs[len(ws)])

    net = tf.pack_weights(model, tf.Layout(getattr(torch, dtype), 10, 4,
                                           a_dim, 16 if transient else 0))
    sx, sd = tf.default_scale_rows(
        10, 4, a_dim, *(None if w is None else torch.tensor(w) for w in bw))
    dws, dbs, d_inp = tf.fused_mlp_bwd_reference(
        torch.from_numpy(inp), net, sx, sd,
        torch.from_numpy(g[:, :16]).contiguous())
    got = _port_grads(model, dws, dbs, net.layout)
    assert not d_inp[:, live:].any() and not ref_inp[:, live:].any()
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    pairs = [(jax.tree_util.keystr(p), np.asarray(x, np.float32),
              np.asarray(y, np.float32))
             for (p, x), (_, y) in zip(flat_got, flat_ref)]
    pairs.append(("d_inp", d_inp.numpy()[:, :live], ref_inp[:, :live]))
    assert len(pairs) == (39 if transient else 25)
    return pairs


@pytest.mark.parametrize("barf", [False, True])
@pytest.mark.parametrize("a_dim", [48, 0])
@pytest.mark.parametrize("transient", [True, False])
def test_bwd_plain_matches_pallas_f32(transient, a_dim, barf):
    for name, got, ref in _compare_bwd(transient, a_dim, barf, "float32"):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("transient", [True, False])
def test_bwd_plain_close_to_pallas_bf16(transient):
    for name, got, ref in _compare_bwd(transient, 48, False, "bfloat16",
                                       seed=1):
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("transient", [False, True])
def test_function_grads_match_jax_grad(transient):
    """The port's autograd Function on a ragged N = 700 against jax.grad
    of JAX fused_apply_nerf (interpret mode): the twin of
    tests/test_fused_mlp.py::test_fused_grads_match_xla, with its relative
    metric and 2e-3."""
    a_dim = 48 if transient else 0
    jp, model, (xyz, dirs, a, t), _ = _setup(a_dim, transient, 700, seed=3)
    if not transient:
        t = None

    def loss_j(p, x, d, a_, t_):
        o = jf.fused_apply_nerf(p, x, d, a_, t_, output_transient=transient,
                                compute_dtype=jnp.float32, interpret=True)
        return sum(jnp.sum(v) for v in o.values())

    argnums = (0, 1, 2, 3, 4) if transient else (0, 1, 2)
    jg = jax.grad(loss_j, argnums=argnums)(
        jax.tree_util.tree_map(jnp.asarray, jp),
        *[None if v is None else jnp.asarray(v) for v in (xyz, dirs, a, t)])

    ins = [None if v is None else torch.tensor(v, requires_grad=True)
           for v in (xyz, dirs, a, t)]
    out = tf.fused_apply_nerf(
        model, tf.Layout(torch.float32, 10, 4, a_dim, 16 if transient else 0),
        *ins)
    sum(v.sum() for v in out.values()).backward()
    got = [grads_to_numpy_tree({"nerf_fine": model})["nerf_fine"]]
    if not transient:
        got[0].pop("transient")
    got += [x.grad.numpy() for x in ins[:len(argnums) - 1]]

    def relerr(x, y):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        return float((np.abs(x - y) / (np.abs(x) + 1e-3)).max())

    errs = jax.tree_util.tree_map(relerr, list(jg), got)
    assert max(jax.tree_util.tree_leaves(errs)) < 2e-3, errs


@pytest.mark.parametrize("transient", [True, False])
def test_unpack_inverts_pack(transient):
    """Packing any (weight, bias) list and unpacking the packed slabs gives
    the list back: the grad layout mirrors the weight layout."""
    _, model, _, _ = _setup(48, True, 1)
    params = [p.detach() for lin in tf.field_linears(model, transient)
              for p in (lin.weight, lin.bias)]
    net = tf._pack(params, tf.Layout(torch.float32, 10, 4, 48,
                                     16 if transient else 0))
    back = tf.unpack_weight_grads(net.ws, net.bs, net.layout)
    assert len(back) == len(params)
    for x, y in zip(back, params):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
