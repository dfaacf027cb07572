"""The port's fused PE + MLP forward against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs
in interpret mode, as tests/test_fused_mlp.py runs it.  Full width (the
kernel's shape gate needs 8 x 256), ragged N = 700.  f32 tolerance 2e-4, as
tests/test_fused_mlp.py.  The kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
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
from nerf_fl_torch.bridge import from_jax_params
from nerf_fl_torch.ops import fused_mlp as tf
from nerf_fl_torch.render import RenderConfig

ATOL = 2e-4
N = 700


def _setup(a_dim, seed=0):
    jcfg = JCfg(typ="fine", encode_appearance=a_dim > 0,
                in_channels_a=a_dim or 48, encode_transient=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit(jax.random.PRNGKey(seed), jcfg))
    rc = RenderConfig(N_importance=1, encode_a=a_dim > 0, N_a=a_dim or 48,
                      encode_t=True)
    model = from_jax_params({"nerf_fine": jp}, rc)["nerf_fine"]
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (N, 3)).astype(np.float32)
    a = rng.normal(0, 1, (N, a_dim)).astype(np.float32) if a_dim else None
    t = rng.normal(0, 1, (N, 16)).astype(np.float32)
    return jp, model, xyz, dirs, a, t


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("barf", [None, "fork", "paper"])
@pytest.mark.parametrize("a_dim", [48, 0])
@pytest.mark.parametrize("transient", [True, False])
def test_plain_fused_matches_pallas(transient, a_dim, barf):
    jp, model, xyz, dirs, a, t = _setup(a_dim)
    bw = (None, None)
    if barf:
        bw = (je.barf_weights(6.0, 10, 4, 8, schedule=barf),
              je.barf_weights(6.0, 4, 4, 8, schedule=barf))
    ref = jf.fused_apply_nerf(
        jp, _j(xyz), _j(dirs), _j(a), _j(t) if transient else None,
        output_transient=transient, compute_dtype=jnp.float32,
        barf_w_xyz=bw[0], barf_w_dir=bw[1], interpret=True)
    with torch.no_grad():
        got = tf.fused_apply_nerf(
            model, tf.Layout(torch.float32, 10, 4, a_dim,
                             16 if transient else 0),
            _t(xyz), _t(dirs), _t(a), _t(t) if transient else None,
            barf_w_xyz=_t(bw[0]), barf_w_dir=_t(bw[1]))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


def test_plain_fused_bf16_close_to_pallas():
    """bf16: same rounding points as the Pallas kernel; f32 sums in another
    order can flip a hidden value by one bf16 ulp (2^-8), so 3e-2."""
    jp, model, xyz, dirs, a, t = _setup(48, seed=1)
    ref = jf.fused_apply_nerf(jp, _j(xyz), _j(dirs), _j(a), _j(t),
                              output_transient=True,
                              compute_dtype=jnp.bfloat16, interpret=True)
    with torch.no_grad():
        got = tf.fused_apply_nerf(model, tf.Layout(torch.bfloat16, 10, 4, 48,
                                                   16),
                                  _t(xyz), _t(dirs), _t(a), _t(t))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=3e-2, err_msg=k)


@pytest.mark.parametrize("a_dim", [48, 0])
def test_pack_layout_matches_jax(a_dim):
    jp, model, xyz, dirs, a, t = _setup(a_dim, seed=2)
    # packed input rows
    parts = [xyz, dirs] + ([a] if a is not None else []) + [t]
    ref_inp = np.pad(np.concatenate(parts, -1),
                     ((0, 0), (0, 128 - 6 - a_dim - 16)))
    np.testing.assert_array_equal(
        tf.pack_inputs(_t(xyz), _t(dirs), _t(a), _t(t)).numpy(), ref_inp)
    # encoder constants and scale rows
    cj = jf._encoder_consts(10, 4, a_dim)
    for k, v in tf._encoder_consts(10, 4, a_dim).items():
        np.testing.assert_array_equal(v, cj[k], err_msg=k)
    bw = (np.asarray(je.barf_weights(6.0, 10, 4, 8)),
          np.asarray(je.barf_weights(6.0, 4, 4, 8)))
    for got, ref in zip(
            tf.default_scale_rows(10, 4, a_dim, *map(_t, bw)),
            jf.default_scale_rows(10, 4, a_dim, *bw)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # weights: every port block is the JAX block without its all-zero
    # padding, and nothing the JAX layout holds is dropped
    net = tf.pack_weights(model, tf.Layout(torch.float32, 10, 4, a_dim, 16))
    jw = [np.asarray(w) for w in
          jf.pack_weights(jax.tree_util.tree_map(jnp.asarray, jp), a_dim,
                          True, jnp.float32)]
    k0, kd, kt = net.layout.k0, net.layout.kd, net.layout.kt
    assert (k0, kd, kt) == (64, 80 if a_dim else 32, 16)
    row_maps = {0: [(0, k0, 0)], 4: [(0, k0, 0), (k0, k0 + 256, 128)],
                9: [(0, 256, 0), (256, 256 + kd, 256)],
                11: [(0, 256, 0), (256, 256 + kt, 256)]}
    for i, (w, b) in enumerate(zip(net.ws, net.bs)):
        J, JB = jw[2 * i], jw[2 * i + 1][0]
        w = w.numpy()
        covered = np.zeros(J.shape, bool)
        for lo, hi, jlo in row_maps.get(i, [(0, w.shape[0], 0)]):
            np.testing.assert_array_equal(
                w[lo:hi], J[jlo:jlo + hi - lo, :w.shape[1]], err_msg=str(i))
            covered[jlo:jlo + hi - lo, :w.shape[1]] = True
        assert not J[~covered].any(), f"layer {i} drops non-zero weights"
        np.testing.assert_array_equal(b.numpy(), JB[:b.shape[0]])
        assert not JB[b.shape[0]:].any()


def test_heads_column_layout():
    pre = torch.zeros(2, 16)
    pre[:, tf.COL_S_SIGMA] = 5.0
    pre[:, tf.COL_T_BETA] = -5.0
    h = tf.heads(pre, True)
    assert set(h) == {"static_rgb", "static_sigma", "transient_rgb",
                      "transient_sigma", "transient_beta"}
    torch.testing.assert_close(h["static_rgb"], torch.full((2, 3), 0.5))
    torch.testing.assert_close(h["static_sigma"],
                               torch.nn.functional.softplus(torch.tensor(
                                   [5.0, 5.0])))
    torch.testing.assert_close(h["transient_beta"],
                               torch.nn.functional.softplus(torch.tensor(
                                   [-5.0, -5.0])))
    assert set(tf.heads(pre, False)) == {"static_rgb", "static_sigma"}


def test_softplus_matches_jax_for_large_inputs():
    x = np.array([-100.0, -20.0, -1.0, 0.0, 1.0, 20.0, 100.0], np.float32)
    from nerf_fl_torch.models.mlp import softplus
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-37)  # XLA flushes subnormals


def test_kernel_launcher_rejects_cpu_tensors():
    _, model, xyz, dirs, a, t = _setup(48, seed=3)
    inp = tf.pack_inputs(_t(xyz), _t(dirs), _t(a), _t(t))
    net = tf.pack_weights(model, tf.Layout(torch.bfloat16, 10, 4, 48, 16))
    sx, sd = tf.default_scale_rows(10, 4, 48)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_mlp_fwd_cuda(inp, net, sx, sd)


def _coarse(n_freq_xyz, seed=4, n=N):
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    model = init_nerf(NeRFConfig(typ="coarse", in_channels_xyz=3 + 6 * n_freq_xyz),
                      generator=torch.Generator().manual_seed(seed))
    xyz = torch.from_numpy(np.random.default_rng(seed).uniform(
        -3, 3, (n, 3)).astype(np.float32))
    return model, xyz


@pytest.mark.parametrize("n_freq_xyz", [10, 5])
@pytest.mark.parametrize("barf", [None, "fork", "paper"])
def test_plain_sigma_matches_plain_mlp_and_the_fused_column(barf, n_freq_xyz):
    """The sigma-only kernel's plain version, at f32: its static sigma is
    the plain MLP path's (``apply_nerf(..., sigma_only=True)`` over
    ``encoding.embed``; another sine and other sums: 2e-4, as above), and
    its pre-activation is column COL_S_SIGMA of the fused forward's plain
    version on the same points (the same trunk; only the last 256-long sum
    is taken in another shape of product)."""
    from nerf_fl_torch.core import encoding
    from nerf_fl_torch.models.mlp import apply_nerf
    model, xyz = _coarse(n_freq_xyz)
    bw = None if barf is None else encoding.barf_weights(
        6.0, n_freq_xyz, 4, 8, schedule=barf)
    with torch.no_grad():
        got = tf.fused_sigma(model, tf.Layout(torch.float32, n_freq_xyz,
                                              variant=tf.SIGMA),
                             xyz, barf_w_xyz=bw)["static_sigma"]
        ref = apply_nerf(model, encoding.embed(
            xyz, n_freq_xyz, barf=barf is not None, epoch=6.0,
            schedule=barf or "fork"), sigma_only=True)["static_sigma"]
        net = tf.pack_weights(model, tf.Layout(torch.float32, n_freq_xyz, 4))
        sx, sd = tf.default_scale_rows(n_freq_xyz, 4, 0, bw)
        dirs = torch.from_numpy(np.random.default_rng(5).normal(
            0, 1, (N, 3)).astype(np.float32))
        full = tf.fused_mlp_reference(tf.pack_inputs(xyz, dirs), net, sx, sd)
        pre = tf.fused_sigma_reference(xyz, net, sx)
    assert got.shape == ref.shape == (N,)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    torch.testing.assert_close(pre, full[:, tf.COL_S_SIGMA])
    torch.testing.assert_close(got, tf.softplus(pre))


@pytest.mark.parametrize("n_freq_xyz", [10, 5])
def test_sigma_packing_is_the_trunk_and_fs2(n_freq_xyz):
    """``pack_weights`` at the sigma layout gives the full layout's first
    SIGMA_LAYERS layers in f32, weights and biases, and no more."""
    model, _ = _coarse(n_freq_xyz)
    full = tf.pack_weights(model, tf.Layout(torch.float32, n_freq_xyz, 4))
    net = tf.pack_weights(model, full.layout.sigma)
    assert len(net.ws) == len(net.bs) == tf.SIGMA_LAYERS
    assert net.layout.shapes == full.layout.shapes[:tf.SIGMA_LAYERS]
    assert net.layout.k0 == full.layout.k0
    for got, want in zip(net.ws + net.bs, full.ws[:tf.SIGMA_LAYERS]
                         + full.bs[:tf.SIGMA_LAYERS]):
        assert torch.equal(got, want)


def test_sigma_launcher_rejects_cpu_tensors_and_autograd():
    model, xyz = _coarse(10)
    lay = tf.Layout(torch.float32, 10, 4)
    net = tf.pack_weights(model, lay)
    sx, _ = tf.default_scale_rows(10, 4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_sigma_cuda(xyz, net, sx)
    with pytest.raises(ValueError, match="no backward"):
        tf.fused_sigma(model, lay, xyz)
