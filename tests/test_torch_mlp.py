"""nerf_fl_torch models (plain MLP, init, bridge) against the JAX package.

JAX parameters reach the port through bridge.from_jax_params; inputs come
from numpy seeds.  Narrow widths (D=4, W=32, skip at 2) keep this fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fl_tpu.models import NeRFConfig as JCfg
from nerf_fl_tpu.models import apply_nerf as japply
from nerf_fl_tpu.models import init_nerf as jinit
from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training.system import build_params as jbuild
from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree
from nerf_fl_torch.models import NeRFConfig, apply_nerf, init_nerf, num_params
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import build_params

NARROW = dict(D=4, W=32, skips=(2,), in_channels_xyz=63, in_channels_dir=27,
              in_channels_a=8, in_channels_t=4)
# bf16: both sides round every hidden layer to 8 significant bits at the
# same points, but sum in another order; one-ulp flips (2^-8) through four
# layers stay well inside this
BF16_ATOL = 3e-2


def _tree(transient, seed=0):
    cfg = JCfg(typ="fine", encode_appearance=transient,
               encode_transient=transient, **NARROW)
    p = jax.tree_util.tree_map(np.asarray,
                               jinit(jax.random.PRNGKey(seed), cfg))
    return cfg, p


def _port(p, transient):
    cfg = NeRFConfig(typ="fine", encode_appearance=transient,
                     encode_transient=transient, **NARROW)
    model = init_nerf(cfg)
    rc = RenderConfig(mlp_depth=4, mlp_width=32, N_a=8, N_tau=4,
                      N_importance=1, encode_a=transient, encode_t=transient)
    assert rc.nerf_config("fine") == NeRFConfig(
        typ="fine", encode_appearance=transient, encode_transient=transient,
        beta_min=rc.beta_min, **NARROW)
    return from_jax_params({"nerf_fine": p, "nerf_coarse": _tree(False)[1]},
                           rc)["nerf_fine"], model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("per_ray", [False, True])
def test_apply_nerf_matches(dtype, transient, per_ray):
    jcfg, p = _tree(transient)
    model, _ = _port(p, transient)
    rng = np.random.default_rng(1)
    n_rays, s = 12, 5
    x = rng.normal(0, 1, (n_rays * s, 63)).astype(np.float32)
    rows = n_rays if per_ray else n_rays * s
    da = rng.normal(0, 1, (rows, 27 + (8 if transient else 0))) \
        .astype(np.float32)
    t = rng.normal(0, 1, (rows, 4)).astype(np.float32) if transient else None
    spr = s if per_ray else None
    ref = japply(p, jcfg, jnp.asarray(x), jnp.asarray(da),
                 None if t is None else jnp.asarray(t),
                 output_transient=transient, compute_dtype=jnp.dtype(dtype),
                 samples_per_ray=spr)
    got = apply_nerf(model, torch.from_numpy(x), torch.from_numpy(da),
                     None if t is None else torch.from_numpy(t),
                     output_transient=transient,
                     compute_dtype=getattr(torch, dtype),
                     samples_per_ray=spr)
    assert set(got) == set(ref)
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_nerf_sigma_only_matches(dtype):
    jcfg, p = _tree(True)
    model, _ = _port(p, True)
    x = np.random.default_rng(2).normal(0, 1, (40, 63)).astype(np.float32)
    ref = japply(p, jcfg, jnp.asarray(x), sigma_only=True,
                 compute_dtype=jnp.dtype(dtype))
    got = apply_nerf(model, torch.from_numpy(x), sigma_only=True,
                     compute_dtype=getattr(torch, dtype))
    assert set(got) == set(ref) == {"static_sigma"}
    np.testing.assert_allclose(
        got["static_sigma"].detach().numpy(), np.asarray(ref["static_sigma"]),
        atol=1e-5 if dtype == "float32" else BF16_ATOL)


def test_module_names_follow_the_jax_tree():
    _, model = _port(_tree(True)[1], True)
    names = {n for n, _ in model.named_parameters()}
    for expect in ("xyz.0.weight", "xyz.3.bias", "xyz_final.weight",
                   "dir.weight", "static_sigma.bias", "static_rgb.weight",
                   "transient.layers.0.weight", "transient.layers.3.bias",
                   "transient.sigma.weight", "transient.rgb.bias",
                   "transient.beta.weight"):
        assert expect in names, expect
    # nn.Linear layout is (out, in)
    assert tuple(model.xyz[2].weight.shape) == (32, 32 + 63)


def test_bridge_round_trip_and_transpose():
    rc = JRenderConfig(N_samples=4, N_importance=4, encode_a=True,
                       encode_t=True, N_a=8, N_tau=4, mlp_depth=4,
                       mlp_width=32)
    jp = jax.tree_util.tree_map(np.asarray,
                                jbuild(jax.random.PRNGKey(3), rc, 7))
    trc = RenderConfig(N_samples=4, N_importance=4, encode_a=True,
                       encode_t=True, N_a=8, N_tau=4, mlp_depth=4,
                       mlp_width=32)
    tp = from_jax_params(jp, trc)
    np.testing.assert_array_equal(
        tp["nerf_fine"].dir.weight.detach().numpy(),
        jp["nerf_fine"]["dir"]["w"].T)
    back = to_numpy_tree(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # the learned-pose table crosses as it is, both ways; a key the port
    # does not know still raises
    poses = {"r": np.full((2, 3), 0.1, np.float32),
             "t": np.full((2, 3), -0.2, np.float32),
             "init_c2w": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))}
    back = to_numpy_tree(from_jax_params({**jp, "learn_poses": poses}, trc))
    for k, v in poses.items():
        np.testing.assert_array_equal(back["learn_poses"][k], v)
    with pytest.raises(ValueError, match="not ported"):
        from_jax_params({**jp, "pose_scale": np.zeros((2, 6))}, trc)
    bad = {**jp, "nerf_coarse": jp["nerf_fine"]}
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, trc)


def test_init_and_build_params():
    rc = RenderConfig(N_importance=64, encode_a=True, encode_t=True)
    a = build_params(rc, 100, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    b = build_params(rc, 100, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    assert set(a) == {"nerf_coarse", "nerf_fine", "embedding_a",
                      "embedding_t"}
    assert a["embedding_a"].shape == (100, 48)
    assert a["embedding_t"].shape == (100, 16)
    for x, y in zip(a["nerf_fine"].parameters(), b["nerf_fine"].parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # torch default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    w = a["nerf_fine"].xyz[4].weight.detach()
    assert float(w.abs().max()) <= 1 / (256 + 63) ** 0.5
    jn = jinit(jax.random.PRNGKey(0), JCfg(typ="fine", encode_appearance=True,
                                           encode_transient=True))
    assert num_params(a["nerf_fine"]) == sum(
        x.size for x in jax.tree_util.tree_leaves(jn))
