"""The port's render path against the JAX package, deterministic mode.

(a) narrow width: JAX ``use_pallas=False`` against the port's plain MLP;
(b) full width, 16 rays at 8+8 samples: the JAX Pallas kernel in interpret
mode against the port's plain fused version.  Every key of the result
dict, for test_time and output_transient True/False.  f32 throughout;
tolerance 1e-4: a 1e-6 MLP difference moves a sample's alpha, and the
transmittance product and the 1e2 terminal delta carry it into every
later weight and into depth (values up to 6).
"""
import jax
import numpy as np
import pytest
import torch

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.render import render_rays as jrender
from nerf_fl_tpu.training.system import build_params as jbuild
from nerf_fl_torch.bridge import from_jax_params
from nerf_fl_torch.render import RenderConfig, render_rays
from nerf_fl_torch.training.system import render_chunked, val_chunk_cap

ATOL = 1e-4


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], 1)
    return rays, rng.integers(0, 5, n).astype(np.int32)


def _configs(narrow, **over):
    kw = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
              white_back=True, perturb=0.0, noise_std=0.0, beta_min=0.1)
    if narrow:
        kw.update(N_a=8, N_tau=4, mlp_depth=4, mlp_width=32)
    kw.update(over)
    return (JRenderConfig(use_pallas=not narrow, **kw),
            RenderConfig(use_fused=not narrow, **kw))


def _compare(jcfg, tcfg, test_time, output_transient, n=16, seed=0):
    jp = jbuild(jax.random.PRNGKey(seed), jcfg, 5)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rays, ts = _rays(n, seed)
    ref = jrender(jp, jax.numpy.asarray(rays), jax.numpy.asarray(ts),
                  jax.random.PRNGKey(1), jcfg, test_time=test_time,
                  output_transient=output_transient)
    with torch.no_grad():
        got = render_rays(tp, torch.from_numpy(rays), torch.from_numpy(ts),
                          tcfg, test_time=test_time,
                          output_transient=output_transient)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)
    return got


@pytest.mark.parametrize("output_transient", [True, False])
@pytest.mark.parametrize("test_time", [True, False])
def test_render_narrow_plain_mlp(test_time, output_transient):
    _compare(*_configs(True), test_time, output_transient)


@pytest.mark.parametrize("output_transient", [True, False])
@pytest.mark.parametrize("test_time", [True, False])
def test_render_full_width_fused(test_time, output_transient):
    _compare(*_configs(False), test_time, output_transient)


@pytest.mark.parametrize("test_time", [True, False])
def test_render_coarse_only(test_time):
    _compare(*_configs(True, N_importance=0, encode_a=False, encode_t=False),
             test_time, False)


def test_fused_needs_full_width():
    """Narrow widths fall back to the plain MLP even with use_fused=True."""
    jcfg, tcfg = _configs(True)
    from dataclasses import replace
    _compare(replace(jcfg, use_pallas=False), replace(tcfg, use_fused=True),
             True, True)


@pytest.mark.parametrize("a_override", [False, True])
def test_render_chunked_matches_direct(a_override):
    _, tcfg = _configs(True)
    tp = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jbuild(jax.random.PRNGKey(2), _configs(True)[0], 5)),
        tcfg)
    rays, ts = _rays(21, seed=3)
    a = np.random.default_rng(4).normal(0, 1, 8).astype(np.float32) \
        if a_override else None
    got = render_chunked(tp, rays, ts, tcfg, chunk=8, keys=["rgb_fine",
                                                           "depth_fine"],
                         inflight=2, a_override=a, device="cpu")
    assert set(got) == {"rgb_fine", "depth_fine"}
    with torch.no_grad():
        ref = render_rays(tp, torch.from_numpy(rays), torch.from_numpy(ts),
                          tcfg, test_time=True,
                          a_embedded=None if a is None else
                          torch.from_numpy(a).expand(21, 8))
    for k in got:
        assert got[k].shape == tuple(ref[k].shape)
        np.testing.assert_allclose(got[k], ref[k].numpy(), atol=1e-6)


def test_val_chunk_cap_matches_jax():
    from nerf_fl_tpu.training.system import val_chunk_cap as jcap
    for args in [(32768, 64, 64), (32768, 64, 0), (1 << 20, 256, 128),
                 (1000, 8, 8)]:
        assert val_chunk_cap(*args) == jcap(*args)
    assert val_chunk_cap(32768, 64, 64) == 32768


@pytest.mark.parametrize("case", ["float32", "bfloat16", "grad", "train"])
def test_test_time_coarse_pass_takes_the_sigma_kernel(monkeypatch, case):
    """With the fused kernels on (use_fused=True: their plain versions on
    CPU tensors), a test-time render at f32 with no gradient sends the
    sigma-only coarse pass through ``fused_sigma``; at bf16, under
    autograd, and in a training render (no sigma-only pass) the sigma path
    is not taken and a sigma-only pass, where there is one, stays on the
    plain MLP path."""
    import nerf_fl_torch.render.renderer as rr
    from nerf_fl_torch.training import build_params
    calls = {"sigma": 0, "plain_sigma": 0}
    real_sigma, real_plain = rr.fused_sigma, rr.apply_nerf

    def sigma(*a, **k):
        calls["sigma"] += 1
        return real_sigma(*a, **k)

    def plain(*a, **k):
        calls["plain_sigma"] += bool(k.get("sigma_only"))
        return real_plain(*a, **k)
    monkeypatch.setattr(rr, "fused_sigma", sigma)
    monkeypatch.setattr(rr, "apply_nerf", plain)
    _, tcfg = _configs(False, compute_dtype="bfloat16" if case == "bfloat16"
                       else "float32")
    params = build_params(tcfg, 5, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    rays, ts = _rays(4, seed=5)
    grad = torch.enable_grad() if case in ("grad", "train") \
        else torch.no_grad()
    with grad:
        out = render_rays(params, torch.from_numpy(rays),
                          torch.from_numpy(ts), tcfg,
                          test_time=case != "train")
    assert np.isfinite(out["rgb_fine"].detach().numpy()).all()
    want = {"float32": (1, 0), "bfloat16": (0, 1), "grad": (0, 1),
            "train": (0, 0)}[case]
    assert (calls["sigma"], calls["plain_sigma"]) == want
