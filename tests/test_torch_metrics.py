"""SSIM and remat_mlp of the port against the JAX package, on the CPU.

SSIM: the JAX ``metrics.ssim`` and the port's on the same images (numpy
seed 0: a smooth ramp with noise, so both flat and textured patches occur),
window sizes 3 and 11: the f32 mean (what eval reports) within atol 1e-6,
and the per-pixel map in float64 (JAX under ``enable_x64``) within 1e-12.
The f32 maps are not compared pixel by pixel: a window's variance is a
difference of two sums near 1 over a denominator near C2 = 9e-4, so the
two libraries' summation orders alone move a pixel by ~1e-4.
remat_mlp: one training step's loss and every gradient on the plain path
equal with and without it, bit for bit (the recompute runs the same ops).
"""
import jax
import numpy as np
import pytest
import torch

from nerf_fl_tpu.training import metrics as jmetrics
from nerf_fl_torch.render import RenderConfig, render_rays
from nerf_fl_torch.training import build_params, losses, metrics, optimizers


def _images(b=2, h=23, w=31, seed=0):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, w, dtype=np.float32)[None, None, None]
    gt = np.clip(ramp + 0.05 * rng.normal(size=(b, 3, h, w)), 0, 1)
    pred = np.clip(gt + 0.1 * rng.normal(size=gt.shape), 0, 1)
    return pred.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("window", [3, 11])
def test_ssim_matches_jax(window):
    pred, gt = _images()
    want = float(jmetrics.ssim(pred, gt, window_size=window))
    got = float(metrics.ssim(torch.from_numpy(pred), torch.from_numpy(gt),
                             window_size=window))
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("window", [3, 11])
def test_ssim_map_matches_jax_in_float64(window):
    pred, gt = (x.astype(np.float64) for x in _images())
    with jax.enable_x64():
        want = np.asarray(jmetrics.ssim(pred, gt, window_size=window,
                                        reduction="none"))
    got = metrics.ssim(torch.from_numpy(pred), torch.from_numpy(gt),
                       window_size=window, reduction="none").numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_ssim_of_an_image_with_itself_is_one():
    _, gt = _images()
    assert abs(float(metrics.ssim(gt, gt)) - 1.0) < 1e-6


def test_remat_mlp_gives_the_same_gradients():
    from dataclasses import replace
    cfg = RenderConfig(N_samples=8, N_importance=8, encode_a=True,
                       encode_t=True, mlp_depth=2, mlp_width=32,
                       perturb=0.0, noise_std=0.0, white_back=True)
    params = build_params(cfg, 4, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.concatenate(
        [rng.normal(size=(64, 3)).astype(np.float32), d,
         np.full((64, 1), 2, np.float32), np.full((64, 1), 6, np.float32)],
        1))
    ts = torch.from_numpy(rng.integers(0, 4, 64))
    rgbs = torch.from_numpy((0.5 + 0.4 * d).astype(np.float32))
    leaves = optimizers.named_leaves(params)
    out = []
    for remat in (False, True):
        for _, p in leaves:
            p.grad = None
        res = render_rays(params, rays, ts, replace(cfg, remat_mlp=remat))
        loss = sum(losses.nerfw_loss(res, rgbs).values())
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for _, p in leaves]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
