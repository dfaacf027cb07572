"""nerf_fl_torch core primitives against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; f32 tolerances
are 1e-5 unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fl_tpu.core import compositing as jc
from nerf_fl_tpu.core import encoding as je
from nerf_fl_tpu.core import rays as jr
from nerf_fl_tpu.core import sampling as js
from nerf_fl_tpu.ops import sorting as jsort
from nerf_fl_tpu.training import metrics as jm
from nerf_fl_torch.core import compositing as tc
from nerf_fl_torch.core import encoding as te
from nerf_fl_torch.core import rays as tr
from nerf_fl_torch.core import sampling as ts
from nerf_fl_torch.models import embeddings as temb
from nerf_fl_torch.ops import sorting as tsort
from nerf_fl_torch.training import metrics as tm

ATOL = 1e-5


def close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("q", [0.0, 0.25])
def test_sin_cw_matches(q):
    x = np.random.default_rng(0).uniform(-3000, 3000, 4096).astype(np.float32)
    close(te.sin_cw(torch.from_numpy(x), q), je.sin_cw(jnp.asarray(x), q))


def test_sin_cw_rounds_half_to_even():
    # x * INV_2PI lands exactly on k + 0.5 for these: jnp.round and
    # torch.round must both pick the even neighbour
    u = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    x = (u / np.float32(te.INV_2PI)).astype(np.float32)
    close(te.sin_cw(torch.from_numpy(x)), je.sin_cw(jnp.asarray(x)))


def _posenc_exact(x, n_freqs, weights=None):
    """posenc of f32 ``x`` in float64: the sin and cos of the f32 arguments
    ``x * 2^k`` (each exact in f32), unrounded."""
    xb = x.astype(np.float64)[:, None, :] * \
        2.0 ** np.arange(n_freqs)[:, None]
    sin, cos = np.sin(xb), np.cos(xb)
    if weights is not None:
        w = np.asarray(weights, np.float64)[:, None]
        sin, cos = sin * w, cos * w
    sc = np.stack([sin, cos], -2).reshape(len(x), -1)
    return np.concatenate([x.astype(np.float64), sc], -1)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("barf", [None, "fork", "paper"])
def test_posenc_matches(fast, barf):
    """At ``fast`` both packages run the same Cody-Waite polynomial and are
    held to each other.  Otherwise each takes its library's sin and cos of
    arguments up to ~4,000 (x ~ N(0, 2) times 2^9), and each is held to the
    exact values instead: a one-ulp-accurate sin is within 6e-8 of them,
    and a run in which either library's sin strays (the two packages once
    read up to 1.5e-4 apart on a tenth of the elements under the tier-1
    command, and never alone) names the package that strayed."""
    x = np.random.default_rng(1).normal(0, 2, (257, 3)).astype(np.float32)
    kw = dict(fast=fast)
    jw = tw = None
    if barf:
        jw = je.barf_weights(6.5, 10, 4, 8, schedule=barf)
        tw = te.barf_weights(6.5, 10, 4, 8, schedule=barf)
        close(tw, jw, atol=1e-6)
    got = te.posenc(torch.from_numpy(x), 10, weights=tw, **kw)
    ref = je.posenc(jnp.asarray(x), 10, weights=jw, **kw)
    assert got.shape == ref.shape == (257, 63)
    if fast:
        close(got, ref, atol=1e-5)
        return
    exact = _posenc_exact(x, 10, None if jw is None else np.asarray(jw))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5, rtol=0,
                               err_msg="the port's posenc")
    np.testing.assert_allclose(np.asarray(ref), exact, atol=1e-5, rtol=0,
                               err_msg="the JAX package's posenc")


@pytest.mark.parametrize("schedule", ["fork", "paper"])
@pytest.mark.parametrize("epoch", [0.0, 4.0, 5.0, 6.5, 8.0, 12.0])
def test_barf_weights_match(schedule, epoch):
    for n in (4, 10):
        close(te.barf_alpha(epoch, n, 4, 8, schedule),
              je.barf_alpha(epoch, n, 4, 8, schedule), atol=1e-6)
        close(te.barf_weights(epoch, n, 4, 8, schedule=schedule),
              je.barf_weights(epoch, n, 4, 8, schedule=schedule), atol=1e-6)


def test_embed_barf_needs_epoch():
    with pytest.raises(ValueError):
        te.embed(torch.zeros(2, 3), 4, barf=True)


def test_rays_match():
    K = np.array([[50.0, 0, 20.0], [0, 50.0, 16.0], [0, 0, 1]], np.float32)
    c2w = np.random.default_rng(2).normal(0, 1, (3, 4)).astype(np.float32)
    dt = tr.get_ray_directions(32, 40, K)
    dj = jr.get_ray_directions(32, 40, K)
    close(dt, dj)
    for got, ref in zip(tr.get_rays(dt, torch.from_numpy(c2w)),
                        jr.get_rays(dj, jnp.asarray(c2w))):
        close(got, ref)
    # per-ray poses
    poses = np.random.default_rng(3).normal(0, 1, (dt.numel() // 3, 3, 4)) \
        .astype(np.float32)
    for got, ref in zip(tr.get_rays(dt, torch.from_numpy(poses)),
                        jr.get_rays(dj, jnp.asarray(poses))):
        close(got, ref)


def test_ndc_rays_match():
    rng = np.random.default_rng(4)
    o = rng.normal(0, 0.1, (64, 3)).astype(np.float32)
    d = rng.normal(0, 1, (64, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    for got, ref in zip(
            tr.get_ndc_rays(32, 40, 50.0, 1.0, torch.from_numpy(o),
                            torch.from_numpy(d)),
            jr.get_ndc_rays(32, 40, 50.0, 1.0, jnp.asarray(o),
                            jnp.asarray(d))):
        close(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("use_disp", [False, True])
def test_stratified_deterministic_matches(use_disp):
    rng = np.random.default_rng(5)
    near = rng.uniform(0.5, 2, (33, 1)).astype(np.float32)
    far = near + rng.uniform(1, 4, (33, 1)).astype(np.float32)
    got = ts.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far),
                               17, use_disp=use_disp)
    ref = js.stratified_z_vals(None, jnp.asarray(near), jnp.asarray(far), 17,
                               use_disp=use_disp)
    close(got, ref, atol=1e-5, rtol=1e-6)


def test_stratified_injected_uniforms():
    """perturb > 0 with injected uniforms: the JAX formula, by hand."""
    rng = np.random.default_rng(6)
    near = np.full((5, 1), 2.0, np.float32)
    far = np.full((5, 1), 6.0, np.float32)
    u = rng.uniform(0, 1, (5, 9)).astype(np.float32)
    got = ts.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far),
                               9, perturb=1.0, u=torch.from_numpy(u))
    z = np.asarray(js.stratified_z_vals(None, jnp.asarray(near),
                                        jnp.asarray(far), 9))
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = np.concatenate([mid, z[:, -1:]], -1)
    lower = np.concatenate([z[:, :1], mid], -1)
    close(got, lower + (upper - lower) * u)


def test_searchsorted_right_matches():
    rng = np.random.default_rng(7)
    seq = np.sort(rng.uniform(0, 1, (20, 12)), -1).astype(np.float32)
    q = rng.uniform(-0.1, 1.1, (20, 9)).astype(np.float32)
    q[:, 0] = seq[:, 3]                                   # exact ties
    got = ts.searchsorted_right(torch.from_numpy(seq), torch.from_numpy(q))
    ref = js.searchsorted_right(jnp.asarray(seq), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_pdf_det_matches():
    rng = np.random.default_rng(8)
    bins = np.sort(rng.uniform(2, 6, (40, 31)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (40, 30)).astype(np.float32)
    w[:5] = 0.0                                            # zero-weight rays
    got = ts.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 64,
                        det=True)
    ref = js.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 64, det=True)
    close(got, ref, atol=1e-5, rtol=1e-6)


def test_sample_pdf_injected_uniforms_sorted():
    rng = np.random.default_rng(9)
    bins = np.sort(rng.uniform(2, 6, (8, 11)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (8, 10)).astype(np.float32)
    u = np.sort(rng.uniform(0, 1, (8, 16)), -1).astype(np.float32)
    got = ts.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 16,
                        u=torch.from_numpy(u)).numpy()
    assert (np.diff(got, axis=-1) >= 0).all()
    assert (got >= bins[:, :1] - 1e-6).all() and (got <= bins[:, -1:] + 1e-6).all()


def test_sorted_uniform_is_sorted_uniform():
    u = tsort.sorted_uniform((2000, 16),
                             generator=torch.Generator().manual_seed(0))
    assert (torch.diff(u, dim=-1) >= 0).all()
    assert 0 < float(u.min()) and float(u.max()) < 1
    # k-th order statistic of 16 uniforms has mean k / 17
    means = u.mean(0).numpy()
    close(means, np.arange(1, 17) / 17.0, atol=0.02)


def test_rank_merge_sorted_matches():
    rng = np.random.default_rng(10)
    a = np.sort(rng.uniform(0, 1, (30, 16)), -1).astype(np.float32)
    b = np.sort(np.concatenate([rng.uniform(0, 1, (30, 21)), a[:, 5:8]], -1),
                -1).astype(np.float32)                     # ties with a
    got = tsort.rank_merge_sorted(torch.from_numpy(a), torch.from_numpy(b))
    ref = jsort.rank_merge_sorted(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _comp_inputs(seed=11, n=25, s=19):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    f = lambda *shape: rng.uniform(0, 3, shape).astype(np.float32)  # noqa
    return z, f(n, s, 3) / 3, f(n, s), f(n, s, 3) / 3, f(n, s), f(n, s)


@pytest.mark.parametrize("white_back", [False, True])
@pytest.mark.parametrize("weights_only", [False, True])
def test_composite_static_matches(white_back, weights_only):
    z, rgb, sig = _comp_inputs()[:3]
    sig = sig - 1.0                                        # relu matters
    got = tc.composite_static(torch.from_numpy(z), torch.from_numpy(rgb),
                              torch.from_numpy(sig), white_back=white_back,
                              weights_only=weights_only)
    ref = jc.composite_static(jnp.asarray(z), jnp.asarray(rgb),
                              jnp.asarray(sig), white_back=white_back,
                              weights_only=weights_only)
    for g, r in zip(got, ref):
        close(g, r, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("white_back", [False, True])
def test_composite_transient_and_solo_match(white_back):
    z, rgb, sig, trgb, tsig, beta = _comp_inputs(12)
    T = torch.from_numpy
    got = tc.composite_transient(T(z), T(rgb), T(sig), T(trgb), T(tsig),
                                 T(beta), beta_min=0.1, white_back=white_back)
    ref = jc.composite_transient(*map(jnp.asarray,
                                      (z, rgb, sig, trgb, tsig, beta)),
                                 beta_min=0.1, white_back=white_back)
    for g, r in zip(got, ref):
        close(g, r, atol=1e-5, rtol=1e-6)
    for g, r in zip(
            tc.composite_solo_field(T(z), T(rgb), T(sig),
                                    white_back=white_back,
                                    combined_opacity=got.opacity),
            jc.composite_solo_field(jnp.asarray(z), jnp.asarray(rgb),
                                    jnp.asarray(sig), white_back=white_back,
                                    combined_opacity=ref.opacity)):
        close(g, r, atol=1e-5, rtol=1e-6)


def test_composite_static_noise_uses_generator():
    z, rgb, sig = _comp_inputs(13)[:3]
    T = torch.from_numpy
    a = tc.composite_static(T(z), T(rgb), T(sig), noise_std=1.0,
                            generator=torch.Generator().manual_seed(3))
    b = tc.composite_static(T(z), T(rgb), T(sig), noise_std=1.0,
                            generator=torch.Generator().manual_seed(3))
    c = tc.composite_static(T(z), T(rgb), T(sig))
    torch.testing.assert_close(a.rgb, b.rgb, rtol=0, atol=0)
    assert not torch.allclose(a.rgb, c.rgb)


def test_embedding_lookup_and_vocab():
    table = np.random.default_rng(14).normal(0, 1, (10, 4)).astype(np.float32)
    ids = np.array([0, 9, 3, 3], np.int32)
    close(temb.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)),
          table[ids], atol=0)
    temb.validate_vocab(10, 9)
    with pytest.raises(ValueError, match="N_vocab"):
        temb.validate_vocab(10, 10)


def test_metrics_match():
    rng = np.random.default_rng(15)
    a = rng.uniform(0, 1, (6, 5, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (6, 5, 3)).astype(np.float32)
    m = rng.uniform(0, 1, (6, 5)) > 0.4
    T = torch.from_numpy
    close(tm.mse(T(a), T(b)), jm.mse(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    close(tm.psnr(T(a), T(b)), jm.psnr(jnp.asarray(a), jnp.asarray(b)), 1e-4)
    close(tm.mse(T(a), T(b), T(m)),
          jm.mse(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)), 1e-6)
    close(tm.mse(T(a), T(b), T(m), reduction="none"),
          jm.mse(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m),
                 reduction="none"), 1e-6)
