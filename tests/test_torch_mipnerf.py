"""mip-NeRF on the port (``RenderConfig.model`` "mipnerf"), on the CPU at
a small size (8 rays, 8 + 8 intervals, the published D 8 / W 256), against
the benchmark's plain reference ``benchmark/reference/mipnerf.py``, which
follows google/mipnerf and imports nothing of the port, on seeded random
weights.

Tolerances: both sides compute in float32 on the CPU, the same arithmetic
in another order (the reference's mask search in place of the port's
``searchsorted``, its [h, enc] concatenation in place of the port's split
products, torch's sin / cos in place of the port's Cody-Waite sine on the
fused path), so each number is held to a few float32 roundings of its
scale: 1e-5 relative (1e-6 absolute) where a value passes through the
256-wide layers, 1e-6 where it does not.
"""
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import mipnerf as ref
from nerf_fl_torch.core import compositing, cones, encoding, sampling
from nerf_fl_torch.ops import fused_mlp as fm
from nerf_fl_torch.render import RenderConfig, render_rays
from nerf_fl_torch.training import build_params, make_device_pool_step
from nerf_fl_torch.training import optimizers as opt
from nerf_fl_torch.training.losses import mip_loss

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "mipnerf_lego.json")
                    .read_text())
N_RAYS, S = 8, 8


def _config():
    c = json.loads(json.dumps(CONFIG))
    c["render"]["N_samples"] = S
    c["train"]["batch_size"] = N_RAYS
    return c


def _rays(n=N_RAYS, seed=0):
    """n rays from 4 units out towards the origin, directions not
    normalised, the recipe's cone radius, near 2, far 6."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g)
    o = 4 * o / o.norm(dim=-1, keepdim=True)
    d = (-o / 4 + 0.2 * torch.randn(n, 3, generator=g)) \
        * (1 + torch.rand(n, 1, generator=g))
    return torch.cat([o, d, torch.full((n, 1), 5.196e-4),
                      torch.full((n, 1), 2.0), torch.full((n, 1), 6.0)], -1)


def _cfg(**kw):
    c = _config()
    m, r = c["model"], c["render"]
    return RenderConfig(model="mipnerf", N_samples=r["N_samples"],
                        perturb=1.0, white_back=True,
                        N_emb_dir=m["deg_view"], **kw)


def _params(cfg, seed=3):
    """The program's parameters holding the reference's seeded weights,
    moved off glorot's zero biases so every path is exercised."""
    w = ref.make_weights(_config(), seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    w = {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in w.items()}
    params = build_params(cfg, 1, device="cpu")
    leaves = dict(opt.named_leaves(params))
    assert set(leaves) == set(w)
    with torch.no_grad():
        for k, v in w.items():
            leaves[k].copy_(v)
    return params, w


def _close(a, b, rel=1e-5, atol=1e-6):
    a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach()
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= rel * float(b.abs().max()) + atol


def test_cast_is_the_published_frustum_gaussians():
    rays = _rays()
    t = torch.sort(2 + 4 * torch.rand(N_RAYS, S + 1,
                                      generator=torch.Generator()
                                      .manual_seed(1)), -1).values
    o, d, r = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
    mean, var = cones.cast(t, o, d, r)
    rm, rv = ref.cast_rays(t, o, d, r)
    _close(mean, rm, 1e-7, 0)
    _close(var, rv, 1e-6, 0)
    assert (var > 0).all()


def test_cone_rays_are_the_loaders():
    """A view's rays through the pixel centres, the directions not
    normalised, each cone's radius 2 / (f sqrt(12)) (the rows' directions
    are 1 / f apart), as mip-NeRF's Blender loader casts them."""
    from nerf_fl_torch.data.rays_np import get_cone_rays
    f = 0.5 * 800 / np.tan(0.5 * CONFIG["scene"]["camera_angle_x"])
    j, i = np.meshgrid(np.arange(6.0), np.arange(5.0), indexing="ij")
    dirs = np.stack([(i + 0.5 - 2.5) / f, -(j + 0.5 - 3) / f,
                     -np.ones_like(i)], -1).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.0, 0.0, 4.0]
    rays = get_cone_rays(dirs, c2w)
    assert rays.shape == (30, 7)
    np.testing.assert_allclose(rays[:, 3:6], dirs.reshape(-1, 3), rtol=0,
                               atol=0)
    np.testing.assert_allclose(rays[:, 6], 2 / (f * np.sqrt(12)), rtol=1e-4)
    np.testing.assert_allclose(rays[:, :3], [[0, 0, 4]] * 30)


@pytest.mark.parametrize("fast", [False, True])
def test_ipe_is_the_published_encoding(fast):
    g = torch.Generator().manual_seed(2)
    mean = 2 * torch.randn(50, 3, generator=g)
    var = 10 ** (-6 + 4 * torch.rand(50, 3, generator=g))
    got = encoding.integrated_pos_enc(mean, var, 16, fast=fast)
    want = ref.integrated_pos_enc(mean, var, 0, 16)
    assert got.shape == (50, 96)
    # 2^15 |m| ~ 2e5: the sine's argument alone is that many radians, so
    # the two sines may part by a float32 rounding of it where the
    # attenuation lets them through
    _close(got, want, 0, 3e-5 if fast else 1e-6)


def test_plain_field_with_ipe_is_the_published_mlp():
    """The program's plain fused forward (``fused_mlp_reference`` with the
    IPE, the f32 kernels' function) and ``apply_nerf``'s raw heads, against
    the reference's MLP on the same Gaussians and view directions."""
    cfg = _cfg()
    params, w = _params(cfg)
    g = torch.Generator().manual_seed(4)
    mean = torch.randn(N_RAYS, S, 3, generator=g)
    var = 10 ** (-6 + 3 * torch.rand(N_RAYS, S, 3, generator=g))
    vd = torch.nn.functional.normalize(torch.randn(N_RAYS, 3, generator=g),
                                       dim=-1)
    raw_rgb, raw_density = ref.mlp(
        w, CONFIG["model"], ref.integrated_pos_enc(mean, var, 0, 16),
        ref.pos_enc(vd, 4))
    model = params["nerf"]
    inp = fm.pack_ipe_inputs(mean.reshape(-1, 3),
                             vd[:, None].expand(N_RAYS, S, 3).reshape(-1, 3),
                             var.reshape(-1, 3))
    net = fm.pack_weights(model, fm.layout_for(cfg.nerf_config("mip"),
                                               torch.float32))
    sx, sd = fm.default_scale_rows(0, 4, 0)
    pre = fm.fused_mlp_reference(inp, net, sx, sd)
    _close(pre[:, :3], raw_rgb.reshape(-1, 3))
    _close(pre[:, 3], raw_density.reshape(-1))
    assert float(pre[:, 4:].abs().max()) == 0.0
    from nerf_fl_torch.models.mlp import apply_nerf
    out = apply_nerf(model, encoding.integrated_pos_enc(mean, var, 16)
                     .reshape(N_RAYS * S, -1), encoding.embed(vd, 4),
                     samples_per_ray=S, raw=True)
    _close(out["raw_rgb"], raw_rgb.reshape(-1, 3))
    _close(out["raw_sigma"], raw_density.reshape(-1))


@pytest.mark.parametrize("randomized", [True, False])
def test_both_levels_sample_as_published(randomized):
    rays = _rays()
    o, d, r = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
    near, far = rays[:, 7:8], rays[:, 8:9]
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    t = sampling.stratified_z_vals(near, far, S + 1,
                                   perturb=1.0 if randomized else 0.0,
                                   generator=g1)
    rt, _ = ref.sample_along_rays(o, d, r, S, near, far, randomized, g2)
    _close(t, rt, 0, 1e-6)
    w = torch.rand(N_RAYS, S, generator=torch.Generator().manual_seed(8))
    w[0] = 0.0          # no opacity: the padded pdf is uniform
    w[1, 2:] = 0.0      # a few intervals alone
    nt = sampling.resample_intervals(t, w, 0.01, randomized, generator=g1)
    rnt, _ = ref.resample_along_rays(o, d, r, rt, w, randomized, 0.01, g2)
    assert nt.shape == (N_RAYS, S + 1)
    _close(nt, rnt, 0, 2e-6)
    assert (nt[:, 1:] >= nt[:, :-1]).all()


def test_interval_compositing_is_the_published():
    g = torch.Generator().manual_seed(9)
    t = torch.sort(2 + 4 * torch.rand(N_RAYS, S + 1, generator=g),
                   -1).values
    sig = 3 * torch.rand(N_RAYS, S, generator=g)
    sig[0] = 0.0
    rgb = torch.rand(N_RAYS, S, 3, generator=g)
    d = torch.randn(N_RAYS, 3, generator=g)
    c = compositing.composite_intervals(t, rgb, sig, d, white_back=True)
    r_rgb, r_dist, r_acc, r_w = ref.volumetric_rendering(rgb, sig[..., None],
                                                         t, d, True)
    for a, b in ((c.rgb, r_rgb), (c.distance, r_dist), (c.acc, r_acc),
                 (c.weights, r_w)):
        _close(a, b, 1e-6, 0)
    assert float(c.distance[0]) == float(t[0, -1])


def test_loss_is_the_published_train_step_loss():
    g = torch.Generator().manual_seed(10)
    res = {"rgb_coarse": torch.rand(N_RAYS, 3, generator=g),
           "rgb_fine": torch.rand(N_RAYS, 3, generator=g)}
    px = torch.rand(N_RAYS, 3, generator=g)
    got = sum(mip_loss(res, px).values())
    want = ref.loss([(res["rgb_coarse"], 0, 0), (res["rgb_fine"], 0, 0)],
                    px, 0.1)
    _close(got, want, 1e-6, 0)
    # the squared error summed over channels, averaged over rays: 3 x MSE
    _close(mip_loss(res, px)["f_l"],
           3 * torch.mean((res["rgb_fine"] - px) ** 2), 1e-6, 0)


@pytest.mark.parametrize("use_fused", [None, True], ids=["plain", "fused"])
def test_shared_field_gradients_sum_both_levels(use_fused):
    """Both levels through one field: the program's render and loss, and
    the weight gradients its backward leaves in the one set of leaves
    (both levels' added), against the reference's autograd, on the same
    rays and draws; plain apply_nerf, or the fused pair's plain versions
    (the IPE kernels' function) with ``use_fused``."""
    cfg = _cfg(use_fused=use_fused)
    params, w = _params(cfg)
    rays = _rays()
    px = torch.rand(N_RAYS, 3, generator=torch.Generator().manual_seed(11))
    res = render_rays(params, rays, None, cfg,
                      generator=torch.Generator().manual_seed(12))
    loss = sum(mip_loss(res, px).values())
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ret = ref.render(p, _config(), rays, torch.Generator().manual_seed(12),
                     True)
    rloss = ref.loss(ret, px, 0.1)
    rloss.backward()
    _close(res["rgb_coarse"], ret[0][0])
    _close(res["rgb_fine"], ret[1][0])
    _close(res["depth_fine"], ret[1][1])
    _close(loss, rloss)
    # the fused path's Cody-Waite sine parts from torch's by up to 3e-5
    # on the encoding (test_ipe_is_the_published_encoding), which a
    # gradient sums over every point
    rel = 2e-5 if use_fused is None else 1e-4
    for name, leaf in opt.named_leaves(params):
        _close(leaf.grad, p[name].grad, rel, 1e-9)
    # the coarse level's term alone gives another gradient: both levels
    # feed the one set of leaves
    q = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ret = ref.render(q, _config(), rays, torch.Generator().manual_seed(12),
                     True)
    (0.1 * ((ret[0][0] - px) ** 2).sum() / N_RAYS).backward()
    coarse_only = q["nerf.xyz.0.weight"].grad
    full = p["nerf.xyz.0.weight"].grad
    assert float((full - coarse_only).abs().max()) > \
        1e-3 * float(full.abs().max())


def test_two_eager_pool_steps_follow_the_reference():
    """Two eager sub-steps of ``make_device_pool_step`` in mip mode (the
    pool's rays [o | d | radius | near | far], no image ids, the mip loss,
    Adam at mip-NeRF's lr) against the reference's render, loss and
    torch's Adam on the same rows and draws."""
    cfg = _cfg()
    params, w = _params(cfg)
    n = 4 * N_RAYS
    rays = _rays(n, seed=5)
    pool = {"rays": rays, "rgbs": torch.rand(
        n, 3, generator=torch.Generator().manual_seed(13))}
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(14)) \
        .to(torch.int32)
    lr = opt.mip_lr(100_000)
    c = _config()
    t = c["train"]
    assert lr == pytest.approx(ref.learning_rate_decay(
        100_000, t["lr_init"], t["lr_final"], t["max_steps"],
        t["lr_delay_steps"], t["lr_delay_mult"]), rel=1e-12)
    assert opt.mip_lr(0) == pytest.approx(5e-6, rel=1e-12)
    hp = type("H", (), {"optimizer": "adam", "lr": lr, "weight_decay": 0.0})
    optim = opt.build_optimizer(hp, opt.param_groups(
        params, opt.make_trainable_mask(params, False)))
    step = make_device_pool_step(cfg, optim, batch_size=N_RAYS,
                                 loss_name="mip")
    gen = torch.Generator().manual_seed(15)
    losses = [float(step(params, pool, perm, i, lr, 0.0, gen)["train/loss"])
              for i in range(2)]
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    adam = torch.optim.Adam(list(p.values()), lr=lr, eps=1e-8)
    rgen = torch.Generator().manual_seed(15)
    rlosses = []
    for i in range(2):
        idx = perm[i * N_RAYS:(i + 1) * N_RAYS].long()
        ret = ref.render(p, c, rays[idx], rgen, True)
        loss = ref.loss(ret, pool["rgbs"][idx], 0.1)
        adam.zero_grad()
        loss.backward()
        adam.step()
        rlosses.append(float(loss.detach()))
    # the first loss is the same rays through the same weights; the second
    # follows Adam's first update, which moves a weight by about lr
    # whatever its gradient's size (m / sqrt(v) is its sign), so a weight
    # whose gradient lies within rounding of zero moves by lr to either
    # side: the harness's reason to compare the median leaf's update
    np.testing.assert_allclose(losses[0], rlosses[0], rtol=1e-6)
    np.testing.assert_allclose(losses[1], rlosses[1], rtol=1e-4)
    with torch.no_grad():
        gaps = sorted(abs(float((leaf - w[name]).norm())
                          - float((p[name] - w[name]).norm()))
                      / float((p[name] - w[name]).norm())
                      for name, leaf in opt.named_leaves(params))
    assert gaps[len(gaps) // 2] <= 1e-4, gaps


def test_ipe_layout_packs_and_unpacks_the_skip_as_h_first():
    """Layer 5 of the IPE layout holds mip-NeRF's [h | enc] rows as [enc |
    h]; its gradient comes back in the module's order; the f32 images of
    both walks hold every weight."""
    cfg = _cfg()
    params, _ = _params(cfg)
    model = params["nerf"]
    lay = fm.layout_for(cfg.nerf_config("mip"), torch.float32)
    assert lay == fm.Layout(torch.float32, 16, 4, variant=fm.IPE)
    net = fm.pack_weights(model, lay)
    assert lay.k0 == 96 and lay.kd == 32 and len(net.ws) == 11
    assert [tuple(x.shape) for x in net.ws] == lay.shapes
    assert lay.shapes[5] == (96 + 256, 256)
    w5 = model.xyz[5].weight.detach().t()
    assert torch.equal(net.ws[5][:96], w5[256:])
    assert torch.equal(net.ws[5][96:], w5[:256])
    grads = fm.unpack_weight_grads(net.ws, net.bs, lay)
    lins = fm.field_linears(model, False)
    for lin, (dw, db) in zip(lins, zip(grads[0::2], grads[1::2])):
        assert dw.shape == lin.weight.shape and db.shape == lin.bias.shape
    assert torch.equal(grads[10], model.xyz[5].weight.detach())
    for backward in (False, True):
        image = fm.weight_image(net, backward)
        slabs, nbytes = fm.image_plan(lay, backward)
        assert image.numel() * 4 == nbytes
        hi = fm.tf32_split(torch.cat([x.reshape(-1) for x in net.ws]))[0]
        assert set(hi[hi != 0].tolist()) <= set(image.tolist())


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_ipe_plans_are_the_kernels_walks(tmp_path):
    """The header's tf::Plan walks with skip 5, the backward without the
    input cotangent's stages, compiled for the host, give the IPE layouts'
    ``image_plan`` stage heights and bytes."""
    from test_torch_f32_split import _header_plan_program, header_walks
    src = tmp_path / "plan.cpp"
    src.write_text(_header_plan_program())
    exe = tmp_path / "plan"
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", str(exe), str(src)],
                   check=True)
    lays = [fm.Layout(torch.float32, nx, nd, variant=fm.IPE)
            for nx, nd in ((16, 4), (8, 4), (18, 6))]
    assert [(lay.k0, lay.kd) for lay in lays] == [(96, 32), (48, 32),
                                                  (112, 48)]
    walks = [(lay, bw) for lay in lays for bw in (0, 1)]
    for (lay, bw), (nbytes, n, heights) in zip(walks,
                                               header_walks(exe, walks)):
        slabs, want = fm.image_plan(lay, bool(bw))
        assert nbytes == want and n == len(slabs) <= 384
        assert heights == [s.height for s in slabs]
    # the IPE backward leaves out the input cotangent's stages
    full = fm.Layout(torch.float32, 15, 4)
    assert full.k0 == 96
    assert fm.image_plan(lays[0], True)[1] < fm.image_plan(full, True)[1]


def _tiny_mip_cell():
    """The benchmark's mip-NeRF cell cut to a CPU test: 2 views of 8 x 8,
    8 + 8 intervals, batch 32, 2 sub-steps a call; every width as
    published."""
    import copy
    from benchmark import spec
    sp = spec.cell("mipnerf_lego.mip_train")
    c, t = copy.deepcopy(sp.config), copy.deepcopy(sp.traffic)
    c["render"]["N_samples"] = 8
    c["train"]["batch_size"] = 32
    c["scene"]["n_images"], c["scene"]["img_wh"] = 2, [8, 8]
    t["steps_per_execution"], t["log_every"] = 2, 2
    sp.config, sp.traffic = c, t
    return sp


def _run_tiny(fault=None, compute_dtype=None, seed=2 ** 31 + 11):
    import argparse
    from benchmark import run
    ns = argparse.Namespace(workload="mipnerf_lego.mip_train", seed=seed,
                            seconds=0.2, trace=0)
    return run.run_cell(ns, device="cpu", cell_spec=_tiny_mip_cell(),
                        fault=fault, compute_dtype=compute_dtype, t0=0.0)


def test_benchmark_cell_agrees_with_the_reference_and_catches_faults():
    """The harness's mip-NeRF cell on the CPU at a tiny size: the
    program's plain path against the reference within float32 rounding
    (2e-5 on each number: the plain path and the reference sum the same
    products in another order, and Adam's first step turns gradients
    within rounding of zero into whole steps), and each planted fault
    read as such: a frozen optimizer leaves the state unchanged (update
    gap 1), half of each batch moves the loss."""
    result, checks = _run_tiny()
    numbers = {n: v for n, v, _ in checks}
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(numbers) == {"loss_gap", "grad_norm_gap", "update_median_gap"}
    for name, value in numbers.items():
        assert value < 2e-5, (name, value, result["detail"])
    frozen = {n: v for n, v, _ in _run_tiny("frozen")[1]}
    assert frozen["update_median_gap"] == pytest.approx(1.0)
    half = {n: v for n, v, _ in _run_tiny("half_batch")[1]}
    assert half["loss_gap"] > 1e-3
