"""mip-NeRF's field on the card: the f32 fused pair's IPE kernels against
their plain versions, their run counters, a mip-NeRF sub-step on them, and
the machine code of the pair's other instances.

Marked ``cuda``: each test skips without a CUDA card.  It imports nothing
of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mipnerf_cuda.py -q

Tolerances, as tests/test_torch_cuda.py's f32 ones: forward 2e-4 absolute
(3xTF32 products against f32 ones, summed in another order); backward
1e-4 of each tensor's largest magnitude.  The backward's points with a
hidden unit whose plain pre-activation lies within 2e-6 of zero get a zero
cotangent: the kernels' products and the plain f32 products can decide
such a ReLU either way, and the IPE backward writes no input cotangent
from which ``ops/f32_ties.matched_backward`` could read the kernel's side,
so those points add nothing to any gradient on either side (at most 8% of
the points, chip_smoke.py's TIE_SHARE_MAX).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fl_torch.models import init_nerf
from nerf_fl_torch.ops import fused_mlp as fm
from nerf_fl_torch.render.renderer import RenderConfig

RAGGED = [1, 63, 65, 1001, 70_001]
RECORD = Path(__file__).resolve().parents[1] / "nerf_fl_torch" / "tools" \
    / "records" / "sass_fused_pair.json"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n, seed=0):
    """A mip-NeRF field (glorot weights, biases and weights nudged off
    their initial values) and n packed rows of Gaussians along cone
    intervals at the Blender recipe's scale."""
    cfg = RenderConfig(model="mipnerf")
    gen = torch.Generator().manual_seed(seed)
    mcfg = cfg.nerf_config("mip")
    model = init_nerf(mcfg, generator=gen, init="glorot")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    model = model.to(dev)
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-1.5, 1.5, (n, 3))
    var = 10.0 ** rng.uniform(-7, -3, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (mean, d, var)]
    inp = fm.pack_ipe_inputs(*to).contiguous()
    net = fm.pack_weights(model, fm.layout_for(mcfg, torch.float32))
    sx, sd = fm.default_scale_rows(0, 4, 0, device=dev)
    return model, inp, net, sx, sd


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED)
def test_ipe_kernel_matches_plain_on_card(n):
    dev = _card()
    _, inp, net, sx, sd = _case(dev, n)
    runs, ipe = fm.kernel_runs(dev), fm.ipe_runs(dev)
    got = fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
    ref = fm.fused_mlp_reference(inp, net, sx, sd)
    torch.cuda.synchronize()
    assert fm.kernel_runs(dev) == (runs[0] + 1, runs[1])
    assert fm.ipe_runs(dev) == (ipe[0] + 1, ipe[1])
    assert got.shape == (n, 16) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-4)
    assert float(got[:, 4:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED)
def test_ipe_bwd_kernel_matches_plain_on_card(n):
    from nerf_fl_torch.ops import f32_ties
    dev = _card()
    _, inp, net, sx, sd = _case(dev, n, seed=1)
    g = torch.zeros(n, 16, device=dev)
    g[:, :4] = torch.randn(n, 4, generator=torch.Generator().manual_seed(5)
                           ).to(dev)
    ties = f32_ties.tie_units(inp, net, sx, sd, tol=2e-6)
    tied = torch.stack([t.any(1) for t in ties.values()]).any(0)
    assert int(tied.sum()) <= max(1, 0.08 * n)
    g[tied] = 0.0
    runs, ipe = fm.kernel_runs(dev), fm.ipe_runs(dev)
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    again = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    assert fm.kernel_runs(dev) == (runs[0], runs[1] + 2)
    assert fm.ipe_runs(dev) == (ipe[0], ipe[1] + 2)
    assert got[2] is None and ref[2] is None
    for x, y, z in zip(got[0] + got[1], ref[0] + ref[1], again[0] + again[1]):
        assert x.shape == y.shape and torch.isfinite(x).all()
        assert torch.equal(x, z)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()) \
            + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 64 * 133 + 5])
def test_ipe_bwd_two_warpgroups_at_ragged_sizes_on_card(n):
    """The IPE backward's two consumer warpgroups around its 64-point tile
    and over 134 tiles with a ragged end: test_ipe_bwd_kernel_matches_plain
    _on_card's gate (tied points at a zero cotangent, 1e-4 of each tensor's
    largest) and two launches bitwise equal."""
    from nerf_fl_torch.ops import f32_ties
    dev = _card()
    _, inp, net, sx, sd = _case(dev, n, seed=2)
    g = torch.zeros(n, 16, device=dev)
    g[:, :4] = torch.randn(n, 4, generator=torch.Generator().manual_seed(6)
                           ).to(dev)
    ties = f32_ties.tie_units(inp, net, sx, sd, tol=2e-6)
    tied = torch.stack([t.any(1) for t in ties.values()]).any(0)
    assert int(tied.sum()) <= max(1, 0.08 * n)
    g[tied] = 0.0
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    again = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    for x, y, z in zip(got[0] + got[1], ref[0] + ref[1], again[0] + again[1]):
        assert x.shape == y.shape and torch.isfinite(x).all()
        assert torch.equal(x, z)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()) \
            + 1e-30


@pytest.mark.cuda
def test_ipe_kernels_refuse_bf16_and_transient_on_card():
    dev = _card()
    _, inp, net, sx, sd = _case(dev, 64)
    for bad in ({"dtype": torch.bfloat16}, {"t_dim": 16}):
        with pytest.raises(ValueError):
            fm.fused_mlp_fwd_cuda(inp, net._replace(layout=dataclasses.replace(
                net.layout, **bad)), sx, sd)


@pytest.mark.cuda
def test_mip_graph_step_runs_four_ipe_kernels_a_sub_step_on_card():
    """A mip-NeRF device-pool step of K = 3 sub-steps as a CUDA graph:
    both levels' forward and backward on the IPE kernels, 2 + 2 a
    sub-step, the graph's replays counted by the kernels, and the same
    losses as three eager steps from the same state and draws."""
    from nerf_fl_torch.training import build_params, make_device_pool_step
    from nerf_fl_torch.training import optimizers as opt
    dev = _card()
    cfg = RenderConfig(model="mipnerf", N_samples=16, perturb=1.0,
                       noise_std=0.0, white_back=True)
    B, K = 256, 3
    gen = torch.Generator(device=dev).manual_seed(3)
    n = 4 * B * K
    o = torch.randn(n, 3, device=dev, generator=gen)
    o = 4 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4 + 0.1 * torch.randn(n, 3, device=dev, generator=gen)
    rays = torch.cat([o, d, torch.full((n, 1), 5.2e-4, device=dev),
                      torch.full((n, 1), 2.0, device=dev),
                      torch.full((n, 1), 6.0, device=dev)], -1)
    pool = {"rays": rays, "rgbs": torch.rand(n, 3, device=dev,
                                             generator=gen)}
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)

    def run(graph):
        params = build_params(cfg, 1, generator=torch.Generator(dev)
                              .manual_seed(0), device=dev)
        hp = type("H", (), {"optimizer": "adam", "lr": 5e-4,
                            "weight_decay": 0.0})
        optim = opt.build_optimizer(hp, opt.param_groups(
            params, opt.make_trainable_mask(params, False)))
        step = make_device_pool_step(cfg, optim, batch_size=B,
                                     loss_name="mip",
                                     steps_per_execution=K if graph else 1)
        g = torch.Generator(dev).manual_seed(9)
        if graph:
            m = step(params, pool, perm, 0, 4, 5e-4, 0.0, g)
            return [float(v) for v in m["train/loss"]]
        return [float(step(params, pool, perm, i, 5e-4, 0.0, g)
                       ["train/loss"]) for i in range(K)]

    ipe0 = fm.ipe_runs(dev)
    eager = run(False)
    ipe1 = fm.ipe_runs(dev)
    graph = run(True)
    ipe2 = fm.ipe_runs(dev)
    assert tuple(b - a for a, b in zip(ipe0, ipe1)) == (2 * K, 2 * K)
    # the capture's eager sub-step, the capture (recorded, not run) and
    # K - 1 replays: 2 + 2 runs a sub-step that ran
    assert tuple(b - a for a, b in zip(ipe1, ipe2)) == (2 * K, 2 * K)
    np.testing.assert_allclose(graph, eager, rtol=1e-6)


def sass_digests(lib: str):
    """{kernel name (the anonymous namespace's hash masked): sha256 of its
    SASS} of a built library (``experiments/sass_diff.py``'s reading)."""
    import hashlib
    from nerf_fl_torch.experiments import sass_diff
    return {k: hashlib.sha256(v.encode()).hexdigest()
            for k, v in sass_diff.kernels(lib).items()}


@pytest.mark.cuda
def test_fused_pair_instances_keep_their_machine_code_on_card():
    """Every kernel of the fused pair's sources has the SASS recorded in
    tools/records/sass_fused_pair.json (built on the card with the same
    nvcc; re-record with ``python -m
    nerf_fl_torch.experiments.sass_diff``'s digests if nvcc changes): the
    bf16 kernels as the sources before the IPE instances and the
    two-warpgroup f32 kernels built them, and the f32 kernels (the
    backward's two instances, the forward's two and the sigma-only one) as
    the two-consumer-warpgroup design builds them."""
    _card()
    from nerf_fl_torch.ops import _build
    record = json.loads(RECORD.read_text())
    if record["nvcc"] != _nvcc_version():
        pytest.skip(f"the record is of nvcc {record['nvcc']}")
    for src, want in record["kernels"].items():
        have = sass_digests(str(_build.build([src])[src]))
        for name, digest in want.items():
            assert have.get(name) == digest, (src, name)


def _nvcc_version() -> str:
    import subprocess
    from nerf_fl_torch.ops import _build
    out = subprocess.run([_build.nvcc_path(), "--version"],
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[-1]
