"""The fused forward and backward kernels and the kernel-anatomy probes on
the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA card.  This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: f32 2e-4 (as tests/test_fused_mlp.py; on the card the two agree
exactly); bf16 3e-2, since kernel and plain version sum the same exact
products in another order and a hidden value near a rounding boundary can
land one bf16 ulp apart.  Backward: f32 1e-4 of each tensor's largest
magnitude (sums of the same products in another order); bf16 2e-2 of it,
since a one-ulp flip in a rounded cotangent moves every sum it feeds (at
the ragged sizes up to 70,001 points: 2e-2 of each tensor's norm).
Anatomy probes: the bf16 ones 4e-3 + 1e-2 |ref| with mean 5e-5 (the limits
of tests/test_torch_anatomy.py and chip_smoke.py; on an H100 at 524,288
points they read max 9.8e-4 to 3.9e-3, mean at most 6.7e-6), the f32
encoder probes 1e-6 (exact arguments on both sides and the same sinf: they
differed by 0 on an H100), sin equal to torch.sin and pe_vpu to its plain
version bit for bit, pe_only
2e-4, the consolidated net equal to the static one bit for bit.
"""
import numpy as np
import pytest
import torch

from nerf_fl_torch.models import NeRFConfig, init_nerf
from nerf_fl_torch.ops import anatomy
from nerf_fl_torch.ops import fused_mlp as fm

N = 1001                     # ragged: no multiple of the 128-point tile
# around the bf16 kernels' 128-point tile, and many tiles with a ragged end
RAGGED = [1, 127, 129, 70_001]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, a_dim=48, seed=0, n=N, nfx=10, nfd=4):
    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                                 in_channels_a=a_dim or 48,
                                 in_channels_xyz=3 + 6 * nfx,
                                 in_channels_dir=3 + 6 * nfd,
                                 encode_transient=True),
                      generator=torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (n, 3))
    dirs = rng.normal(0, 1, (n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = rng.normal(0, 1, (n, a_dim)) if a_dim else None
    t = rng.normal(0, 1, (n, 16))
    to = [None if x is None else torch.tensor(x, dtype=torch.float32,
                                              device=dev)
          for x in (xyz, dirs, a, t)]
    return model, to


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("a_dim", [48, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype, a_dim, transient):
    dev = _card()
    model, (xyz, dirs, a, t) = _inputs(dev, a_dim)
    dt = getattr(torch, dtype)
    inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
    net = fm.pack_weights(model, fm.Layout(dt, 10, 4, a_dim,
                                           16 if transient else 0))
    sx, sd = fm.default_scale_rows(10, 4, a_dim, device=dev)
    before = fm.fused_mlp_fwd_cuda.launches
    runs = fm.kernel_runs(dev)
    got = fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
    ref = fm.fused_mlp_reference(inp, net, sx, sd)
    torch.cuda.synchronize()
    assert fm.fused_mlp_fwd_cuda.launches == before + 1
    assert fm.kernel_runs(dev) == (runs[0] + 1, runs[1])
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=2e-4 if dtype == "float32" else 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("a_dim,transient", [(48, True), (0, True),
                                             (48, False), (0, False)])
@pytest.mark.parametrize("n", RAGGED)
def test_kernel_matches_plain_at_ragged_sizes_on_card(n, a_dim, transient):
    """bf16 forward at one row, one row short of a tile, one row over and
    70,001; with and without appearance (kd = 32) and the transient branch."""
    dev = _card()
    model, (xyz, dirs, a, t) = _inputs(dev, a_dim, n=n)
    inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
    net = fm.pack_weights(model, fm.Layout(torch.bfloat16, 10, 4, a_dim,
                                           16 if transient else 0))
    sx, sd = fm.default_scale_rows(10, 4, a_dim, device=dev)
    got = fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
    ref = fm.fused_mlp_reference(inp, net, sx, sd)
    torch.cuda.synchronize()
    assert got.shape == (n, 16) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-2)


@pytest.mark.cuda
def test_fwd_kernel_takes_no_points_on_card():
    dev = _card()
    model, (xyz, dirs, a, t) = _inputs(dev, n=0)
    net = fm.pack_weights(model, fm.Layout(torch.bfloat16, 10, 4, 48, 16))
    sx, sd = fm.default_scale_rows(10, 4, 48, device=dev)
    out = fm.fused_mlp_fwd_cuda(fm.pack_inputs(xyz, dirs, a, t), net, sx, sd)
    torch.cuda.synchronize()
    assert out.shape == (0, 16)


def _bwd_case(dev, dtype, transient, a_dim=48, n=N, nfx=10, nfd=4):
    model, (xyz, dirs, a, t) = _inputs(dev, a_dim, n=n, nfx=nfx, nfd=nfd)
    dt = getattr(torch, dtype)
    inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
    net = fm.pack_weights(model, fm.Layout(dt, nfx, nfd, a_dim,
                                           16 if transient else 0))
    sx, sd = fm.default_scale_rows(nfx, nfd, a_dim, device=dev)
    g = torch.zeros(n, 16, device=dev)
    g[:, :9] = torch.randn(n, 9, generator=torch.Generator().manual_seed(5)
                           ).to(dev)
    return inp, net, sx, sd, g


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_matches_plain_on_card(dtype, transient):
    """f32 within 1e-4 of each tensor's largest at every point, against
    the plain backward with the kernel's side of each unit whose plain
    pre-activation lies within f32 rounding of zero (chip_smoke.py's
    TIE_F32 and TIE_SHARE_MAX: the kernels' 3xTF32 products and the plain
    f32 products can decide that ReLU either way); bf16 2e-2."""
    from nerf_fl_torch.ops import f32_ties
    dev = _card()
    inp, net, sx, sd, g = _bwd_case(dev, dtype, transient)
    before = fm.fused_mlp_bwd_cuda.launches
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    assert fm.fused_mlp_bwd_cuda.launches == before + 1
    if dtype == "float32":
        ref, st = f32_ties.matched_backward(got[2], inp, net, sx, sd, g,
                                            tol=2e-6)
        assert st["tie_points"] <= 0.08 * st["points"], st
    else:
        ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    rel = 1e-4 if dtype == "float32" else 2e-2
    for x, y in zip(got[0] + got[1] + [got[2]], ref[0] + ref[1] + [ref[2]]):
        assert x.shape == y.shape
        assert torch.isfinite(x).all()
        assert float((x - y).abs().max()) <= rel * float(y.abs().max()) \
            + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("a_dim,transient", [(48, True), (0, True),
                                             (48, False), (0, False)])
@pytest.mark.parametrize("n", RAGGED)
def test_bwd_kernel_matches_plain_at_ragged_sizes_on_card(n, a_dim, transient):
    """bf16 backward at the sizes and shapes of the forward's ragged test,
    two launches bitwise equal at each.  The limit is chip_smoke.py's for
    bf16, ||d|| <= 2e-2 ||ref|| per tensor: among 70,001 points one bf16 ulp
    of a cotangent moves a single d_inp entry by several percent of the
    largest (the first design read 9.3e-2 there), which a max-abs limit
    cannot tell from a fault."""
    dev = _card()
    inp, net, sx, sd, g = _bwd_case(dev, "bfloat16", transient, a_dim, n)
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    again = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    for x, y, z in zip(got[0] + got[1] + [got[2]], ref[0] + ref[1] + [ref[2]],
                       again[0] + again[1] + [again[2]]):
        assert x.shape == y.shape and torch.isfinite(x).all()
        assert torch.equal(x, z)
        assert float((x - y).norm()) <= 2e-2 * float(y.norm()) + 1e-30


# frequency counts besides the flagship's 10 / 4 that fused_mlp.layout_for
# gives the kernels (6 n_xyz + 3 <= 128, 6 n_dir + 3 + a_dim <= 128):
# k0 = 48, 64, 128 and kd = 64, 80 with appearance 48
FREQS = [(nfx, nfd) for nfx in (5, 8, 20) for nfd in (2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("nfx,nfd", FREQS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_at_other_frequency_counts_on_card(dtype, nfx,
                                                               nfd):
    dev = _card()
    inp, net, sx, sd, _ = _bwd_case(dev, dtype, True, nfx=nfx, nfd=nfd)
    assert (net.layout.k0, net.layout.kd) == (-(-(3 + 6 * nfx) // 16) * 16,
                                -(-(3 + 6 * nfd + 48) // 16) * 16)
    got = fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
    ref = fm.fused_mlp_reference(inp, net, sx, sd)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=2e-4 if dtype == "float32" else 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("nfx,nfd", FREQS)
def test_bwd_kernel_matches_plain_at_other_frequency_counts_on_card(nfx, nfd):
    """bf16, the limit of the ragged test: ||d|| <= 2e-2 ||ref|| per
    tensor (the highest frequency multiplies an input's cotangent by
    2^19)."""
    dev = _card()
    inp, net, sx, sd, g = _bwd_case(dev, "bfloat16", True, nfx=nfx,
                                        nfd=nfd)
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    for x, y in zip(got[0] + got[1] + [got[2]], ref[0] + ref[1] + [ref[2]]):
        assert x.shape == y.shape and torch.isfinite(x).all()
        assert float((x - y).norm()) <= 2e-2 * float(y.norm()) + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_is_deterministic(dtype):
    dev = _card()
    inp, net, sx, sd, g = _bwd_case(dev, dtype, True)
    a = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    b = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    for x, y in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [True, False])
def test_backward_through_wrapper_fills_grads(transient):
    dev = _card()
    model, (xyz, dirs, a, t) = _inputs(dev)
    xyz.requires_grad_(True)
    a.requires_grad_(True)
    before = (fm.fused_mlp_fwd_cuda.launches, fm.fused_mlp_bwd_cuda.launches)
    runs = fm.kernel_runs(dev)
    out = fm.fused_apply_nerf(
        model, fm.Layout(torch.bfloat16, 10, 4, 48, 16 if transient else 0),
        xyz, dirs, a, t if transient else None)
    sum(v.sum() for v in out.values()).backward()
    torch.cuda.synchronize()
    assert (fm.fused_mlp_fwd_cuda.launches, fm.fused_mlp_bwd_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    assert fm.kernel_runs(dev) == (runs[0] + 1, runs[1] + 1)
    lins = fm.field_linears(model, transient)
    for lin in lins:
        for p in (lin.weight, lin.bias):
            assert p.grad is not None and p.grad.dtype == torch.float32
            assert torch.isfinite(p.grad).all()
    for x in (xyz, a):
        assert x.grad is not None and torch.isfinite(x.grad).all()


# around the f32 kernels' 64-point tile, and many tiles with a ragged end
F32_RAGGED = [1, 63, 65, 64 * 133 + 5]


def _f32_bwd_gate(got, inp, net, sx, sd, g):
    """The f32 backward's gate (test_bwd_kernel_matches_plain_on_card's):
    within 1e-4 of each tensor's largest against the plain backward with
    the kernel's side of each ReLU tie, at most 8% of points tied."""
    from nerf_fl_torch.ops import f32_ties
    ref, st = f32_ties.matched_backward(got[2], inp, net, sx, sd, g,
                                        tol=2e-6)
    assert st["tie_points"] <= max(1, 0.08 * st["points"]), st
    for x, y in zip(got[0] + got[1] + [got[2]], ref[0] + ref[1] + [ref[2]]):
        assert x.shape == y.shape and torch.isfinite(x).all()
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()) \
            + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("a_dim,transient", [(48, True), (0, False)])
@pytest.mark.parametrize("n", F32_RAGGED)
def test_f32_bwd_two_warpgroups_match_plain_at_ragged_sizes_on_card(
        n, a_dim, transient):
    """The f32 backward's two consumer warpgroups around its 64-point tile
    and over 134 tiles with a ragged end, with and without the transient
    branch: the tie-matched gate, and two launches bitwise equal."""
    dev = _card()
    inp, net, sx, sd, g = _bwd_case(dev, "float32", transient, a_dim, n)
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    again = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    for x, y in zip(got[0] + got[1] + [got[2]],
                    again[0] + again[1] + [again[2]]):
        assert torch.equal(x, y)
    _f32_bwd_gate(got, inp, net, sx, sd, g)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [63, 64 * 133 + 5])
def test_f32_bwd_leaves_d_inp_rows_past_n_on_card(n):
    """Launched on a d_inp with 64 rows past N that hold a marker, the f32
    backward writes rows 0..N-1 as the wrapper's launch does and leaves the
    marker rows as they were."""
    import ctypes
    dev = _card()
    inp, net, sx, sd, g = _bwd_case(dev, "float32", True, 48, n)
    want = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)[2]
    lib = fm._lib_bwd()
    image, grid = fm.weight_image(net, True), fm._grid(net, n, dev)
    image_bytes = image.numel() * image.element_size()
    sizes = (ctypes.c_longlong * 3)()
    assert lib.nerf_fused_mlp_bwd_sizes(0, n, grid, 10, 4, 48, 16, 1,
                                        sizes) == 0
    scratch = torch.empty(max(int(sizes[0]), 1), dtype=torch.uint8,
                          device=dev)
    partial = torch.empty(max(int(sizes[1]), 1), device=dev)
    grads = torch.empty(int(sizes[2]), device=dev)
    d_inp = torch.zeros(n + 64, fm.LANES, device=dev)
    d_inp[n:] = 7.0
    runs = fm._runs(dev)
    err = lib.nerf_fused_mlp_bwd(
        0, inp.data_ptr(), g.data_ptr(), d_inp.data_ptr(), n,
        fm._ptrs(net.bs), image.data_ptr(), image_bytes, grid,
        sx.data_ptr(), sd.data_ptr(), 10, 4, 48, 16, 1, scratch.data_ptr(),
        partial.data_ptr(), grads.data_ptr(),
        runs.data_ptr() + 8 * fm.RUN_SLOTS.index("bwd"),
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(d_inp[:n], want)
    assert bool((d_inp[n:] == 7.0).all())


@pytest.mark.cuda
def test_f32_bwd_block_is_two_consumer_warpgroups_on_card():
    """The f32 backward's block as the source defines it: 384 threads, two
    consumer warpgroups, shared memory within the card's 232,448 bytes; its
    two instances built without spills and without a ptxas C7520 line
    (wgmma serialized)."""
    from nerf_fl_torch.ops import _build
    _card()
    info = fm.kernel_block_info(torch.float32)
    assert (info["bwd_threads"], info["bwd_consumers"]) == (384, 2)
    assert info["bwd_smem"] <= 232_448
    log = _build.build_log("fused_mlp_bwd").splitlines()
    for kernel in ("fused_mlp_bwd_f32_kernel", "fused_mlp_bwd_ipe_f32_kernel"):
        at = [i for i, line in enumerate(log)
              if "Compiling entry function" in line and kernel in line]
        assert len(at) == 1, kernel
        report = " ".join(log[at[0]:at[0] + 4])
        assert "0 bytes spill stores, 0 bytes spill loads" in report, report
        assert not [line for line in log if "C7520" in line and kernel in line]


@pytest.mark.cuda
def test_f32_fwd_block_is_two_consumer_warpgroups_on_card():
    """The f32 forward side's block as the source defines it: 384 threads,
    two consumer warpgroups, shared memory within the card's 232,448
    bytes; the f32 forward, its IPE instance and the sigma-only kernel
    built without spills and without a ptxas C7520 line (wgmma
    serialized)."""
    from nerf_fl_torch.ops import _build
    _card()
    info = fm.kernel_block_info(torch.float32)
    assert (info["threads"], info["consumers"]) == (384, 2)
    assert info["fwd_smem"] <= 232_448
    log = _build.build_log("fused_mlp_fwd").splitlines()
    for kernel in ("fused_mlp_fwd_f32_kernel", "fused_mlp_fwd_ipe_f32_kernel",
                   "sigma_trunk_f32_kernel"):
        at = [i for i, line in enumerate(log)
              if "Compiling entry function" in line and kernel in line]
        assert len(at) == 1, kernel
        report = " ".join(log[at[0]:at[0] + 4])
        assert "0 bytes spill stores, 0 bytes spill loads" in report, report
        assert not [line for line in log if "C7520" in line and kernel in line]


def _sigma_case(dev, n, nfx=10, barf=None):
    """The f32 forward's operands (fine model, a_dim 0, transient) and the
    sigma-only kernel's (the positions as they are, the same packed net and
    xyz scale row)."""
    from nerf_fl_torch.core.encoding import barf_weights
    model, (xyz, dirs, _, t) = _inputs(dev, 0, n=n, nfx=nfx)
    bw = None if barf is None else barf_weights(6.0, nfx, 4, 8,
                                                schedule=barf, device=dev)
    inp = fm.pack_inputs(xyz, dirs, None, t)
    net = fm.pack_weights(model, fm.Layout(torch.float32, nfx, 4, 0, 16))
    sx, sd = fm.default_scale_rows(nfx, 4, 0, bw, device=dev)
    return xyz.contiguous(), inp, net, sx, sd


@pytest.mark.cuda
@pytest.mark.parametrize("n,nfx,barf", [(100_003, 10, None),
                                        (100_003, 5, "paper"),
                                        (0, 10, None)])
def test_sigma_kernel_is_the_f32_kernels_sigma_column_on_card(n, nfx, barf):
    """The sigma-only kernel's pre-activation equals column COL_S_SIGMA of
    the f32 fused forward's output bit for bit (the same products in the
    same order on the same accumulator), at a ragged 100,003 points and at
    none; and its plain version within the f32 limit, 2e-4."""
    dev = _card()
    xyz, inp, net, sx, sd = _sigma_case(dev, n, nfx, barf)
    got = fm.fused_sigma_cuda(xyz, net, sx)
    full = fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
    ref = fm.fused_sigma_reference(xyz, net, sx)
    torch.cuda.synchronize()
    assert got.shape == (n,) and torch.isfinite(got).all()
    assert torch.equal(got, full[:, fm.COL_S_SIGMA])
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-4)


@pytest.mark.cuda
def test_sigma_kernel_counts_its_own_runs_on_card():
    """A launch adds one to the wrapper's launches and to the kernel's own
    run count (``sigma_runs``) and leaves the fused pair's
    (``kernel_runs``) as it was."""
    dev = _card()
    xyz, _, net, sx, _ = _sigma_case(dev, N)
    fm.fused_sigma_cuda(xyz, net, sx)       # the counter
    before = fm.fused_sigma_cuda.launches
    runs, sig = fm.kernel_runs(dev), fm.sigma_runs(dev)
    fm.fused_sigma_cuda(xyz, net, sx)
    assert fm.fused_sigma_cuda.launches == before + 1
    assert fm.sigma_runs(dev) == sig + 1
    assert fm.kernel_runs(dev) == runs


@pytest.mark.cuda
def test_sigma_kernel_record_escapes_the_benchmarks_patterns_on_card():
    """Under torch.profiler the sigma-only kernel's record matches none of
    the benchmark's fused-forward, fused-backward or GEMM patterns, so the
    traced window's fused records still equal ``kernel_runs``."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark import trace
    dev = _card()
    xyz, _, net, sx, _ = _sigma_case(dev, N)
    fm.fused_sigma_cuda(xyz, net, sx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fm.fused_sigma_cuda(xyz, net, sx)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "sigma_trunk_f32_kernel" in e.key]
    assert names, [e.key for e in prof.key_averages()]
    for name in names:
        for pattern in (trace.FWD, trace.BWD, trace.GEMM):
            assert not pattern.search(name), (name, pattern.pattern)


@pytest.mark.cuda
def test_test_time_render_runs_the_sigma_kernel_on_card():
    """A test-time f32 render on the card: its coarse pass one sigma-only
    launch, its fine pass one fused forward, and the frame within 1e-4 of
    the plain MLP path's (tests/test_torch_render.py's limit)."""
    from dataclasses import replace
    from nerf_fl_torch.render import RenderConfig, render_rays
    from nerf_fl_torch.training import build_params
    dev = _card()
    cfg = RenderConfig(N_samples=64, N_importance=64, encode_a=True,
                       encode_t=True, white_back=True, perturb=0.0,
                       noise_std=0.0, beta_min=0.1)
    params = build_params(cfg, 5, generator=torch.Generator().manual_seed(0),
                          device=dev)
    rng = np.random.default_rng(6)
    o = rng.normal(0, 0.5, (512, 3))
    d = rng.normal(0, 1, (512, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = torch.tensor(np.concatenate(
        [o, d, np.full((512, 1), 2.0), np.full((512, 1), 6.0)], 1),
        dtype=torch.float32, device=dev)
    ts = torch.zeros(512, dtype=torch.int64, device=dev)
    before = (fm.fused_sigma_cuda.launches, fm.fused_mlp_fwd_cuda.launches)
    with torch.no_grad():
        got = render_rays(params, rays, ts, cfg, test_time=True)
        ref = render_rays(params, rays, ts, replace(cfg, use_fused=False),
                          test_time=True)
    torch.cuda.synchronize()
    assert (fm.fused_sigma_cuda.launches, fm.fused_mlp_fwd_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got["rgb_fine"], ref["rgb_fine"], rtol=0,
                               atol=1e-4)


def _probe_ops(name, dev, n=N, seed=0):
    if name in ("static", "full", "consol"):
        return anatomy.net_inputs(anatomy.net_operands(n, seed, dev), name)
    if name == "pe_only":
        return anatomy.encoder_rows(dev) \
            + [anatomy.net_operands(n, seed, dev)["inp"]]
    c = anatomy.chain_operands(n, seed, dev)
    if name in ("chain8", "concat", "split"):
        return anatomy.chain_inputs(c, name != "chain8")
    return ([] if name == "sin" else anatomy.pe_mm_rows(dev)) + [c["x128"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["static", "full", "consol", "chain8",
                                  "concat", "split", "pe_mm", "pe_vpu", "sin",
                                  "pe_mm_bf16", "pe_only"])
def test_anatomy_probe_matches_plain_on_card(name):
    dev = _card()
    probe = anatomy.PROBES[name]
    ops = _probe_ops(name, dev)
    before = probe.launches
    got = probe(*ops)                     # CUDA operands: the kernel
    ref = probe.plain(*ops)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert got.shape == ref.shape == (N, 128) and torch.isfinite(got).all()
    diff = (got - ref).abs()
    if name in ("pe_mm", "pe_vpu", "sin", "pe_mm_bf16"):
        assert float(diff.max()) <= 1e-6
    elif name == "pe_only":
        assert float(diff.max()) <= 2e-4
    else:
        assert bool((diff <= 4e-3 + 1e-2 * ref.abs()).all())
        assert float(diff.mean()) <= 5e-5


@pytest.mark.cuda
def test_anatomy_consol_equals_static_on_card():
    dev = _card()
    o = anatomy.net_operands(N, 0, dev)
    a = anatomy.PROBES["static"](*anatomy.net_inputs(o, "static"))
    b = anatomy.PROBES["consol"](*anatomy.net_inputs(o, "consol"))
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_anatomy_probe_refuses_bad_operands_on_card():
    dev = _card()
    ops = _probe_ops("chain8", dev)
    with pytest.raises(ValueError, match="operand 16"):
        anatomy.PROBES["chain8"](*ops[:-1], ops[-1].float())
    with pytest.raises(ValueError, match="operand 0"):
        anatomy.PROBES["chain8"](ops[0].cpu(), *ops[1:])


def _assert_probe_bf16_close(got, ref):
    diff = (got - ref).abs()
    assert bool((diff <= 4e-3 + 1e-2 * ref.abs()).all())
    assert float(diff.mean()) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0] + RAGGED[:2] + [128] + RAGGED[2:])
def test_anatomy_concat_matches_plain_at_ragged_sizes_on_card(n):
    """The concat kernel (the Hopper block, 128-point tiles) around its tile
    and over many tiles with a ragged end; rows past n are never written."""
    dev = _card()
    ops = _probe_ops("concat", dev, n=n, seed=2)
    got = anatomy.PROBES["concat"](*ops)
    ref = anatomy.PROBES["concat"].plain(*ops)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (n, 128)
    if n:
        assert torch.isfinite(got).all()
        _assert_probe_bf16_close(got, ref)


@pytest.mark.cuda
def test_anatomy_concat_is_deterministic_and_plan_agrees_on_card():
    dev = _card()
    plan = anatomy.chain_plan(1)
    slabs, nbytes = anatomy.chain_image_plan()
    assert (plan["slabs"], plan["image_bytes"]) == (34, nbytes)
    assert plan["off"] == [s.at for s in slabs]
    assert plan["bytes"] == [32768] * 34
    assert (plan["rows"], plan["threads"], plan["stages"]) == (128, 384, 2)
    assert plan["smem"] <= 232448
    ops = _probe_ops("concat", dev, n=70_001, seed=3)
    a = anatomy.PROBES["concat"](*ops)
    b = anatomy.PROBES["concat"](*ops)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 70_001])
@pytest.mark.parametrize("name", ["chain8", "split"])
def test_anatomy_chain_matches_plain_at_ragged_sizes_on_card(name, n):
    """chain8 and split on the Hopper block (128-point tiles) around their
    tile and over many tiles with a ragged end; rows past n are zero on
    load and never written."""
    dev = _card()
    ops = _probe_ops(name, dev, n=n, seed=2)
    before = anatomy.PROBES[name].launches
    got = anatomy.PROBES[name](*ops)
    ref = anatomy.PROBES[name].plain(*ops)
    torch.cuda.synchronize()
    assert anatomy.PROBES[name].launches == before + 1
    assert got.shape == ref.shape == (n, 128)
    if n:
        assert torch.isfinite(got).all()
        _assert_probe_bf16_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain8", "split"])
def test_anatomy_chain_is_deterministic_and_plan_agrees_on_card(name):
    dev = _card()
    skip = anatomy.PROBES[name].variant
    plan = anatomy.chain_plan(skip)
    slabs, nbytes = anatomy.chain_image_plan(name == "split")
    k = 34 if name == "split" else 32
    assert (plan["slabs"], plan["image_bytes"]) == (k, nbytes)
    assert plan["off"] == [s.at for s in slabs]
    assert plan["bytes"] == [32768] * k
    assert (plan["rows"], plan["threads"], plan["stage_bytes"]) \
        == (128, 384, 32768)
    tiles = 6 if name == "split" else 4
    assert plan["smem"] == 1024 + 2 * tiles * 8192 + plan["stages"] * 32784
    assert plan["smem"] <= 232448
    ops = _probe_ops(name, dev, n=70_001, seed=3)
    a = anatomy.PROBES[name](*ops)
    b = anatomy.PROBES[name](*ops)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain8", "concat", "split"])
def test_anatomy_chain_launcher_refuses_a_missing_image_on_card(name):
    """The chain kernels stream their weights only from the image: the
    launcher returns cudaErrorInvalidValue (1) without one, or with one
    that is not 16-byte aligned, and launches nothing."""
    import ctypes
    dev = _card()
    probe = anatomy.PROBES[name]
    ops = _probe_ops(name, dev, n=129)
    ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    out = torch.zeros((129, 128), device=dev)
    image = probe.scratch(ops)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = anatomy._launcher("anatomy_chain")
    for bad in (None, image.data_ptr() + 2):
        assert launch(probe.variant, ptrs, out.data_ptr(), 129, bad,
                      stream) == 1
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [129, 70_001])
def test_anatomy_split_agrees_with_concat_on_card(n):
    """The two ways of the skip on the same operands: one product over the
    copied [x[:, :128] | h], or two into one accumulator; the same products
    summed in another order."""
    dev = _card()
    ops = _probe_ops("split", dev, n=n, seed=4)
    split = anatomy.PROBES["split"](*ops)
    concat = anatomy.PROBES["concat"](*ops)
    torch.cuda.synchronize()
    _assert_probe_bf16_close(split, concat)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 70_001])
@pytest.mark.parametrize("name", ["static", "full", "consol"])
def test_anatomy_net_matches_plain_at_ragged_sizes_on_card(name, n):
    """The net kernel (the Hopper block, 128-point tiles) around its tile
    and over many tiles with a ragged end; rows past n are never written."""
    dev = _card()
    ops = _probe_ops(name, dev, n=n, seed=2)
    before = anatomy.PROBES[name].launches
    got = anatomy.PROBES[name](*ops)
    ref = anatomy.PROBES[name].plain(*ops)
    torch.cuda.synchronize()
    assert anatomy.PROBES[name].launches == before + 1
    assert got.shape == ref.shape == (n, 128)
    if n:
        assert torch.isfinite(got).all()
        _assert_probe_bf16_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [False, True])
def test_anatomy_net_is_deterministic_and_plan_agrees_on_card(transient):
    dev = _card()
    plan = anatomy.net_plan(transient)
    slabs, nbytes = anatomy.net_image_plan(transient)
    assert (plan["slabs"], plan["image_bytes"]) \
        == (66 if transient else 52, nbytes)
    assert plan["off"] == [s.at for s in slabs]
    assert plan["bytes"] == [s.height * 128 for s in slabs]
    assert (plan["rows"], plan["threads"], plan["stages"],
            plan["stage_bytes"]) == (128, 384, 3, 32768)
    assert plan["smem"] == 210_992
    o = anatomy.net_operands(70_001, 3, dev)
    name = "full" if transient else "static"
    a = anatomy.PROBES[name](*anatomy.net_inputs(o, name))
    b = anatomy.PROBES[name](*anatomy.net_inputs(o, name))
    assert torch.equal(a, b)
    if not transient:
        c = anatomy.PROBES["consol"](*anatomy.net_inputs(o, "consol"))
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 70_001])
def test_anatomy_sin_equals_torch_sin_on_card(n):
    dev = _card()
    x = anatomy.chain_operands(n, 4, dev)["x128"] * 50.0
    before = anatomy.PROBES["sin"].launches
    got = anatomy.PROBES["sin"](x)
    torch.cuda.synchronize()
    assert anatomy.PROBES["sin"].launches == before + 1
    assert got.shape == (n, 128) and torch.equal(got, torch.sin(x))


def _vpu_rows(kind, dev):
    """P, ph, trg, s: the probe's (trig columns 3-62, so two of a row's four
    32-column warp shares hold none), or a dense P's first three rows and
    phases with trig columns in every share."""
    rows = anatomy.pe_mm_rows(dev)
    if kind == "every_share":
        rng = np.random.default_rng(8)
        P = np.zeros((128, 128), np.float32)
        P[:3] = rng.normal(0, 4, (3, 128))
        trg = np.zeros((1, 128), np.float32)
        trg[0, 5::11] = 1.0
        rows[:3] = [torch.from_numpy(a).to(dev) for a in (
            P, rng.normal(0, 1, (1, 128)).astype(np.float32), trg)]
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["probe", "every_share"])
@pytest.mark.parametrize("n", [0, 1, 17, 524_289])
def test_anatomy_pe_vpu_equals_plain_bit_for_bit_on_card(n, rows):
    """The float4 layout with its warp-uniform skip of sinf: around the
    64-row tile and over many tiles with a ragged end, bit for bit the
    plain version, whichever shares hold trig columns."""
    dev = _card()
    ops = _vpu_rows(rows, dev) + [_probe_ops("pe_vpu", dev, n=n,
                                                 seed=5)[-1]]
    probe = anatomy.PROBES["pe_vpu"]
    before = probe.launches
    got = probe(*ops)
    ref = probe.plain(*ops)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert got.shape == (n, 128) and torch.equal(got, ref)


@pytest.mark.cuda
def test_anatomy_pe_vpu_launcher_refuses_unaligned_operands_on_card():
    """pe_vpu loads and stores float4s: the launcher returns
    cudaErrorInvalidValue (1) for an operand or an output that is not
    16-byte aligned, and launches nothing."""
    import ctypes
    dev = _card()
    ops = _probe_ops("pe_vpu", dev, n=129)
    out = torch.zeros((129 * 128 + 4,), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = anatomy._launcher("anatomy_pe")
    for bad in range(len(ops) + 1):
        ptrs = [t.data_ptr() for t in ops] + [out.data_ptr()]
        ptrs[bad] += 4
        assert launch(1, (ctypes.c_void_p * len(ops))(*ptrs[:-1]), ptrs[-1],
                      129, None, stream) == 1
    torch.cuda.synchronize()
    assert not out.any()


# the PE-matmul probes on the Hopper block: pe_mm (3 bf16 terms, six
# passes) and pe_mm_bf16 (1 term)
PE_MM = ["pe_mm", "pe_mm_bf16"]
# a dense P through pe_mm against a float64 product: |E - x @ P| <= PE_DENSE
# * 2^-24 * sum_k |x_k P_kc| (tests/test_torch_pe_image.py states why)
PE_DENSE = 16.0


def _pe_probe_call(name, P, x, trg=None):
    """The probe's output for f32 x (n, 128) and P with ph 0, s 1 and trg
    (default: the probe's rows, so the epilogue runs; zeros: out is E)."""
    rows = anatomy.pe_mm_rows(x.device)
    rows[0] = P
    rows[1] = torch.zeros_like(rows[1])
    if trg is not None:
        rows[2] = trg
    return anatomy.PROBES[name](*rows, x)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 63, 64, 127, 128, 129, 70_001])
@pytest.mark.parametrize("name", PE_MM)
def test_anatomy_pe_mm_matches_plain_at_ragged_sizes_on_card(name, n):
    """Around the 64-row warpgroup and the 128-point tile and over many
    tiles with a ragged end: rows past n are zero on load and never
    written; the f32 gate of the probes (atol 1e-6)."""
    dev = _card()
    ops = _probe_ops(name, dev, n=n, seed=2)
    probe = anatomy.PROBES[name]
    before = probe.launches
    got = probe(*ops)
    ref = probe.plain(*ops)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert got.shape == ref.shape == (n, 128)
    if n:
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= 1e-6


def _binade_edges(dev):
    """Powers of two, the values just under them, their negatives, and the
    probe's input times 50, as (n, 128) f32."""
    k = torch.arange(-60, 61, dtype=torch.float64)
    p2 = torch.pow(2.0, k).float()
    under = torch.nextafter(p2, torch.zeros_like(p2))
    vals = torch.cat([p2, under, -p2, -under])
    reps = -(-128 * 8 // vals.numel())
    edges = vals.repeat(reps)[:128 * 8].reshape(8, 128)
    x50 = anatomy.chain_operands(1000, 7)["x128"] * 50.0
    return torch.cat([edges, edges.roll(1, 1), x50]).to(dev)


@pytest.mark.cuda
def test_anatomy_pe_mm_is_x_at_P_bit_for_bit_on_card():
    """At the probe's P every output of E sums at most three exact,
    disjoint products, so the six passes give x @ P exactly: with trg 0 and
    s 1 the probe's output is E."""
    dev = _card()
    x = _binade_edges(dev)
    P = anatomy.pe_mm_rows(dev)[0]
    E = _pe_probe_call("pe_mm", P, x, torch.zeros(1, 128, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(E, x @ P)
    # and through the epilogue: the plain version, bit for bit
    rows = anatomy.pe_mm_rows(dev)
    assert torch.equal(anatomy.PROBES["pe_mm"](*rows, x),
                       anatomy.PROBES["pe_mm"].plain(*rows, x))


@pytest.mark.cuda
def test_anatomy_pe_mm_dense_P_within_the_stated_bound_on_card():
    """A dense N(0, 1) P: an f32-accurate product (the CPU model reads ~2
    of the bound's units, a missing or doubled pass over 100)."""
    dev = _card()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1, (4099, 128)).astype(np.float32))
    P = torch.from_numpy(rng.normal(0, 1, (128, 128)).astype(np.float32))
    E = _pe_probe_call("pe_mm", P.to(dev), x.to(dev),
                       torch.zeros(1, 128, device=dev)).cpu().double()
    ref = x.double() @ P.double()
    unit = 2.0 ** -24 * (x.double().abs() @ P.double().abs())
    assert float(((E - ref).abs() / unit).max()) <= PE_DENSE


@pytest.mark.cuda
@pytest.mark.parametrize("name", PE_MM)
def test_anatomy_pe_mm_is_deterministic_and_plan_agrees_on_card(name):
    dev = _card()
    terms = anatomy.PE_TERMS[name]
    plan = anatomy.pe_plan(terms)
    slabs, nbytes = anatomy.pe_image_plan(terms)
    assert (plan["slabs"], plan["image_bytes"]) == (2 * terms, nbytes)
    assert plan["off"] == [s.at for s in slabs]
    assert plan["bytes"] == [16384] * (2 * terms)
    assert (plan["rows"], plan["threads"], plan["stages"],
            plan["stage_bytes"]) == (128, 256, 0, 16384)
    assert plan["smem"] == 1024 + 2 * terms * 16384 + terms * 32768 \
        + 3 * 512 + 8
    ops = _probe_ops(name, dev, n=70_001, seed=3)
    a = anatomy.PROBES[name](*ops)
    b = anatomy.PROBES[name](*ops)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PE_MM)
def test_anatomy_pe_mm_launcher_refuses_a_missing_image_on_card(name):
    """The pe_mm kernel reads P only from its image: the launcher returns
    cudaErrorInvalidValue (1) without one, or with one that is not 16-byte
    aligned, and launches nothing."""
    import ctypes
    dev = _card()
    probe = anatomy.PROBES[name]
    ops = _probe_ops(name, dev, n=129)
    ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    out = torch.zeros((129, 128), device=dev)
    image = probe.scratch(ops)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = anatomy._launcher("anatomy_pe")
    for bad in (None, image.data_ptr() + 2):
        assert launch(probe.variant, ptrs, out.data_ptr(), 129, bad,
                      stream) == 1
    torch.cuda.synchronize()
    assert not out.any()


# ``steps_per_execution`` on the card: the train step captured as a CUDA
# graph and replayed, against the eager step, from the same weights,
# generator seed and batches (the flagship's widths at 16 + 16 samples and
# 256 rays a batch, perturb 1, so every sub-step draws from the generator)
GRAPH_K, GRAPH_B = 4, 256


def _graph_case_cfg(dtype="bfloat16"):
    from nerf_fl_torch.render import RenderConfig
    return RenderConfig(N_samples=16, N_importance=16, encode_a=True,
                        encode_t=True, white_back=True, perturb=1.0,
                        noise_std=0.0, compute_dtype=dtype)


# camera-frame rays: four cameras with sparse image ids, their poses in the
# (frozen) learned-pose table
CAMDIR_IDS = [1, 2, 5, 7]


def _graph_case(dtype, steps, pool, loss_name="nerfw", camdir=False,
                barf=None, optimizer=("adam", 0.0, 0.0), mesh=None):
    """``barf``: None, or BARF's schedule ("fork" / "paper"), which trains
    the pose deltas (camdir rays) at lr x 0.5 after a warmup of 1 epoch;
    ``optimizer``: (name, weight decay, momentum); ``mesh``: a tensor-
    parallel mesh (``parallel.make_mesh``) whose shards this rank trains."""
    from dataclasses import replace
    from types import SimpleNamespace
    from nerf_fl_torch.training import optimizers, system
    dev = _card()
    cfg = _graph_case_cfg(dtype)
    if barf:
        camdir = True
        cfg = replace(cfg, refine_pose=True, barf_schedule=barf,
                      barf_epoch_start=0, barf_epoch_end=2)
    rng = np.random.default_rng(3)
    init = idmap = None
    if camdir:
        init = np.tile(np.eye(4, dtype=np.float32), (len(CAMDIR_IDS), 1, 1))
        init[:, :3, :3] = np.linalg.qr(rng.normal(
            0, 1, (len(CAMDIR_IDS), 3, 3)))[0]
        init[:, :3, 3] = rng.normal(0, 0.5, (len(CAMDIR_IDS), 3))
        idmap = np.zeros(8, np.int32)
        idmap[CAMDIR_IDS] = np.arange(len(CAMDIR_IDS))
    params = system.build_params(cfg, 8, device=dev,
                                 generator=torch.Generator().manual_seed(0),
                                 init_poses=init)
    mask = optimizers.make_trainable_mask(params, bool(barf))
    for name, p in optimizers.named_leaves(params):
        p.requires_grad_(mask[name])
    name, wd, momentum = optimizer
    opt = optimizers.build_optimizer(
        SimpleNamespace(optimizer=name, lr=5e-4, weight_decay=wd,
                        momentum=momentum),
        optimizers.param_groups(params, mask))
    kw = dict(loss_name=loss_name, steps_per_execution=steps)
    if camdir:
        kw.update(ray_format="camdir", id_to_cam=idmap)
    if barf:
        kw.update(pose_lr_mult=0.5, pose_warmup_epochs=1.0)
    if mesh is not None:
        from nerf_fl_torch.parallel import place_params
        place_params(mesh, params, True, opt)
        kw.update(mesh=mesh)
    step = system.make_device_pool_step(cfg, opt, batch_size=GRAPH_B, **kw) \
        if pool else system.make_train_step(cfg, opt, **kw)
    n = 2 * GRAPH_K * GRAPH_B
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (n, 3)), d, np.full((n, 1), 2.0),
                           np.full((n, 1), 6.0)], 1)
    ts = rng.integers(0, 8, n)
    if camdir:
        rays = rays[:, 3:]
        ts = rng.choice(CAMDIR_IDS, n)
    data = {"rays": torch.tensor(rays, dtype=torch.float32, device=dev),
            "ts": torch.tensor(ts, device=dev),
            "rgbs": torch.tensor(0.5 + 0.4 * d, dtype=torch.float32,
                                 device=dev)}
    gen = torch.Generator(device=dev).manual_seed(1)
    return params, opt, step, data, gen


def _run_graph_case(dtype, steps, pool, n_steps, camdir=False, barf=None,
                    optimizer=("adam", 0.0, 0.0), mesh=None):
    """n_steps steps, K = 1 one by one or K at a time with the last call's
    tail masked; returns params, the optimizer's state, the loss of each
    step and the step function.  The steps of the first GRAPH_K train at
    epoch 0.75, the rest at 1.25 (with ``barf``, on either side of the pose
    warmup)."""
    from nerf_fl_torch.training import optimizers, system
    params, opt, step, data, gen = _graph_case(dtype, steps, pool,
                                               camdir=camdir, barf=barf,
                                               optimizer=optimizer, mesh=mesh)
    B = GRAPH_B
    perm = torch.arange(data["rays"].shape[0], dtype=torch.int32,
                        device=data["rays"].device).flip(0)
    losses = []
    for i0 in range(0, n_steps, steps):
        ep = 0.75 if i0 < GRAPH_K else 1.25
        if steps == 1 and pool:
            losses.append(step(params, data, perm, i0, 5e-4, ep,
                               generator=gen)["train/loss"])
        elif steps == 1:
            idx = perm[i0 * B:(i0 + 1) * B].long()
            losses.append(step(params, {k: v.index_select(0, idx)
                                        for k, v in data.items()}, 5e-4, ep,
                               generator=gen)["train/loss"])
        elif pool:
            m = step(params, data, perm, i0, n_steps, 5e-4, ep,
                     generator=gen)
            losses += list(m["train/loss"][:n_steps - i0])
        else:
            group = []
            for i in range(i0, min(i0 + steps, n_steps)):
                idx = perm[i * B:(i + 1) * B].long()
                group.append({k: v.index_select(0, idx)
                              for k, v in data.items()})
            stacked, valid = system.stack_batches(group, steps)
            m = step(params, stacked, 5e-4, ep, generator=gen, valid=valid)
            assert bool(m["train/loss"][len(group):].isnan().all())
            losses += list(m["train/loss"][:len(group)])
    torch.cuda.synchronize()
    state = [opt.state[p] for g in opt.param_groups for p in g["params"]]
    return ([p.detach().clone() for _, p in optimizers.named_leaves(params)],
            state, torch.stack(losses), step)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_k_step_equals_eager_steps_on_card(dtype, pool):
    """Seven steps as two K = 4 calls (the second's last sub-step masked)
    replayed from a CUDA graph, against seven eager steps: parameters,
    Adam state and losses bit for bit (the same kernels in the same order,
    the generator's Philox offset advanced alike), and the masked sub-step
    took no step."""
    n = 2 * GRAPH_K - 1
    p1, s1, l1, _ = _run_graph_case(dtype, 1, pool, n)
    pk, sk, lk, step = _run_graph_case(dtype, GRAPH_K, pool, n)
    assert step.graph.captures == 1
    assert torch.equal(l1, lk)
    for a, b in zip(p1, pk):
        assert torch.equal(a, b)
    for a, b in zip(s1, sk):
        assert int(a["step"]) == int(b["step"]) == n
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def _tp_graph_rank(device, dtype):
    """One rank of two sharing the card over gloo (data 1 x model 2): seven
    pool steps one a call, then as two K = 4 calls; this rank's shards,
    Adam state and losses each way, and the K-step's counts and cut plan."""
    from nerf_fl_torch.parallel import make_mesh, multihost
    mesh = make_mesh(1, 2, devices=multihost.job_devices(device))
    out = []
    for steps in (1, GRAPH_K):
        p, s, losses, step = _run_graph_case(dtype, steps, True,
                                             2 * GRAPH_K - 1, mesh=mesh)
        out.append(([x.cpu() for x in p],
                    [{k: v.cpu() for k, v in st.items()} for st in s],
                    losses.cpu()))
    g = step.graph
    return out, g.captures, g.replays, g.pieces.plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_graph_k_step_equals_eager_steps_on_card(dtype):
    """Tensor parallelism (two ranks sharing the card over gloo): the K-step
    captured as one graph a piece between the sub-step's collectives and
    replayed with the collectives between the pieces, against the same
    ranks' eager steps: shards, Adam state and losses bit for bit; one
    capture and K - 1 replays a call; both ranks cut at the same 24
    collectives (tests/test_torch_tp_graph.py counts them)."""
    _card()
    from nerf_fl_torch.parallel import launch
    dev = torch.device("cuda", 0)
    ranks = launch.spawn(_tp_graph_rank, (dtype,), devices=[dev, dev],
                         timeout=600)
    for (one, k), captures, replays, plan in ranks:
        assert captures == 1 and replays == 2 * (GRAPH_K - 1)
        assert torch.equal(one[2], k[2])
        for a, b in zip(one[0], k[0]):
            assert torch.equal(a, b)
        for a, b in zip(one[1], k[1]):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[n], b[n]) for n in a)
        assert plan == ranks[0][3] and len(plan) == 24


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
def test_camdir_graph_k_step_equals_eager_steps_on_card(pool):
    """Camera-frame rays (5 columns, sparse image ids) posed inside the
    step from the frozen pose table: seven steps as two K = 4 graph calls
    against seven eager steps, bit for bit, one capture; the pose table
    (in the leaves, its buffer apart) never moves."""
    n = 2 * GRAPH_K - 1
    p1, s1, l1, _ = _run_graph_case("bfloat16", 1, pool, n, camdir=True)
    pk, sk, lk, step = _run_graph_case("bfloat16", GRAPH_K, pool, n,
                                       camdir=True)
    assert step.graph.captures == 1
    assert torch.equal(l1, lk) and bool(torch.isfinite(lk).all())
    for a, b in zip(p1, pk):
        assert torch.equal(a, b)
    # the leaves end with learn_poses.r / .t: still zero
    assert not any(bool(t.abs().max() > 0) for t in pk[-2:])
    assert len(s1) == len(sk) == len(p1) - 2


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
@pytest.mark.parametrize("schedule", ["fork", "paper"])
def test_barf_graph_k_step_equals_eager_steps_on_card(schedule, pool):
    """BARF with trained pose deltas: BARF's weights and the pose warmup
    read the epoch tensor that each call fills, so two K = 4 graph calls
    at epochs 0.75 and 1.25 equal seven eager steps at those epochs bit
    for bit, with one capture, and the deltas move once the warmup ends.
    The fork schedule's frequencies reach the graph
    as a tensor made before the capture (a host copy cannot be captured)."""
    n = 2 * GRAPH_K - 1
    p1, s1, l1, _ = _run_graph_case("bfloat16", 1, pool, n, barf=schedule)
    pk, sk, lk, step = _run_graph_case("bfloat16", GRAPH_K, pool, n,
                                       barf=schedule)
    assert step.graph.captures == 1
    assert torch.equal(l1, lk) and bool(torch.isfinite(lk).all())
    for a, b in zip(p1, pk):
        assert torch.equal(a, b)
    for a, b in zip(s1, sk):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
    # the leaves end with learn_poses.r / .t: moved after the warmup
    assert all(bool(t.abs().max() > 0) for t in pk[-2:])


@pytest.mark.cuda
def test_graph_is_captured_once_a_key_and_launches_the_fused_kernels():
    """The graph is captured at the first call, replayed after, captured
    again for another batch shape; at capture one sub-step launches the
    fused forward and backward twice each (coarse and fine).  The wrappers
    count the eager first sub-step's launches and the capture's, the graph
    its replays, and the kernels on the card every run: 2 + 2 a sub-step."""
    from nerf_fl_torch.training import system
    params, _, step, data, gen = _graph_case("bfloat16", GRAPH_K, False)

    def stacked(b):
        return system.stack_batches([{k: v[i * b:(i + 1) * b]
                                      for k, v in data.items()}
                                     for i in range(GRAPH_K)])[0]

    assert step.graph.captures == 0
    before = (fm.fused_mlp_fwd_cuda.launches, fm.fused_mlp_bwd_cuda.launches)
    runs = fm.kernel_runs()
    for _ in range(2):
        step(params, stacked(GRAPH_B), 5e-4, generator=gen)
    after = fm.kernel_runs()
    assert step.graph.captures == 1
    assert step.graph.fused_launches == (2, 2)
    assert (fm.fused_mlp_fwd_cuda.launches - before[0],
            fm.fused_mlp_bwd_cuda.launches - before[1]) == (4, 4)
    assert step.graph.replays == 2 * GRAPH_K - 1
    assert (after[0] - runs[0], after[1] - runs[1]) == (4 * GRAPH_K,
                                                        4 * GRAPH_K)
    m = step(params, stacked(GRAPH_B // 2), 5e-4, generator=gen)
    assert step.graph.captures == 2
    assert bool(torch.isfinite(m["train/loss"]).all())


@pytest.mark.cuda
def test_graph_captures_beside_a_live_graph_of_the_callers_on_card():
    """A live autograd graph that the caller made on the default stream
    holds the parameters' grad accumulators, which keep that stream; the
    graph step still captures (its sub-step trains new leaves on the
    parameters' storage) and equals the eager step bit for bit."""
    from nerf_fl_torch.render import render_rays
    from nerf_fl_torch.training import losses, optimizers, system
    runs = []
    for steps in (1, GRAPH_K):
        params, opt, step, data, gen = _graph_case("bfloat16", steps, False)
        b = {k: v[:GRAPH_B] for k, v in data.items()}
        res = render_rays(params, b["rays"], b["ts"], _graph_case_cfg())
        sum(losses.nerfw_loss(res, b["rgbs"]).values()).backward()
        batches = [{k: v[i * GRAPH_B:(i + 1) * GRAPH_B]
                    for k, v in data.items()} for i in range(GRAPH_K)]
        if steps == 1:
            for bt in batches:
                step(params, bt, 5e-4, generator=gen)
        else:
            step(params, system.stack_batches(batches)[0], 5e-4,
                 generator=gen)
            assert step.graph.captures == 1
        torch.cuda.synchronize()
        runs.append([p.detach().clone()
                     for _, p in optimizers.named_leaves(params)])
        del res
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_capture_failure_raises_on_card(monkeypatch):
    """A sub-step that syncs with the host cannot be captured: the call
    raises, and no graph is kept (no eager fallback)."""
    from nerf_fl_torch.training import losses, system

    def syncing_loss(results, targets):
        d = losses.nerfw_loss(results, targets)
        float(d["c_l"])            # a host read: illegal under capture
        return d

    monkeypatch.setitem(losses.loss_dict, "syncing", syncing_loss)
    dev = _card()
    params, _, step, data, gen = _graph_case("bfloat16", GRAPH_K, False,
                                             loss_name="syncing")
    st, _ = system.stack_batches([{k: v[i * GRAPH_B:(i + 1) * GRAPH_B]
                                   for k, v in data.items()}
                                  for i in range(GRAPH_K)])
    with pytest.raises(RuntimeError):
        step(params, st, 5e-4, generator=gen)
    torch.cuda.synchronize(dev)
    assert step.graph.captures == 0 and step.graph.graph is None


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True], ids=["host_fed", "pool"])
@pytest.mark.parametrize("wd,momentum", [(0.0, 0.0), (1e-4, 0.9)])
def test_sgd_graph_k_step_equals_eager_steps_on_card(wd, momentum, pool):
    """The port's capturable SGD (a device lr, the momentum buffer updated
    in place): seven steps as two K = 4 graph calls against seven eager
    steps, parameters, momentum buffers and losses bit for bit, one
    capture."""
    n = 2 * GRAPH_K - 1
    sgd = ("sgd", wd, momentum)
    p1, s1, l1, _ = _run_graph_case("bfloat16", 1, pool, n, optimizer=sgd)
    pk, sk, lk, step = _run_graph_case("bfloat16", GRAPH_K, pool, n,
                                       optimizer=sgd)
    assert step.graph.captures == 1
    assert torch.equal(l1, lk) and bool(torch.isfinite(lk).all())
    for a, b in zip(p1, pk):
        assert torch.equal(a, b)
    assert len(s1) == len(sk)
    for a, b in zip(s1, sk):
        assert set(a) == set(b) == ({"momentum_buffer"} if momentum
                                    else set())
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_graph_step_refuses_sgd_on_card():
    """torch's own SGD keeps its lr as a Python number: the graph step
    refuses it (the port's SGD, which build_optimizer makes, is
    capturable)."""
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import optimizers, system
    dev = _card()
    cfg = RenderConfig(N_samples=16, N_importance=16)
    params = system.build_params(cfg, 8, device=dev)
    opt = torch.optim.SGD(optimizers.trainable_parameters(
        params, optimizers.make_trainable_mask(params, False)), lr=5e-4)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        system.make_train_step(cfg, opt, steps_per_execution=GRAPH_K)


def _fit_on_card(root, save, spe, pool, optimizer="adam"):
    from nerf_fl_torch.opt import get_opts
    from nerf_fl_torch.training import system
    from nerf_fl_torch.training.logging import NullLogger
    hp = get_opts(["--root_dir", root, "--img_wh", "40", "40",
                   "--N_samples", "64", "--N_importance", "64",
                   "--encode_a", "--encode_t", "--N_vocab", "8",
                   "--compute_dtype", "bfloat16", "--batch_size", "1024",
                   "--num_epochs", "2", "--optimizer", optimizer,
                   "--steps_per_execution", str(spe), "--device_pool", pool,
                   "--save_path", save, "--exp_name", "e",
                   "--refresh_every", "0", "--log_every", "1"])
    s = system.NeRFSystem(hp, logger=NullLogger(), device="cuda")
    s.setup()
    s.configure()
    before = fm.kernel_runs()
    s.fit()
    bwd = fm.kernel_runs()[1] - before[1]
    return s, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "ranger"])
def test_fit_feeds_agree_on_card(tmp_path, optimizer):
    """NeRFSystem.fit at the flagship width on a 40 x 40 scene (3 views, 4
    steps an epoch), bf16: host-fed single steps, host-fed groups of 4 (a
    CUDA graph fed through the DevicePrefetcher's pinned side-stream
    copies) and the device pool with 4 train the same batches in the same
    order, so their parameters agree bit for bit; the fused backward
    kernel runs twice a sub-step, as it counts its runs on the card."""
    _card()
    from nerf_fl_torch.data.synthetic import make_blender_scene
    from nerf_fl_torch.training.optimizers import named_leaves
    root = str(tmp_path / "scene")
    make_blender_scene(root, n_train=3, n_val=1, n_test=1, size=40)
    runs = [_fit_on_card(root, str(tmp_path / f"c{i}"), spe, pool,
                         optimizer)
            for i, (spe, pool) in enumerate([(1, "off"), (4, "off"),
                                             (4, "on")])]
    for s, bwd in runs:
        assert s.global_step == 8 and bwd == 2 * 8
    ref = named_leaves(runs[0][0].params)
    for s, _ in runs[1:]:
        for (n, a), (_, b) in zip(ref, named_leaves(s.params)):
            assert torch.equal(a, b), n


STAGES_WORLD = ["load", "sample", "coarse_mlp", "coarse_composite", "pdf",
                "fine_mlp", "fine_composite", "loss", "backward", "optimizer",
                "row", "end"]
STAGES_POSED = STAGES_WORLD[:1] + ["pose"] + STAGES_WORLD[1:9] \
    + ["pose_backward"] + STAGES_WORLD[9:]


@pytest.mark.cuda
@pytest.mark.parametrize("barf", [None, "fork"], ids=["world", "barf"])
def test_graph_replay_runs_each_stage_mark_once_a_sub_step_on_card(
        tmp_path, barf):
    """A K = 4 call of the device-pool step replayed from its CUDA graph
    under torch.profiler: the stage marks (utils/spans.py) are nodes of the
    graph, so the trace holds each one once a sub-step, in order; under
    BARF ``pose`` after ``load`` and ``pose_backward`` between
    ``backward`` and ``optimizer``.  Every kernel of the call but the
    call's fills and the metrics' clone lies between a ``load`` and an
    ``end``."""
    import json
    import re
    from torch.profiler import ProfilerActivity, profile
    params, _, step, data, gen = _graph_case("bfloat16", GRAPH_K, True,
                                             barf=barf)
    perm = torch.arange(data["rays"].shape[0], dtype=torch.int32,
                        device=data["rays"].device)
    step(params, data, perm, 0, 2 * GRAPH_K, 5e-4, 1.25, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, data, perm, GRAPH_K, 2 * GRAPH_K, 5e-4, 1.25,
             generator=gen)
        torch.cuda.synchronize()
    assert step.graph.captures == 1 and step.graph.replays >= GRAPH_K
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)
    kernels = sorted((e for e in events.get("traceEvents", events)
                      if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    mark = re.compile(r"\bnerf_mark_([a-z_]+)")
    stages = [m.group(1) for m in (mark.search(k["name"]) for k in kernels)
              if m]
    assert stages == (STAGES_POSED if barf else STAGES_WORLD) * GRAPH_K, \
        stages
    outside, open_ = [], False
    for k in kernels:
        m = mark.search(k["name"])
        if m:
            open_ = m.group(1) != "end"
        elif not open_:
            outside.append(k["name"])
    # outside the sub-steps: the call's fills (the lr, the epoch, the
    # offset, the counter, the rows), the generator's seed and offset
    # filled before each replay, and the metrics' clone
    assert all(re.search(r"fill|copy", n, re.IGNORECASE) for n in outside), \
        outside


@pytest.mark.cuda
def test_graph_step_with_marks_equals_eager_steps_under_the_profiler_on_card():
    """The marks touch no tensor: the f32 K-step replayed inside a profiler
    window equals as many eager steps bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    n = 2 * GRAPH_K - 1
    p1, s1, l1, _ = _run_graph_case("float32", 1, True, n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pk, sk, lk, step = _run_graph_case("float32", GRAPH_K, True, n)
    assert step.graph.captures == 1
    assert torch.equal(l1, lk)
    for a, b in zip(p1, pk):
        assert torch.equal(a, b)
