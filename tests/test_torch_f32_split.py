"""The f32 fused kernels' split precision, on the CPU.

The f32 kernels (csrc/fused_mlp_fwd.cu, fused_mlp_bwd.cu, namespace tf of
fused_mlp_common.cuh) take every product on the tensor cores as 3xTF32:
each f32 operand is split into hi = cvt.rna.tf32.f32(x) and lo = the rest,
rounded the same way, and a product is hi*hi + lo*hi + hi*lo with f32
sums.  Here: (a) the host's split of the packed weights and the f32 image
the kernels stream (its plan against the kernels' own walk, compiled from
the header), and (b) a plain model of the split products
(``f32_ties.tf32x3_mm``) wired into the plain versions' layer products,
held against the JAX package's f32 fused kernels (Pallas in interpret mode)
within chip_smoke.py's limits: F32_ATOL = 2e-4 on the forward's heads and
BWD_F32_REL = 1e-4 of each backward tensor's largest magnitude; and (c)
the ReLU ties, where f32 rounding decides a hidden ReLU, and the plain
backward matched to a kernel's side of them (``f32_ties``).
The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import re
import shutil
import subprocess
from pathlib import Path

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
from nerf_fl_torch.models import NeRFConfig, init_nerf
from nerf_fl_torch.ops import f32_ties
from nerf_fl_torch.ops import fused_mlp as fm
from nerf_fl_torch.render import RenderConfig

CSRC = Path(fm.__file__).resolve().parent.parent / "csrc"
F32_ATOL, BWD_F32_REL = 2e-4, 1e-4      # chip_smoke.py's f32 limits
N_FWD, N_BWD = 700, 512                  # ragged; one JAX backward tile


def _bits(x):
    return x.contiguous().view(torch.int32)


# ----------------------------------------------------------------------
# (a) the split and the image
# ----------------------------------------------------------------------

def test_tf32_round_is_tf32_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(0, 1, 20000), rng.normal(0, 1e-3, 5000),
        rng.normal(0, 1e4, 5000)]).astype(np.float32))
    hi = fm.tf32_round(x)
    assert not (_bits(hi) & 0x1FFF).any()
    # to nearest: within half a unit of the 10-bit fraction
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    # ties (the 13 dropped bits exactly 0x1000) go away from zero
    base = (_bits(torch.tensor([1.0, -1.0, 3.5, -3.5, 1e-20, -7e5]))
            & -0x2000).view(torch.float32)
    tie = (_bits(base) | 0x1000).view(torch.float32)
    up = (_bits(base) + 0x2000).view(torch.float32)
    assert torch.equal(fm.tf32_round(tie), up)
    below = (_bits(base) | 0x0FFF).view(torch.float32)
    assert torch.equal(fm.tf32_round(below), base)


@pytest.mark.parametrize("scale", [1.0, 1e-6, 3e5])
def test_split_rebuilds_each_value_within_2_to_minus_21(scale):
    """hi and lo are tf32 values and hi + lo is x to 2^-21 relative (the
    split's own bound is 2^-22)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(0, scale, 50000)).astype(np.float32))
    hi, lo = fm.tf32_split(x)
    for part in (hi, lo):
        assert not (_bits(part) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()


def _net(a_dim, transient, seed=0):
    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                                 in_channels_a=a_dim or 48,
                                 encode_transient=True),
                      generator=torch.Generator().manual_seed(seed))
    return fm.pack_weights(model, fm.Layout(torch.float32, 10, 4, a_dim,
                                            16 if transient else 0))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("a_dim,transient", [(48, True), (0, False)])
def test_f32_image_round_trips_to_the_packed_slabs(a_dim, transient,
                                                    backward):
    """Scattered back through its index, the image's hi parts are the
    packed weights' hi parts and its lo parts their lo parts, exactly; hi +
    lo rebuilds each weight to 2^-21; every weight is in the image (the
    forward's holds each once a part) and the rest is zero."""
    net = _net(a_dim, transient)
    image = fm.weight_image(net, backward)
    slabs, nbytes = fm.image_plan(net.layout, backward)
    assert image.dtype == torch.float32 and image.numel() * 4 == nbytes
    idx = fm.image_index(net.layout, backward)
    flat = torch.cat([w.reshape(-1) for w in net.ws])
    total = flat.numel()
    hi, lo = fm.tf32_split(flat)
    pad = idx == 2 * total
    assert not image[torch.from_numpy(pad)].any()
    first_dgrad = next((s.at for s in slabs if s.dgrad), nbytes) // 4
    for part, ref in ((0, hi), (1, lo)):
        real = (idx >= part * total) & (idx < (part + 1) * total)
        src = idx[real] - part * total
        if not backward:
            assert np.array_equal(np.sort(src), np.arange(total))
        else:
            seen = np.zeros(total, bool)
            seen[src[np.flatnonzero(real) >= first_dgrad]] = True
            assert seen.all()
        assert torch.equal(image[torch.from_numpy(real)],
                           ref[torch.from_numpy(src)])
    rebuilt = hi.double() + lo.double()
    assert ((rebuilt - flat.double()).abs()
            <= 2.0 ** -21 * flat.double().abs()).all()


@pytest.mark.parametrize("backward", [False, True])
def test_f32_image_is_the_swizzled_operand_image(backward):
    """Element (image row i, position k) of a stage's hi part sits at
    16-byte chunk (k // 4) ^ (i % 8) of row i and is the hi part of the
    weight at contraction value 8 (k // 8) + F32_K_ORDER[k % 8]; the lo part
    follows the hi part, laid out the same."""
    net = _net(48, True, seed=1)
    image = fm.weight_image(net, backward)
    slabs, _ = fm.image_plan(net.layout, backward)
    assert [s.at for s in slabs] == list(np.cumsum(
        [0] + [2 * s.height * 128 for s in slabs[:-1]]))
    _check_stages(image, slabs, net, 12)


def _check_stages(image, slabs, net, draws):
    """``draws`` random elements of each stage of ``slabs`` in ``image``
    against the tf32 split of the packed weight they come from."""
    rng = np.random.default_rng(0)
    for sl in slabs:
        whi, wlo = fm.tf32_split(net.ws[sl.layer])
        for _ in range(draws):
            i, k = int(rng.integers(sl.height)), int(rng.integers(32))
            kk = 8 * (k // 8) + fm.F32_K_ORDER[k % 8]
            at = sl.at // 4 + i * 32 + 4 * ((k // 4) ^ (i % 8)) + k % 4
            if sl.dgrad:
                ok = i < sl.rows and kk < sl.cols
                rc = (sl.row0 + i, sl.col0 + kk)
            else:
                ok = kk < sl.rows and i < sl.cols
                rc = (sl.row0 + kk, sl.col0 + i)
            for part, ref in ((0, whi), (1, wlo)):
                got = float(image[at + part * sl.height * 32])
                assert got == (float(ref[rc]) if ok else 0.0), (sl, i, k)


@pytest.mark.parametrize("n_freq_xyz", [10, 5])
def test_f32_sigma_image_is_the_trunk_and_the_sigma_block(n_freq_xyz):
    """The sigma-only kernel's image: the f32 forward image's trunk stages
    as they are, then fs2's 16-column sigma block alone, 8 stages of 16
    rows, laid out as every stage is."""
    model = init_nerf(NeRFConfig(typ="coarse",
                                 in_channels_xyz=3 + 6 * n_freq_xyz),
                      generator=torch.Generator().manual_seed(2))
    net = fm.pack_weights(model, fm.Layout(torch.float32, n_freq_xyz, 4))
    full, _ = fm.image_plan(net.layout)
    slabs, nbytes = fm.image_plan(net.layout.sigma)
    trunk = [sl for sl in full if sl.layer < 8]
    assert slabs[:len(trunk)] == trunk
    tail = slabs[len(trunk):]
    assert [(sl.layer, sl.row0, sl.rows, sl.col0, sl.cols, sl.height)
            for sl in tail] == [(8, k, 32, 256, 16, 16)
                                for k in range(0, 256, 32)]
    image = fm.weight_image(fm.pack_weights(model, net.layout.sigma))
    assert image.numel() * 4 == nbytes == tail[-1].at + 2 * 16 * 128
    n = tail[0].at // 4
    assert torch.equal(image[:n], fm.weight_image(net)[:n])
    _check_stages(image, tail, net, 64)


def _header_plan_program():
    """A host program from the header's own tf::Plan, plan_seg, make_plan,
    make_bwd_plan and make_sigma_plan that reads lines of (k0, kd, kt,
    has_transient, skip, no_d_inp, walk) and prints each walk's bytes and
    stage rows (walk: 0 forward, 1 backward, 2 the sigma-only forward)."""
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    tf_ns = hdr[hdr.index("namespace tf {"):]
    body = tf_ns[tf_ns.index("struct Plan {"):
                 tf_ns.index("// ---- the 3xTF32 split ----")]
    const = dict(re.findall(r"constexpr int (\w+) = (\w+);", hdr))
    const.update(re.findall(r"constexpr int (\w+) = (\w+);", tf_ns))
    consts = "".join(f"constexpr int {k} = {const[k]};\n"
                     for k in ("W_TRUNK", "W_HALF", "OUT_LD", "KC", "PIECE",
                               "MAX_PLAN"))
    consts += "constexpr int FS_OUT = W_TRUNK + 16;\n"
    main = r"""
#include <cstdio>
int main(int argc, char** argv) {
  static Plan p;
  int k0, kd, kt, tr, skip, nod, bw;
  while (scanf("%d %d %d %d %d %d %d", &k0, &kd, &kt, &tr, &skip, &nod,
               &bw) == 7) {
    int at = bw == 2 ? make_sigma_plan(p, k0)
             : bw ? make_bwd_plan(p, k0, kd, kt, tr, skip, nod != 0)
                  : make_plan(p, k0, kd, kt, tr, skip);
    printf("%d %d", at, p.n_stages);
    for (int i = 0; i < p.n_stages && i < MAX_PLAN; ++i) printf(" %d", p.rows[i]);
    printf("\n");
  }
}
"""
    return consts + body + main


def header_walks(exe, layouts_walks):
    """The header's (bytes, stage heights) of each (layout, walk), walk 0
    forward, 1 backward, 2 sigma-only, from the compiled ``exe``."""
    query = "".join(f"{lay.k0} {lay.kd} {lay.kt} {int(lay.has_transient)} "
                    f"{lay.skip} {int(lay.no_d_inp)} {walk}\n"
                    for lay, walk in layouts_walks)
    lines = subprocess.run([str(exe)], input=query, capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return [(nums[0], nums[1], nums[2:])
            for nums in ([int(v) for v in line.split()] for line in lines)]


@pytest.fixture(scope="module")
def plan_exe(tmp_path_factory):
    """The header's walks compiled for the host once for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("plan")
    (tmp / "plan.cpp").write_text(_header_plan_program())
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", str(tmp / "plan"),
                    str(tmp / "plan.cpp")], check=True)
    return tmp / "plan"


def _cfg_layout(n_xyz, n_dir, a_dim=0, t_dim=0, mip=False):
    """``layout_for``'s f32 layout of a field with those frequencies and
    embedding widths (``mip``: mip-NeRF's field, IPE frequencies)."""
    if mip:
        mcfg = NeRFConfig(skips=(5,), skip_order="hidden_first",
                          in_channels_xyz=6 * n_xyz,
                          in_channels_dir=3 + 6 * n_dir)
    else:
        mcfg = NeRFConfig(typ="fine", in_channels_xyz=3 + 6 * n_xyz,
                          in_channels_dir=3 + 6 * n_dir,
                          encode_appearance=a_dim > 0,
                          in_channels_a=a_dim or 48,
                          encode_transient=t_dim > 0,
                          in_channels_t=t_dim or 16)
    lay = fm.layout_for(mcfg, torch.float32, transient=t_dim > 0)
    assert lay is not None
    return lay


# (k0, kd, kt): (64, 80, 16) the flagship's fine net, (64, 32, 0) its coarse
# one, (128, 128, 128) the widest, (48, 16, 16) a narrow one; the IPE
# layouts at (96, 32), (48, 32) and (112, 48)
PLAN_LAYOUTS = {
    "fine": (10, 4, 48, 16), "coarse": (10, 4), "wide": (20, 20, 0, 120),
    "narrow": (7, 2, 0, 16), "ipe16": (16, 4, 0, 0, True),
    "ipe8": (8, 4, 0, 0, True), "ipe18": (18, 6, 0, 0, True)}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("name", sorted(PLAN_LAYOUTS))
def test_f32_plan_is_the_kernels_walk(plan_exe, name, backward):
    """The header's tf::make_plan / make_bwd_plan, compiled for the host,
    give ``image_plan``'s stage heights and bytes for each layout that
    ``layout_for`` gives in f32, both walks (the launcher also refuses an
    image of another size on the card)."""
    lay = _cfg_layout(*PLAN_LAYOUTS[name])
    (nbytes, n, heights), = header_walks(plan_exe, [(lay, int(backward))])
    slabs, want = fm.image_plan(lay, backward)
    assert nbytes == want and n == len(slabs) <= 384
    assert heights == [s.height for s in slabs]


def test_f32_sigma_plan_is_the_kernels_walk(plan_exe):
    """The header's tf::make_sigma_plan, compiled for the host, gives the
    sigma layout's ``image_plan`` stage heights and bytes (the sigma
    launcher also refuses an image of another size on the card)."""
    lays = [_cfg_layout(*PLAN_LAYOUTS[k]).sigma
            for k in ("fine", "wide", "narrow")]
    assert sorted(lay.k0 for lay in lays) == [48, 64, 128]
    for lay, (nbytes, n, heights) in zip(
            lays, header_walks(plan_exe, [(lay, 2) for lay in lays])):
        slabs, want = fm.image_plan(lay)
        assert nbytes == want and n == len(slabs) <= 384
        assert heights == [s.height for s in slabs]
        assert heights[-8:] == [16] * 8


def test_f32_shared_memory_budget():
    """The f32 kernels' blocks fit the 232,448 bytes a block may take:
    forward 96 KB activations + 3 stages of hi + lo 144-row parts, backward
    4 KB more activations and 128-row stages, wgrad two buffers of hi + lo
    images of 128 + 272 rows."""
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    tf_ns = hdr[hdr.index("namespace tf {"):]
    bwd = (CSRC / "fused_mlp_bwd.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\w+);", tf_ns))
    assert (const["KC"], const["PIECE"], const["STAGES"]) == \
        ("32", "W_HALF", "3")
    consts = (int(re.search(r"BIAS_FLOATS = (\d+);", hdr).group(1))
              + 2 * 128) * 4
    fwd = 1024 + 96 * 1024 + 3 * 2 * 144 * 128 + consts + 2 * 3 * 8
    back = 1024 + 100 * 1024 + 3 * 2 * 128 * 128 + consts + 2 * 3 * 8
    wgrad = 1024 + 2 * 2 * (128 + 272) * 128
    assert (fwd, back, wgrad) == (223024, 214832, 205824)
    assert max(fwd, back, wgrad) <= 232448
    assert "constexpr int W_A_ROWS = 128;" in bwd
    assert "constexpr int W_G_ROWS = W_TRUNK + OUT_LD;" in bwd


def test_f32_grid_takes_64_point_tiles():
    for n, tiles in ((0, 0), (1, 1), (64, 1), (65, 2), (70_001, 1094)):
        assert fm.fwd_tiles(n, fm.F32_ROWS) == tiles
        assert fm.fwd_grid(n, 132, fm.F32_ROWS) == min(tiles, 132)


# ----------------------------------------------------------------------
# (b) the split products against the JAX package's f32 kernels
# ----------------------------------------------------------------------

def _setup(a_dim, n, seed=0):
    jcfg = JCfg(typ="fine", encode_appearance=a_dim > 0,
                in_channels_a=a_dim or 48, encode_transient=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit(jax.random.PRNGKey(seed), jcfg))
    rc = RenderConfig(N_importance=1, encode_a=a_dim > 0, N_a=a_dim or 48,
                      encode_t=True)
    model = from_jax_params({"nerf_fine": jp}, rc)["nerf_fine"]
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)
    a = rng.normal(0, 1, (n, a_dim)).astype(np.float32) if a_dim else None
    t = rng.normal(0, 1, (n, 16)).astype(np.float32)
    return jp, model, xyz, dirs, a, t, rng


def _barf(barf):
    if not barf:
        return None, None
    return (np.asarray(je.barf_weights(6.0, 10, 4, 8)),
            np.asarray(je.barf_weights(6.0, 4, 4, 8)))


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _split_forward(model, inp, a_dim, transient, bw, matmul):
    net = fm.pack_weights(model, fm.Layout(torch.float32, 10, 4, a_dim,
                                           16 if transient else 0))
    sx, sd = fm.default_scale_rows(10, 4, a_dim, *map(_t, bw))
    out, _ = fm._forward(inp, net, sx, sd, matmul)
    return fm.heads(out, transient)


def _forward_errors(transient, a_dim, barf, matmul):
    jp, model, xyz, dirs, a, t, _ = _setup(a_dim, N_FWD)
    bw = _barf(barf)
    ref = jf.fused_apply_nerf(
        jp, jnp.asarray(xyz), jnp.asarray(dirs),
        None if a is None else jnp.asarray(a),
        jnp.asarray(t) if transient else None, output_transient=transient,
        compute_dtype=jnp.float32, barf_w_xyz=bw[0], barf_w_dir=bw[1],
        interpret=True)
    inp = fm.pack_inputs(_t(xyz), _t(dirs), _t(a),
                         _t(t) if transient else None)
    with torch.no_grad():
        got = _split_forward(model, inp, a_dim, transient, bw, matmul)
    assert set(got) == set(ref)
    return {k: float(np.abs(got[k].numpy() - np.asarray(ref[k])).max())
            for k in ref}


@pytest.mark.parametrize("barf", [False, True])
@pytest.mark.parametrize("a_dim,transient", [(48, True), (48, False),
                                             (0, True), (0, False)])
def test_split_forward_matches_pallas_f32(a_dim, transient, barf):
    errs = _forward_errors(transient, a_dim, barf, f32_ties.tf32x3_mm)
    assert max(errs.values()) <= F32_ATOL, errs


def _backward_pairs(transient, a_dim, barf, matmul):
    jp, model, xyz, dirs, a, t, rng = _setup(a_dim, N_BWD)
    if not transient:
        jp = {k: v for k, v in jp.items() if k != "transient"}
    parts = [xyz, dirs] + ([a] if a_dim else []) + ([t] if transient else [])
    inp = np.concatenate(parts, -1)
    live = inp.shape[1]
    inp = np.pad(inp, ((0, 0), (0, 128 - live)))
    g = np.zeros((N_BWD, 128), np.float32)
    g[:, :9] = rng.normal(0, 1, (N_BWD, 9))
    bw = _barf(barf)
    ws = jf.pack_weights(jax.tree_util.tree_map(jnp.asarray, jp), a_dim,
                         transient, jnp.float32)
    jsx, jsd = jf.default_scale_rows(10, 4, a_dim, *bw)
    outs = jf._fused_bwd(ws, jnp.asarray(inp), jsx, jsd, jnp.asarray(g),
                         a_dim=a_dim, has_transient=transient,
                         dtype_name="float32", interpret=True, n_freq_xyz=10,
                         n_freq_dir=4)
    ref = jf.unpack_weight_grads(outs[:len(ws)], jp, a_dim, transient)
    ref_inp = np.asarray(outs[len(ws)])

    net = fm.pack_weights(model, fm.Layout(torch.float32, 10, 4, a_dim,
                                           16 if transient else 0))
    sx, sd = fm.default_scale_rows(10, 4, a_dim, *map(_t, bw))
    dws, dbs, d_inp = fm.fused_mlp_bwd_reference(
        torch.from_numpy(inp), net, sx, sd,
        torch.from_numpy(g[:, :16]).contiguous(), matmul=matmul)
    flat = fm.unpack_weight_grads(dws, dbs, net.layout)
    params = [p for lin in fm.field_linears(model, transient)
              for p in (lin.weight, lin.bias)]
    for p, x in zip(params, flat):
        p.grad = x
    got = grads_to_numpy_tree({"nerf_fine": model})["nerf_fine"]
    if not transient:
        got.pop("transient", None)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    pairs = [(jax.tree_util.keystr(p), np.asarray(x, np.float32),
              np.asarray(y, np.float32))
             for (p, x), (_, y) in zip(flat_got, flat_ref)]
    pairs.append(("d_inp", d_inp.numpy()[:, :live], ref_inp[:, :live]))
    return pairs


@pytest.mark.parametrize("barf", [False, True])
@pytest.mark.parametrize("a_dim,transient", [(48, True), (0, False)])
def test_split_backward_matches_pallas_f32(a_dim, transient, barf):
    pairs = _backward_pairs(transient, a_dim, barf, f32_ties.tf32x3_mm)
    assert len(pairs) == (39 if transient else 25)
    for name, got, ref in pairs:
        assert got.shape == ref.shape, name
        assert np.abs(got - ref).max() <= BWD_F32_REL * np.abs(ref).max(), \
            name


def test_split_products_round_and_one_pass_is_far_worse():
    """The model does round (its heads are not the exact products'), and
    one TF32 pass (hi x hi) instead of three lands over 10x further from
    the JAX kernel's heads: the three passes are what keep f32's limit."""
    _, model, xyz, dirs, a, t, _ = _setup(48, N_FWD)
    inp = fm.pack_inputs(_t(xyz), _t(dirs), _t(a), _t(t))

    def one_pass(x, y):
        return fm.tf32_round(x) @ fm.tf32_round(y)

    with torch.no_grad():
        exact, three = (_split_forward(model, inp, 48, True, (None, None),
                                       mm)
                        for mm in (torch.matmul, f32_ties.tf32x3_mm))
    assert any(not torch.equal(exact[k], three[k]) for k in exact)
    three_err = _forward_errors(True, 48, False, f32_ties.tf32x3_mm)
    one_err = _forward_errors(True, 48, False, one_pass)
    assert max(one_err.values()) > 10 * max(three_err.values())


# ----------------------------------------------------------------------
# (c) ReLU ties
# ----------------------------------------------------------------------

TIE_F32, TIE_SHARE_MAX = 2e-6, 0.08      # chip_smoke.py's


def _tie_case(n, seed=1, a_dim=48, transient=True):
    rng = np.random.default_rng(seed)
    net = _net(a_dim, transient, seed=seed)
    xyz = torch.from_numpy(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    a = torch.from_numpy(rng.normal(0, 1, (n, a_dim)).astype(np.float32))
    t = torch.from_numpy(rng.normal(0, 1, (n, 16)).astype(np.float32))
    inp = fm.pack_inputs(xyz, d, a if a_dim else None,
                         t if transient else None)
    sx, sd = fm.default_scale_rows(10, 4, a_dim)
    g = torch.zeros(n, 16)
    g[:, :9] = torch.from_numpy(rng.normal(0, 1, (n, 9)).astype(np.float32))
    return inp, net, sx, sd, g


def _worst(got, ref):
    return max(float((x - y).abs().max()) / float(y.abs().max())
               for x, y in zip(got[0] + got[1] + [got[2]],
                               ref[0] + ref[1] + [ref[2]]))


def test_tie_units_are_the_small_pre_activations():
    """``tie_units`` marks exactly the hidden units whose plain forward
    pre-activation lies within tol of zero: checked against the
    pre-activations computed layer by layer here."""
    inp, net, sx, sd, _ = _tie_case(300, seed=3)
    _, acts = fm._forward(inp, net, sx, sd)
    ins = acts["ins"] + [acts["din"]] + acts["tacts"][:4]
    pre = {i: x @ net.ws[i] + net.bs[i] for x, i in zip(ins, f32_ties.HIDDEN)}
    for tol in (1e-5, 1e-4, 1e-3):
        ties = f32_ties.tie_units(inp, net, sx, sd, tol=tol)
        assert list(ties) == list(f32_ties.HIDDEN)
        for i, p in pre.items():
            assert torch.equal(ties[i], p.abs() < tol)
    tie_points = torch.stack([m.any(1) for m in f32_ties.tie_units(
        inp, net, sx, sd, tol=1e-4).values()]).any(0)
    assert 0 < int(tie_points.sum()) < 300


def test_flipping_matmul_moves_only_the_marked_relus():
    """The matched reference's products put exactly the marked units on
    the other side of their ReLU, each within its |pre-activation| plus one
    unit in the last place of its bias, and touch no other unit of that
    layer or any layer before it."""
    inp, net, sx, sd, _ = _tie_case(300, seed=4)
    plain = f32_ties.pre_activations(inp, net, sx, sd)
    mark = torch.zeros_like(plain[7], dtype=torch.bool)
    mark[::7, ::5] = True
    moved = f32_ties.pre_activations(
        inp, net, sx, sd, matmul=f32_ties._matmul({7: mark}, net))
    for i in range(7):
        assert torch.equal(moved[i], plain[i])
    p, q = plain[7], moved[7]
    assert torch.equal(q[~mark], p[~mark])
    assert torch.equal(q[mark] > 0, ~(p[mark] > 0))
    ulp = torch.nextafter(net.bs[7].abs(), torch.tensor(float("inf")))
    ulp = (ulp - net.bs[7].abs()).expand_as(p)
    assert bool(((q - p).abs() <= p.abs() + ulp)[mark].all())


def test_matched_backward_holds_a_kernel_that_decides_ties_otherwise():
    """A stand-in for the kernels (the 3xTF32 model, with every other tie
    unit taken to the other side of its ReLU) is within BWD_F32_REL of the
    matched plain backward on every tensor over all 8,000 points, while
    against the plain sides its d_inp or a dW is far off; the matched
    reference finds the points it moved."""
    inp, net, sx, sd, g = _tie_case(8000)
    ties = f32_ties.tie_units(inp, net, sx, sd, tol=TIE_F32)
    forced = {}
    for i, m in ties.items():
        f = m.clone()
        f.view(-1)[1::2] = False
        forced[i] = m & f
    n_forced = int(torch.stack([f.any(1) for f in forced.values()]
                               ).any(0).sum())
    assert n_forced > 0
    got = fm.fused_mlp_bwd_reference(
        inp, net, sx, sd, g,
        matmul=f32_ties._matmul(forced, net, base=f32_ties.tf32x3_mm))
    plain = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    ref, st = f32_ties.matched_backward(got[2], inp, net, sx, sd, g,
                                        tol=TIE_F32)
    assert _worst(got, plain) > 100 * BWD_F32_REL
    assert _worst(got, ref) <= BWD_F32_REL
    assert 0 < st["tie_points"] <= TIE_SHARE_MAX * st["points"]
    assert st["moved_points"] >= n_forced // 2
    assert st["farthest_moved"] < TIE_F32


def test_matched_backward_does_not_absorb_a_fault():
    """What is not a tie stays a fault: one TF32 pass in place of three,
    and a kernel that takes a unit far from zero to its other side, are
    both far outside BWD_F32_REL of the matched reference."""
    inp, net, sx, sd, g = _tie_case(2000, seed=2)
    pre = f32_ties.pre_activations(inp, net, sx, sd)
    far = (pre[3].abs() > 1e-2) & (pre[3].abs() < 1e-1)
    far &= torch.cumsum(far.to(torch.int32).view(-1), 0).view_as(far) <= 40

    def one_pass(x, y):
        return fm.tf32_round(x) @ fm.tf32_round(y)

    for mm in (one_pass, f32_ties._matmul({3: far}, net)):
        got = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g, matmul=mm)
        ref, _ = f32_ties.matched_backward(got[2], inp, net, sx, sd, g,
                                           tol=TIE_F32)
        assert _worst(got, ref) > 10 * BWD_F32_REL
