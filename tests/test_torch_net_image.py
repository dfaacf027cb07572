"""The net probes' weight image and plan on the CPU.

``ops/anatomy.py:net_image`` lays the weights of ``static`` / ``full`` /
``consol`` out as the net kernel (``csrc/anatomy_net.cu``, the Hopper block)
streams them: every layer cut into W^T slabs of 64 input rows, 256 image
rows for the trunk and 128 for fs2 (three products: its f32 tail, then xf
in two halves), the dir layer, the heads and the transient branch; every
slab the K-major, 128-byte-swizzled wgmma B operand image (16-byte chunk c
of image row i at chunk ``c ^ (i % 8)``).  ``consol``'s image is cut from
its stacked operands and must equal ``static``'s byte for byte, which is
what keeps the two probes equal bit for bit on the card.  The kernel runs
only on a card (``tests/test_torch_cuda.py``); what it reads is checked
here exactly.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fl_torch.ops import anatomy
from nerf_fl_torch.ops import fused_mlp as fm

CSRC = Path(fm.__file__).resolve().parent.parent / "csrc"
BF = torch.bfloat16


def _layers(o, transient):
    """The separate operands' weights in ``net_image_shapes`` order."""
    ws = list(o["trunk"][0::2]) + [o["wfs"], o["wd"], o["wr"]]
    if transient:
        ws += [o["wt0"], *o["wtm"], o["wth"]]
    return ws


def _slab_tile(flat, sl):
    """A slab as its (64, height) W^T tile back in W's orientation: element
    [k][i] is contraction value k of image row i."""
    i = np.arange(sl.height)[:, None, None]
    c = np.arange(8)[None, :, None]
    e = np.arange(8)[None, None, :]
    at = sl.at // 2 + i * 64 + 8 * (c ^ (i % 8)) + e
    return flat[at].reshape(sl.height, 64).T


def _decode(image, transient, stacked=False):
    """Every layer of ``net_image_shapes`` back out of the image through
    the plan (int16 views of the bf16 bits)."""
    slabs, _ = anatomy.net_image_plan(transient, stacked)
    flat = image.view(torch.int16).numpy()
    out = [np.zeros(s, np.int16)
           for s in anatomy.net_image_shapes(transient, stacked)]
    for sl in slabs:
        out[sl.layer][sl.row0:sl.row0 + sl.rows,
                      sl.col0:sl.col0 + sl.cols] = _slab_tile(flat, sl)
    return [torch.from_numpy(m).view(BF) for m in out]


# The kernel's products in the order csrc/anatomy_net.cu runs them: (image
# rows a slab, the weight block the product multiplies by).  A product takes
# one slab per 64 contraction rows; where it reads two or three sources
# ([pe | h] at layer 4, [xf | dt] and [xf | tt] from P, H2-3 and H0-1) it
# reads them in the weight's row order.
def _kernel_walk(o, transient):
    walk = [(256, w) for w in o["trunk"][0::2]]
    walk += [(128, o["wfs"][:, c]) for c in (slice(256, 384), slice(0, 128),
                                             slice(128, 256))]
    walk += [(128, o["wd"]), (128, o["wr"])]
    if transient:
        walk += [(128, w) for w in [o["wt0"], *o["wtm"], o["wth"]]]
    return walk


@pytest.mark.parametrize("transient", [False, True])
def test_net_plan_slab_count_offsets_and_order(transient):
    slabs, nbytes = anatomy.net_image_plan(transient)
    n_big, n_small = 32, 20 + (14 if transient else 0)
    assert len(slabs) == n_big + n_small == (66 if transient else 52)
    assert nbytes == n_big * 32768 + n_small * 16384 \
        == (1_605_632 if transient else 1_376_256)
    assert nbytes // 2 == (802_816 if transient else 688_128)
    sizes = [s.height * 128 for s in slabs]
    assert [s.at for s in slabs] == list(np.cumsum([0] + sizes[:-1]))
    assert sizes == [32768] * n_big + [16384] * n_small
    # layers in consumption order: trunk 2, 4, 4, 4, 6, 4, 4, 4 slabs, fs2
    # 12 (three products of 4), dir 6, rgb 2, then t0 6 and 2 each
    counts = [2, 4, 4, 4, 6, 4, 4, 4, 12, 6, 2] \
        + ([6, 2, 2, 2, 2] if transient else [])
    assert [s.layer for s in slabs] == sum(
        ([layer] * k for layer, k in enumerate(counts)), [])
    fs2 = [s for s in slabs if s.layer == 8]
    assert [(s.col0, s.row0) for s in fs2] == [
        (c, r) for c in (256, 0, 128) for r in (0, 64, 128, 192)]
    assert [s.row0 for s in slabs if s.layer == 9] == [0, 64, 128, 192, 256,
                                                      320]


@pytest.mark.parametrize("transient", [False, True])
def test_net_plan_is_the_kernels_walk(transient):
    """``make_net_plan`` in the source: the segments (contraction rows,
    image rows) it appends, in order, give the Python plan's offsets; the
    card's build is compared with it at the first launch
    (``ops/anatomy.py:_check_net_plan``) and by tests/test_torch_cuda.py."""
    src = (CSRC / "anatomy_net.cu").read_text()
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    body = re.search(r"inline int make_net_plan\(Plan& p, int transient\) "
                     r"\{(.*?)\n\}", src, re.S).group(1)
    seg = re.findall(r"plan_seg\(p, at, (.*?), (\w+)\);", body)
    assert seg == [("l == 0 ? NET_W : l == 4 ? ACT_W : W_TRUNK", "W_TRUNK"),
                   ("W_TRUNK", "W_HALF"), ("ACT_W", "W_HALF"),
                   ("W_HALF", "W_HALF"), ("ACT_W", "W_HALF"),
                   ("W_HALF", "W_HALF")]
    for loop in ("for (int l = 0; l < 8; ++l)", "for (int s = 0; s < 3; ++s)",
                 "if (transient) {", "for (int l = 0; l < 4; ++l)"):
        assert loop in body
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", hdr + src)}
    trunk, half, act = const["W_TRUNK"], const["W_HALF"], const["ACT_W"]
    segs = [(const["NET_W"] if l == 0 else act if l == 4 else trunk, trunk)
            for l in range(8)]
    segs += [(trunk, half)] * 3 + [(act, half), (half, half)]
    if transient:
        segs += [(act, half)] + [(half, half)] * 4
    off, at = [], 0
    for rows, height in segs:
        for _ in range(0, rows, 64):
            off.append(at)
            at += height * 128
    slabs, nbytes = anatomy.net_image_plan(transient)
    assert off == [s.at for s in slabs] and at == nbytes
    assert len(off) <= const["MAX_SLABS"]


def test_net_shared_memory_budget():
    """Two warpgroups of six operand tiles (P 2 + H 4), a ring of three 32
    KB slabs, 3,328 staged biases and the barriers fit the 232,448 bytes a
    block can have, with the fused kernels' ring depth."""
    src = (CSRC / "anatomy_net.cu").read_text()
    assert "NET_STAGE_BYTES = W_TRUNK * 128;" in src
    assert re.search(r"NET_SMEM = 1024 \+ CONSUMERS \* ACT_BYTES \+\s+"
                     r"STAGES \* NET_STAGE_BYTES \+ NET_BIAS \* 4 \+\s+"
                     r"2 \* STAGES \* 8;", src)
    biases = 8 * 256 + 384 + 128 + 128 + 5 * 128
    assert biases == 3328
    smem = 1024 + 2 * 6 * 8192 + 3 * 32768 + biases * 4 + 2 * 3 * 8
    assert smem == 210_992 <= 232_448 < smem + 32768
    # no slab is taller than the 256 image rows a 32 KB stage holds
    for transient in (False, True):
        slabs, _ = anatomy.net_image_plan(transient)
        assert max(s.height for s in slabs) * 128 == 32768


@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_net_image_is_a_permutation_that_decodes_to_every_layer(transient,
                                                               seed):
    o = anatomy.net_operands(8, seed)
    layers = _layers(o, transient)
    image = anatomy.net_image(layers, transient)
    total = sum(k * m for k, m in anatomy.net_image_shapes(transient))
    assert image.dtype == BF and image.numel() == total
    idx = anatomy._net_index(transient, False)
    # every weight exactly once, and no padding: K and N are multiples of 64
    assert np.array_equal(np.sort(idx), np.arange(total))
    flat = torch.cat([w.reshape(-1) for w in layers])
    assert torch.equal(image, flat[torch.from_numpy(idx)])
    for got, want in zip(_decode(image, transient), layers):
        assert torch.equal(got, want)


@pytest.mark.parametrize("transient", [False, True])
def test_kernel_walk_reads_each_products_weights(transient):
    """Read the image slab after slab in the order the kernel's products
    take them (trunk with [pe | h] at layer 4, fs2's tail then xf in two
    halves, the dir and t0 layers over P, H2-3 and H0-1): every product
    gets exactly the weight block it multiplies by."""
    o = anatomy.net_operands(8, 3)
    image = anatomy.net_image(_layers(o, transient), transient)
    flat = image.view(torch.int16).numpy()
    slabs, nbytes = anatomy.net_image_plan(transient)
    at = 0
    for height, w in _kernel_walk(o, transient):
        tiles = []
        for _ in range(0, w.shape[0], 64):
            sl = slabs[at + len(tiles)]
            assert sl.height == height
            tiles.append(_slab_tile(flat, sl))
        at += len(tiles)
        got = torch.from_numpy(np.concatenate(tiles)).view(BF)
        assert torch.equal(got, w)
    assert at == len(slabs) and slabs[-1].at + slabs[-1].height * 128 \
        == nbytes


@pytest.mark.parametrize("seed", [0, 4])
def test_consol_image_from_stacked_operands_equals_static(seed):
    """Cut from w0, w_mid (256, 1536) and w_skip, with the middle layers'
    slabs at w_mid's column blocks, the image is static's bit for bit."""
    o = anatomy.net_operands(8, seed)
    w0, w_mid, w_skip, _ = anatomy.consolidate(o["trunk"])
    stacked = anatomy.net_image([w0, w_mid, w_skip, o["wfs"], o["wd"],
                                 o["wr"]], False, stacked=True)
    plain = anatomy.net_image(_layers(o, False), False)
    assert stacked.view(torch.int16).numpy().tobytes() \
        == plain.view(torch.int16).numpy().tobytes()
    a, _ = anatomy.net_image_plan(False, stacked=True)
    b, _ = anatomy.net_image_plan(False)
    assert [(s.at, s.height, s.row0) for s in a] \
        == [(s.at, s.height, s.row0) for s in b]
    assert sorted({s.col0 for s in a if s.layer == 1}) == [
        256 * j for j in range(6)]
    dec = _decode(stacked, False, stacked=True)
    assert torch.equal(dec[1], w_mid)


@pytest.mark.parametrize("name", ["static", "full", "consol"])
def test_probe_scratch_is_its_image(name, monkeypatch):
    """The wrapper's scratch cuts the image from the probe's own operand
    list (the card's plan check is the card's; here it is skipped)."""
    monkeypatch.setattr(anatomy, "_check_net_plan", lambda transient: None)
    o = anatomy.net_operands(8, 2)
    ops = anatomy.net_inputs(o, name)
    got = anatomy.PROBES[name].scratch(ops)
    transient = name == "full"
    assert torch.equal(got, anatomy.net_image(_layers(o, transient),
                                              transient))


@pytest.mark.parametrize("transient", [False, True])
def test_net_reference_on_the_decoded_matrices_is_bitwise(transient):
    """The probe's plain version on the matrices read back out of the image
    equals it on the originals bit for bit."""
    o = anatomy.net_operands(256, 5)
    dec = _decode(anatomy.net_image(_layers(o, transient), transient),
                  transient)
    trunk = list(o["trunk"])
    trunk[0::2] = dec[:8]
    mine = dict(o, trunk=trunk, wfs=dec[8], wd=dec[9], wr=dec[10])
    if transient:
        mine.update(wt0=dec[11], wtm=dec[12:15], wth=dec[15])
    name = "full" if transient else "static"
    ref = anatomy._net_reference(transient, *anatomy.net_inputs(o, name))
    got = anatomy._net_reference(transient, *anatomy.net_inputs(mine, name))
    assert ref.shape == (256, 128) and torch.equal(got, ref)
