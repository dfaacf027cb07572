"""The concat probe's weight image and plan on the CPU, and the generalised
image helper behind both it and the fused kernels' images.

``ops/anatomy.py:chain_image`` lays the chain weights out as the concat
kernel (``csrc/anatomy_chain.cu``, the Hopper block) streams them: layers
0-3, ``w4c``, layers 5-7, each cut into slabs of 64 input rows x 256 image
rows, every slab the K-major, 128-byte-swizzled wgmma B operand image
(16-byte chunk c of image row i at chunk ``c ^ (i % 8)``).  The kernel runs
only on a card (``tests/test_torch_cuda.py``); what it reads is checked
here exactly.
"""
import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fl_torch.ops import anatomy
from nerf_fl_torch.ops import fused_mlp as fm

CSRC = Path(fm.__file__).resolve().parent.parent / "csrc"
W = 256


def _layers(c):
    return list(c["ws"][:4]) + [c["w4c"]] + list(c["ws"][5:])


def _decode(image):
    """Every layer of the image back as its (K, 256) matrix, through the
    swizzle: element (image row i, contraction value 8 c + e) of a slab is
    at [slab][i][c ^ (i % 8)][e]."""
    slabs, _ = anatomy.chain_image_plan()
    flat = image.view(torch.int16).numpy()
    out = [np.zeros((k, m), np.int16) for k, m in anatomy.CHAIN_IMAGE_SHAPES]
    i = np.arange(256)[:, None, None]
    c = np.arange(8)[None, :, None]
    e = np.arange(8)[None, None, :]
    for sl in slabs:
        at = sl.at // 2 + i * 64 + 8 * (c ^ (i % 8)) + e        # (256, 8, 8)
        tile = flat[at].reshape(256, 64)                          # [i][k]
        out[sl.layer][sl.row0:sl.row0 + 64, :] = tile.T
    return [torch.from_numpy(m).view(torch.bfloat16) for m in out]


def test_chain_plan_is_34_slabs_of_32_kb_in_consumption_order():
    slabs, nbytes = anatomy.chain_image_plan()
    assert len(slabs) == 34 and nbytes == 34 * 32768 == 1_114_112
    assert [s.at for s in slabs] == [32768 * j for j in range(34)]
    assert all(s.height == 256 and s.rows == 64 and s.cols == 256
               and not s.dgrad for s in slabs)
    assert [s.layer for s in slabs] == sum(
        ([layer] * (6 if layer == 4 else 4) for layer in range(8)), [])
    assert [s.row0 for s in slabs if s.layer == 4] == [0, 64, 128, 192,
                                                       256, 320]


def test_chain_plan_is_the_kernels_walk():
    """``make_chain_plan`` in the source: one ``plan_seg`` a layer, 384
    rows at layer 4 and 256 elsewhere, 256 image rows; plan_seg cuts
    ``rows`` into slabs of 64 of ``height * 128`` bytes each, in order.
    The card's build is compared with the Python plan at its first launch
    (``ops/anatomy.py:_check_concat_plan``) and by tests/test_torch_cuda.py."""
    src = (CSRC / "anatomy_chain.cu").read_text()
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    body = re.search(r"inline int make_chain_plan\(Plan& p\) \{(.*?)\n\}",
                     src, re.S).group(1)
    seg = re.findall(r"plan_seg\(p, at, (.*?), (\w+)\);", body)
    assert seg == [("l == 4 ? ACT_W : W_TRUNK", "W_TRUNK")]
    assert "for (int l = 0; l < 8; ++l)" in body
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", hdr)}
    off, at = [], 0
    for layer in range(8):
        rows = const["ACT_W"] if layer == 4 else const["W_TRUNK"]
        for _ in range(0, rows, 64):
            off.append(at)
            at += const["W_TRUNK"] * 128
    slabs, nbytes = anatomy.chain_image_plan()
    assert off == [s.at for s in slabs] and at == nbytes
    assert len(off) <= const["MAX_SLABS"]


def test_concat_shared_memory_budget():
    """Two warpgroups of 10 operand tiles (h 4, [x | h] 6) and a ring of
    two 32 KB slabs fit the 232,448 bytes a block can have; a third slab
    would not."""
    src = (CSRC / "anatomy_chain.cu").read_text()
    stages = int(re.search(r"CC_STAGES = (\d+);", src).group(1))
    assert stages == 2
    smem = 1024 + 2 * 10 * 8192 + stages * 32768 + 2 * stages * 8
    assert smem == 230_432 <= 232_448 < smem + 32768 + 16


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_image_is_a_permutation_that_never_reads_ws4(seed):
    c = anatomy.chain_operands(8, seed)
    image = anatomy.chain_image(c["ws"], c["w4c"])
    total = sum(k * m for k, m in anatomy.CHAIN_IMAGE_SHAPES)
    assert image.dtype == torch.bfloat16 and image.numel() == total
    idx = anatomy._chain_index()
    # every weight exactly once, and no padding: K and N are multiples of 64
    assert np.array_equal(np.sort(idx), np.arange(total))
    flat = torch.cat([w.reshape(-1) for w in _layers(c)])
    assert torch.equal(image, flat[torch.from_numpy(idx)])
    # ws[4] is never read: a marker there changes nothing
    ws = list(c["ws"])
    ws[4] = torch.full((W, W), 7.0, dtype=torch.bfloat16)
    again = anatomy.chain_image(ws, c["w4c"])
    assert torch.equal(again, image) and not (again == 7.0).any()


@pytest.mark.parametrize("seed", [0, 2])
def test_chain_image_decodes_to_each_layer_in_consumption_order(seed):
    c = anatomy.chain_operands(8, seed)
    got = _decode(anatomy.chain_image(c["ws"], c["w4c"]))
    for g, w in zip(got, _layers(c)):
        assert torch.equal(g, w)
    # one element by hand: w4c[300, 17] is in slab 16 + 300 // 64 = 20 (the
    # fifth of layer 4), image row 17, chunk (300 % 64) // 8 ^ 17 % 8
    image = anatomy.chain_image(c["ws"], c["w4c"])
    at = (16 + 4) * 16384 + 17 * 64 + 8 * ((44 // 8) ^ 1) + 44 % 8
    assert float(image[at]) == float(c["w4c"][300, 17])


def test_chain_reference_on_the_decoded_matrices_is_bitwise():
    """The concat probe's plain version on the matrices read back out of
    the image equals it on the originals bit for bit (ws[4] zeroed: concat
    does not read it)."""
    c = anatomy.chain_operands(256, 5)
    dec = _decode(anatomy.chain_image(c["ws"], c["w4c"]))
    ws = dec[:4] + [torch.zeros(W, W, dtype=torch.bfloat16)] + dec[5:]
    mine = dict(c, ws=ws, w4c=dec[4])
    ref = anatomy._chain_reference("concat", *anatomy.chain_inputs(c, True))
    got = anatomy._chain_reference("concat",
                                   *anatomy.chain_inputs(mine, True))
    assert ref.shape == (256, 128) and torch.equal(got, ref)


# sha256 of the fused kernels' image indices before the image helper was
# generalised (slab_index / gather_image): they must not move
WEIGHT_INDEX_SHA = {
    (64, 80, 16, True, False):
        "01b7e2c153a68759f7d7f78461184216bfa759f0d1dbcb33528c60d4402153f6",
    (64, 80, 16, True, True):
        "1efcd1d127942f74f68b92fec2e8fa3ccd8025a3bf9589e6a0799623517631cc",
    (64, 32, 0, False, False):
        "035b67acbc71d8ec961c993d4ea40fd7bcea7ff370e0724880bb391d49e31fd9",
    (64, 32, 0, False, True):
        "ec5bed9cf452956ee682aa2f41bdfccce69cc953faca486cc34e99cc41b6bbc6",
}


@pytest.mark.parametrize("key", sorted(WEIGHT_INDEX_SHA))
def test_weight_image_index_is_unchanged(key):
    """The fine net (appearance 48, transient) and the coarse one (neither),
    forward and backward images."""
    idx = fm._image_index(*key)
    assert hashlib.sha256(idx.tobytes()).hexdigest() == WEIGHT_INDEX_SHA[key]
