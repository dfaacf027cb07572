"""The chain probes' weight images and plans on the CPU, and the
generalised image helper behind both them and the fused kernels' images.

``ops/anatomy.py:chain_image`` lays the chain weights out as the concat and
split kernels (``csrc/anatomy_chain.cu``, the Hopper block) stream them:
layers 0-3, ``w4c``, layers 5-7; ``chain8_image`` as the chain8 kernel
does: the eight layers.  Each layer is cut into slabs of 64 input rows x
256 image rows, every slab the K-major, 128-byte-swizzled wgmma B operand
image (16-byte chunk c of image row i at chunk ``c ^ (i % 8)``).  The
kernels run only on a card (``tests/test_torch_cuda.py``); what they read
is checked here exactly.
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


def _shapes(skip):
    return anatomy.CHAIN_IMAGE_SHAPES if skip else anatomy.CHAIN8_IMAGE_SHAPES


def _decode(image, skip=True):
    """Every layer of the image back as its (K, 256) matrix, through the
    swizzle: element (image row i, contraction value 8 c + e) of a slab is
    at [slab][i][c ^ (i % 8)][e]."""
    slabs, _ = anatomy.chain_image_plan(skip)
    flat = image.view(torch.int16).numpy()
    out = [np.zeros((k, m), np.int16) for k, m in _shapes(skip)]
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


def test_chain8_plan_is_32_slabs_of_32_kb_in_consumption_order():
    slabs, nbytes = anatomy.chain_image_plan(False)
    assert len(slabs) == 32 and nbytes == 32 * 32768 == 1_048_576
    assert [s.at for s in slabs] == [32768 * j for j in range(32)]
    assert all(s.height == 256 and s.rows == 64 and s.cols == 256
               and not s.dgrad for s in slabs)
    assert [s.layer for s in slabs] == sum(([layer] * 4
                                            for layer in range(8)), [])
    assert [s.row0 for s in slabs] == [0, 64, 128, 192] * 8


def test_chain_plan_is_the_kernels_walk():
    """``make_chain_plan`` in the source, for each skip (0 chain8, 1
    concat, 2 split): one ``plan_seg`` a layer, 384 rows at layer 4 with a
    skip and 256 elsewhere, 256 image rows; plan_seg cuts ``rows`` into
    slabs of 64 of ``height * 128`` bytes each, in order.  The card's build
    is compared with the Python plan at its first launch
    (``ops/anatomy.py:_check_chain_plan``) and by tests/test_torch_cuda.py."""
    src = (CSRC / "anatomy_chain.cu").read_text()
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    body = re.search(
        r"inline int make_chain_plan\(Plan& p, int skip\) \{(.*?)\n\}",
        src, re.S).group(1)
    seg = re.findall(r"plan_seg\(p, at, (.*?), (\w+)\);", body)
    assert seg == [("l == 4 && skip != SKIP_NONE ? ACT_W : W_TRUNK",
                    "W_TRUNK")]
    assert "for (int l = 0; l < 8; ++l)" in body
    skips = dict(re.findall(r"SKIP_(\w+) = (\d)", src))
    assert skips == {"NONE": "0", "CONCAT": "1", "SPLIT": "2"}
    assert anatomy.CHAIN_PROBES == ("chain8", "concat", "split")
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", hdr)}
    for skip, name in enumerate(anatomy.CHAIN_PROBES):
        assert anatomy.PROBES[name].variant == skip
        off, at = [], 0
        for layer in range(8):
            rows = const["ACT_W"] if layer == 4 and skip != 0 \
                else const["W_TRUNK"]
            for _ in range(0, rows, 64):
                off.append(at)
                at += const["W_TRUNK"] * 128
        slabs, nbytes = anatomy.chain_image_plan(skip != 0)
        assert off == [s.at for s in slabs] and at == nbytes
        assert len(off) <= const["MAX_SLABS"]


def _stages(name):
    src = (CSRC / "anatomy_chain.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("probe,tiles", [("chain8", 4), ("split", 6)])
def test_chain_shared_memory_budget_at_the_shipped_ring_depth(probe, tiles):
    """chain8's two warpgroups hold h (4 operand tiles of 8 KB each); split
    adds x[:, :128] (2 tiles, the fused kernels' 48 KB a warpgroup).  At the
    ring depth each ships with, the 32 KB slabs, their barriers and the
    1024-byte alignment slack fit the 232,448 bytes a block can have; the
    source's own reckoning (``smem_bytes``) is the same sum."""
    stages = _stages({"chain8": "CHAIN8_STAGES",
                      "split": "SPLIT_STAGES"}[probe])
    assert 2 <= stages
    smem = 1024 + 2 * tiles * 8192 + stages * 32768 + 2 * stages * 8
    assert smem <= 232_448
    # at the fused kernels' three slabs
    at3 = 1024 + 2 * tiles * 8192 + 3 * 32768 + 48
    assert at3 == {"chain8": 164_912, "split": 197_680}[probe]
    # the deepest ring that fits: 5 slabs for chain8, 4 for split
    deepest = max(d for d in range(1, 8)
                  if 1024 + 2 * tiles * 8192 + d * 32784 <= 232_448)
    assert deepest == {"chain8": 5, "split": 4}[probe] and stages <= deepest
    src = (CSRC / "anatomy_chain.cu").read_text()
    body = re.search(
        r"constexpr int smem_bytes\(int skip, int nst\) \{(.*?)\n\}", src,
        re.S).group(1)
    assert "1024 + CONSUMERS * wg_tiles(skip) * TILE_BYTES" in body
    assert "nst * STAGE_BYTES_C + 2 * nst * 8" in body


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


@pytest.mark.parametrize("seed", [0, 1])
def test_chain8_image_is_a_permutation_that_decodes_to_each_layer(seed):
    c = anatomy.chain_operands(8, seed)
    image = anatomy.chain8_image(c["ws"])
    total = 8 * W * W
    assert image.dtype == torch.bfloat16 and image.numel() == total
    idx = anatomy._chain_index(False)
    assert np.array_equal(np.sort(idx), np.arange(total))
    flat = torch.cat([w.reshape(-1) for w in c["ws"]])
    assert torch.equal(image, flat[torch.from_numpy(idx)])
    got = _decode(image, skip=False)
    assert len(got) == 8
    for g, w in zip(got, c["ws"]):
        assert torch.equal(g, w)
    # one element by hand: ws[5][200, 33] is in slab 4 * 5 + 200 // 64 = 23,
    # image row 33, chunk (200 % 64) // 8 ^ 33 % 8
    at = 23 * 16384 + 33 * 64 + 8 * ((8 // 8) ^ 1) + 8 % 8
    assert float(image[at]) == float(c["ws"][5][200, 33])


def test_chain8_reference_on_the_decoded_matrices_is_bitwise():
    """chain8's plain version on the matrices read back out of its image
    equals it on the originals bit for bit."""
    c = anatomy.chain_operands(256, 6)
    dec = _decode(anatomy.chain8_image(c["ws"]), skip=False)
    ref = anatomy._chain_reference(None, *anatomy.chain_inputs(c, False))
    got = anatomy._chain_reference(
        None, *anatomy.chain_inputs(dict(c, ws=dec), False))
    assert ref.shape == (256, 128) and torch.equal(got, ref)


@pytest.mark.parametrize("seed", [0, 3])
def test_split_scratch_is_concat_image_byte_for_byte(seed, monkeypatch):
    """split streams exactly concat's image (its two products at layer 4
    read w4c's slabs in the image's order), chain8 its own; each wrapper
    checks its own variant's plan against the card's build (stubbed here:
    there is no card)."""
    checked = []
    monkeypatch.setattr(anatomy, "_check_chain_plan", checked.append)
    c = anatomy.chain_operands(8, seed)
    skip_ops = anatomy.chain_inputs(c, True)
    split = anatomy.PROBES["split"].scratch(skip_ops)
    concat = anatomy.PROBES["concat"].scratch(skip_ops)
    assert split.dtype == concat.dtype == torch.bfloat16
    assert torch.equal(split.view(torch.int16), concat.view(torch.int16))
    assert torch.equal(split, anatomy.chain_image(c["ws"], c["w4c"]))
    chain8 = anatomy.PROBES["chain8"].scratch(anatomy.chain_inputs(c, False))
    assert torch.equal(chain8, anatomy.chain8_image(c["ws"]))
    assert checked == [2, 1, 0]


# sha256 of the fused kernels' image indices before the image helper was
# generalised (slab_index / gather_image): they must not move.  Keys:
# (a_dim, t_dim, backward) of the bf16 layout at 10 / 4 frequencies
WEIGHT_INDEX_SHA = {
    (48, 16, False):
        "01b7e2c153a68759f7d7f78461184216bfa759f0d1dbcb33528c60d4402153f6",
    (48, 16, True):
        "1efcd1d127942f74f68b92fec2e8fa3ccd8025a3bf9589e6a0799623517631cc",
    (0, 0, False):
        "035b67acbc71d8ec961c993d4ea40fd7bcea7ff370e0724880bb391d49e31fd9",
    (0, 0, True):
        "ec5bed9cf452956ee682aa2f41bdfccce69cc953faca486cc34e99cc41b6bbc6",
}


@pytest.mark.parametrize("key", sorted(WEIGHT_INDEX_SHA))
def test_weight_image_index_is_unchanged(key):
    """The fine net (appearance 48, transient) and the coarse one (neither),
    forward and backward images."""
    a_dim, t_dim, backward = key
    idx = fm.image_index(fm.Layout(torch.bfloat16, 10, 4, a_dim, t_dim),
                         backward)
    assert hashlib.sha256(idx.tobytes()).hexdigest() == WEIGHT_INDEX_SHA[key]
