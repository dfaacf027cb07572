"""What the bf16 fused kernels' wrapper does in Python, on the CPU: the
weight images (the packed weights cut into 64-row slabs in the layout the
tensor-core operand has in shared memory), the tile and grid arithmetic, and
the reckoning of the backward's operand tiles.  The kernels themselves run
only on a card (tests/test_torch_cuda.py)."""
import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fl_torch.experiments import fused_ablation, sin_ablation
from nerf_fl_torch.models import NeRFConfig, init_nerf
from nerf_fl_torch.ops import fused_mlp as fm

CSRC = Path(fm.__file__).resolve().parent.parent / "csrc"


def _net(a_dim, transient, seed=0):
    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                                 in_channels_a=a_dim or 48,
                                 encode_transient=True),
                      generator=torch.Generator().manual_seed(seed))
    return fm.pack_weights(model, fm.Layout(torch.bfloat16, 10, 4, a_dim,
                                            16 if transient else 0))


@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("a_dim", [48, 0])
def test_weight_image_is_a_permutation_with_zero_padding(a_dim, transient):
    net = _net(a_dim, transient)
    image = fm.weight_image(net)
    slabs, nbytes = fm.image_plan(net.layout)
    assert image.dtype == torch.bfloat16 and image.numel() * 2 == nbytes
    idx = fm.image_index(net.layout)
    total = sum(w.numel() for w in net.ws)
    real = idx < total
    # every weight exactly once, everything else is the zero slot
    assert np.array_equal(np.sort(idx[real]), np.arange(total))
    assert (idx[~real] == total).all()
    assert not image[torch.from_numpy(~real)].any()
    # invert: scatter the image back and compare exactly, layer by layer
    flat = torch.zeros(total + 1, dtype=torch.bfloat16)
    flat[torch.from_numpy(idx)] = image
    at = 0
    for w in net.ws:
        assert torch.equal(flat[at:at + w.numel()].view_as(w), w)
        at += w.numel()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("a_dim,transient", [(48, True), (0, False)])
def test_weight_image_is_the_swizzled_operand_image(a_dim, transient,
                                                    backward):
    """Element (image row i, contraction value k) of a slab sits at 16-byte
    chunk (k // 8) ^ (i % 8) of row i, and is the weight ``Slab`` says."""
    net = _net(a_dim, transient, seed=1)
    image = fm.weight_image(net, backward=backward)
    slabs, nbytes = fm.image_plan(net.layout, backward)
    assert image.numel() * 2 == nbytes
    assert [s.at for s in slabs] == list(np.cumsum(
        [0] + [s.height * 128 for s in slabs[:-1]]))
    rng = np.random.default_rng(0)
    for sl in slabs:
        w = net.ws[sl.layer]
        for _ in range(40):
            i, k = int(rng.integers(sl.height)), int(rng.integers(64))
            got = float(image[sl.at // 2 + i * 64
                              + 8 * ((k // 8) ^ (i % 8)) + k % 8])
            if sl.dgrad:
                ok = i < sl.rows and k < sl.cols
                ref = float(w[sl.row0 + i, sl.col0 + k]) if ok else 0.0
            else:
                ok = k < sl.rows and i < sl.cols
                ref = float(w[sl.row0 + k, sl.col0 + i]) if ok else 0.0
            assert got == ref, (sl, i, k)


@pytest.mark.parametrize("transient", [True, False])
def test_backward_image_holds_every_weight_it_contracts(transient):
    """The backward's image: the forward recompute (without fs2's sigma
    block and the heads) and the dgrad tiles; every weight of every layer
    appears among the dgrad slabs, padding is zero."""
    net = _net(48, transient)
    idx = fm.image_index(net.layout, True)
    total = sum(w.numel() for w in net.ws)
    slabs, _ = fm.image_plan(net.layout, True)
    first_dgrad = next(s.at for s in slabs if s.dgrad) // 2
    assert set(np.unique(idx[first_dgrad:])) == set(range(total + 1))
    image = fm.weight_image(net, backward=True)
    assert not image[torch.from_numpy(idx == total)].any()
    # slabs fit the kernels' ring stages and plan tables
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    max_slabs = int(re.search(r"MAX_SLABS = (\d+);", hdr).group(1))
    assert len(slabs) <= max_slabs
    assert max(s.height for s in slabs) * 128 <= 256 * 128
    fwd, _ = fm.image_plan(net.layout)
    assert len(fwd) <= max_slabs
    assert max(s.height for s in fwd) * 128 == 272 * 128


# sha256 of each layout's image index (the numpy array ``weight_image``
# gathers an image through: with the weights it fixes the image), as the
# code before the ``Layout`` record computed it, on the same layouts: bf16
# and f32 NeRF-W at appearance 0 / 48, transient off / on, forward /
# backward; the sigma-only image at 10 frequencies; the IPE pair at 16
IMAGE_INDEX_SHA = {
    "bf16-a0-nt-fwd":
        "035b67acbc71d8ec961c993d4ea40fd7bcea7ff370e0724880bb391d49e31fd9",
    "bf16-a0-nt-bwd":
        "ec5bed9cf452956ee682aa2f41bdfccce69cc953faca486cc34e99cc41b6bbc6",
    "bf16-a0-t-fwd":
        "fc9658d73fdc0210236752cbf21c76f32e287c4850246a30ab20977a7d9c15e7",
    "bf16-a0-t-bwd":
        "7f53aa7dfc0467dc4699bd03b6012e7c02628bb60f9de38b2cfb565ba2f626fa",
    "bf16-a48-nt-fwd":
        "1887882d90c20f4bbd215d3875cf0bba2a936edff6110a7a766fdeca82544a02",
    "bf16-a48-nt-bwd":
        "c5430d6da127c376cdd13a12175592fc0c4dcf8d1650b11ac37c602663f32bbc",
    "bf16-a48-t-fwd":
        "01b7e2c153a68759f7d7f78461184216bfa759f0d1dbcb33528c60d4402153f6",
    "bf16-a48-t-bwd":
        "1efcd1d127942f74f68b92fec2e8fa3ccd8025a3bf9589e6a0799623517631cc",
    "f32-a0-nt-fwd":
        "54f927a7f435f807f9576b35da0a9868e1a331e199b149b47bdd846f4abb9724",
    "f32-a0-nt-bwd":
        "fec65a363aa73438c1765375a99088fc1e6c1d0e53530d13f38fa48de733cb7c",
    "f32-a0-t-fwd":
        "baf3d6924624a1cd7c3080d2162678cd406d3e04ad004254318969ab50eee7e9",
    "f32-a0-t-bwd":
        "525f0832e11c4996b880e6d18e376b9073013282a7ce2088bd022e5296dd3f1b",
    "f32-a48-nt-fwd":
        "1178731d1e868be22d37b4401ad855cbbef906795e4c087666f24246e589c468",
    "f32-a48-nt-bwd":
        "f2279d54f340ccbd61562746e0de181d7413f5c6d6b6ba05823d2086d3edc856",
    "f32-a48-t-fwd":
        "eca58140f835bfeb29bc60cf537505541bcf1faedef580f66e1370e3ccd88804",
    "f32-a48-t-bwd":
        "3f6f39aa2580fb2bdac03e563cf4435b3ff99ce8ef494c6008834de266b84694",
    "sigma-f10-fwd":
        "390aafc4e48bbe46d49b97b5616c1836cb1261b5be33a7dc1dd48138b3b5c9bd",
    "ipe-f16-fwd":
        "12f2002ae1076541d1ab4b2140d716c0e5374214d6bb5a586b74dab1392c89c2",
    "ipe-f16-bwd":
        "ce7b88cdc698aba2c9cc6de869dcb5ec1449e5d4c6e115a557983eecf441d8b8",
}


def _named_layout(name):
    """The layout and walk a key of ``IMAGE_INDEX_SHA`` names."""
    kind, dims, *rest = name.split("-")
    backward = rest[-1] == "bwd"
    if kind == "sigma":
        return fm.Layout(torch.float32, int(dims[1:]),
                         variant=fm.SIGMA), backward
    if kind == "ipe":
        return fm.Layout(torch.float32, int(dims[1:]), 4,
                         variant=fm.IPE), backward
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return fm.Layout(dtype, 10, 4, int(dims[1:]),
                     16 if rest[0] == "t" else 0), backward


@pytest.mark.parametrize("name", sorted(IMAGE_INDEX_SHA))
def test_image_index_is_unchanged(name):
    """Every layout's image index is bit for bit the one it was before
    the layout record: so is every image the kernels stream."""
    lay, backward = _named_layout(name)
    idx = fm.image_index(lay, backward)
    assert idx.dtype == np.int64
    assert hashlib.sha256(idx.tobytes()).hexdigest() == IMAGE_INDEX_SHA[name]


@pytest.mark.parametrize("n,tiles,grid", [(0, 0, 0), (1, 1, 1), (127, 1, 1),
                                          (128, 1, 1), (129, 2, 2),
                                          (70_001, 547, 132)])
def test_tile_and_grid_arithmetic(n, tiles, grid):
    assert fm.TILE_ROWS == 128
    assert fm.fwd_tiles(n) == tiles
    assert fm.fwd_grid(n, 132) == grid
    # every point in exactly one tile; the last tile's spare rows < 128
    assert tiles * fm.TILE_ROWS >= n > (tiles - 1) * fm.TILE_ROWS or n == 0
    # persistent blocks cover every tile once
    seen = sorted(t for b in range(grid) for t in range(b, tiles, grid))
    assert seen == list(range(tiles))


def test_backward_operand_tile_counts():
    # flagship fine pass: pe 1, trunk 8 x 4, xyz_final 4, dir tail 2, hd 2,
    # t tail 1, transient 4 x 2 activations; 9 x 4 + 2 + 4 x 2 + 1 cotangents
    bf = torch.bfloat16
    assert fm.bwd_tile_counts(fm.Layout(bf, 10, 4, 48, 16)) == (97, 149)
    # coarse pass: no appearance, no transient
    assert fm.bwd_tile_counts(fm.Layout(bf, 10, 4)) == (79, 122)
    # the widest encoders (k0, kd, kt 128): pe and the t tail take a second
    # tile each
    wide = fm.Layout(bf, 20, 20, 0, 120)
    assert (wide.k0, wide.kd, wide.kt) == (128, 128, 128)
    saved, read = fm.bwd_tile_counts(wide)
    assert saved == 97 + 2 and read > 149


@pytest.mark.parametrize("variant", sorted(fused_ablation.VARIANTS))
def test_ablation_patterns_match_the_sources(variant):
    """Each ablation edits the kernel's sources by text: its patterns must
    occur exactly once, and only the named part may change."""
    texts = fused_ablation.patched_sources(variant)
    plain = {p.name: p.read_text() for p in CSRC.iterdir()}
    assert set(texts) == {n for n in plain if n.endswith((".cu", ".cuh"))}
    changed = {n for n in texts if texts[n] != plain[n]}
    assert changed == {name for name, _, _ in fused_ablation.VARIANTS[variant]}
    with pytest.raises(ValueError, match="need a card"):
        fused_ablation.main(n=128, device="cpu")


@pytest.mark.parametrize("variant", sorted(fused_ablation.BWD_F32_VARIANTS))
def test_f32_bwd_ablation_patterns_match_the_sources(variant):
    """The f32 backward's ablations edit the shared header alone, each
    pattern at least once; hi_hi_only reaches the f32 block's one product
    loop (tf::mma_seg, which every f32 fused kernel runs)."""
    variants = fused_ablation.BWD_F32_VARIANTS
    texts = fused_ablation.patched_sources(variant, variants=variants)
    plain = {p.name: p.read_text() for p in CSRC.iterdir()}
    changed = {n for n in texts if texts[n] != plain[n]}
    assert changed == (set() if variant == "as_is"
                       else {"fused_mlp_common.cuh"})
    if variant == "hi_hi_only":
        for _, old, _, _ in variants[variant]:
            assert plain["fused_mlp_common.cuh"].count(old) == 1
    with pytest.raises(ValueError, match="need a card"):
        fused_ablation.main(n=128, device="cpu", kernel="bwd_f32")


@pytest.mark.parametrize("variant", sorted(sin_ablation.VARIANTS))
def test_sin_ablation_patterns_match_the_source(variant):
    """The sin kernel's layouts edit anatomy_pe.cu alone, each pattern
    exactly once."""
    texts = fused_ablation.patched_sources(variant,
                                           variants=sin_ablation.VARIANTS)
    plain = {p.name: p.read_text() for p in CSRC.iterdir()}
    changed = {n for n in texts if texts[n] != plain[n]}
    assert changed == (set() if variant == "as_is" else {"anatomy_pe.cu"})
    with pytest.raises(ValueError, match="need a card"):
        sin_ablation.main(n=128, device="cpu")
