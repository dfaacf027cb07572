"""What the bf16 fused kernels' wrapper does in Python, on the CPU: the
weight images (the packed weights cut into 64-row slabs in the layout the
tensor-core operand has in shared memory), the tile and grid arithmetic, and
the reckoning of the backward's operand tiles.  The kernels themselves run
only on a card (tests/test_torch_cuda.py)."""
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
    return fm.pack_weights(model, a_dim, transient, torch.bfloat16, 10, 4, 16)


@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("a_dim", [48, 0])
def test_weight_image_is_a_permutation_with_zero_padding(a_dim, transient):
    net = _net(a_dim, transient)
    image = fm.weight_image(net, transient)
    slabs, nbytes = fm.image_plan(net.k0, net.kd, net.kt, transient)
    assert image.dtype == torch.bfloat16 and image.numel() * 2 == nbytes
    idx = fm._image_index(net.k0, net.kd, net.kt, transient)
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
    image = fm.weight_image(net, transient, backward=backward)
    plan = fm.bwd_image_plan if backward else fm.image_plan
    slabs, nbytes = plan(net.k0, net.kd, net.kt, transient)
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
    idx = fm._image_index(net.k0, net.kd, net.kt, transient, True)
    total = sum(w.numel() for w in net.ws)
    slabs, _ = fm.bwd_image_plan(net.k0, net.kd, net.kt, transient)
    first_dgrad = next(s.at for s in slabs if s.dgrad) // 2
    assert set(np.unique(idx[first_dgrad:])) == set(range(total + 1))
    image = fm.weight_image(net, transient, backward=True)
    assert not image[torch.from_numpy(idx == total)].any()
    # slabs fit the kernels' ring stages and plan tables
    hdr = (CSRC / "fused_mlp_common.cuh").read_text()
    max_slabs = int(re.search(r"MAX_SLABS = (\d+);", hdr).group(1))
    assert len(slabs) <= max_slabs
    assert max(s.height for s in slabs) * 128 <= 256 * 128
    fwd, _ = fm.image_plan(net.k0, net.kd, net.kt, transient)
    assert len(fwd) <= max_slabs
    assert max(s.height for s in fwd) * 128 == 272 * 128


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
    assert fm.bwd_tile_counts(64, 80, 16, True) == (97, 149)
    # coarse pass: no appearance, no transient
    assert fm.bwd_tile_counts(64, 32, 0, False) == (79, 122)
    # the widest encoders: pe and the t tail take a second tile each
    saved, read = fm.bwd_tile_counts(128, 128, 128, True)
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
    pattern at least once; hi_hi_only reaches both the one- and the
    two-warpgroup product loop (the backward's)."""
    variants = fused_ablation.BWD_F32_VARIANTS
    texts = fused_ablation.patched_sources(variant, variants=variants)
    plain = {p.name: p.read_text() for p in CSRC.iterdir()}
    changed = {n for n in texts if texts[n] != plain[n]}
    assert changed == (set() if variant == "as_is"
                       else {"fused_mlp_common.cuh"})
    if variant == "hi_hi_only":
        for _, old, _, _ in variants[variant]:
            assert plain["fused_mlp_common.cuh"].count(old) == 2
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
