"""Fused positional encoding + NeRF-W MLP, forward and backward: the Hopper
kernels, their plain PyTorch versions and the autograd wrapper.

Counterpart of ``nerf_fl_tpu/ops/fused_mlp.py``.  The kernels are
``csrc/fused_mlp_fwd.cu`` and ``csrc/fused_mlp_bwd.cu``; this module packs
their operands and launches them, and keeps ``fused_mlp_reference`` and
``fused_mlp_bwd_reference``, the same arithmetic in eager torch with the
same rounding points.  ``fused_apply_nerf`` is differentiable: it runs both
through a ``torch.autograd.Function`` that launches the kernels for CUDA
tensors (or raises) and runs the plain versions only for tensors on the CPU.
``fused_sigma`` is the render's test-time coarse pass: the static sigma
alone, in f32, through the sigma-only kernel of the same source
(``fused_sigma_cuda``; plain version ``fused_sigma_reference``), with no
backward.  ``fused_apply_mip`` is mip-NeRF's field (``ipe=True`` below):
the f32 pair's IPE instances, which take the integrated positional
encoding of each point's Gaussian in place of PE(xyz) and the skip after
layer 4 (packed layer 5, whose input rows are packed [enc | h]), and
return no input cotangent.

Layouts:
  * input, one packed (N, 128) f32 row per point:
    ``[xyz 0:3 | dir 3:6 | a 6:6+a_dim | t ...+t_dim | 0]`` (as the TPU
    kernel's); with ``ipe``, ``[mean 0:3 | dir 3:6 | var 6:9 | 0]``
    (``pack_ipe_inputs``);
  * output, (N, 16) f32 pre-activations: cols 0-2 static rgb, 3 static
    sigma, 4-6 transient rgb, 7 transient sigma, 8 beta, the rest zero;
  * weights, (K, N_out) row-major in the compute dtype, each K and N_out
    padded with zeros only to the next multiple of 16 (the tensor-core
    granule).  Biases f32.  See ``pack_weights``.  The bf16 kernels stream
    them from ``weight_image``, the same values cut into 64-row slabs in the
    layout their tensor-core operand has in shared memory; the f32 kernels
    from ``f32_weight_image``, each weight split into tf32 hi and lo parts
    (``tf32_split``) and cut into stages of 32 rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..core.encoding import integrated_pos_enc, sin_cw
from ..models.mlp import NeRF, softplus
from . import _build

LANES = 128
OUT_W = 16
W_TRUNK = 256
W_HALF = 128

# packed output columns
COL_S_RGB = 0       # 0..2
COL_S_SIGMA = 3
COL_T_RGB = 4       # 4..6
COL_T_SIGMA = 7
COL_T_BETA = 8

N_LAYERS = 16   # trunk 0..7, fs2, dir, rgb head, transient 0..3, t heads
SIGMA_LAYERS = 9    # the sigma-only kernel's: trunk 0..7, fs2
SKIP = 4            # the trunk layer that takes [PE | h] (nerf_pl's)
IPE_SKIP = 5        # the IPE layout's: mip-NeRF's [h | enc], packed [enc | h]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 forward kernel's block (csrc/fused_mlp_common.cuh, namespace hop)
TILE_ROWS = 128     # points a block holds at a time
SLAB_K = 64         # input rows of a weight slab: one 128-byte swizzle row
# the f32 kernels' block (namespace tf)
F32_ROWS = 64       # points a block: one consumer warpgroup
F32_K = 32          # contraction values of a stage: one 128-byte tf32 row
F32_PIECE = 128     # output columns of a stage (the last of fs2's 272: 144)
# the order of each 8 contraction values in an f32 stage: the A fragment of
# a thread holds columns 2q and 2q + 1 of its group at indices q and q + 4
F32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


# ----------------------------------------------------------------------
# encoder constants and scale rows
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _encoder_consts(n_freq_xyz: int, n_freq_dir: int, a_dim: int):
    """Constant frequency rows + phase/trig/mask rows, numpy f32.

    PxR/PdR (3, 128): row c holds the coefficient of input component c for
    every PE output column (1 on its identity column, 2^k on that
    frequency's sin and cos columns).  ph rows are quarter-turn phases (0.25
    on cos columns), trg rows mark trig columns, ma marks the appearance
    columns of the direction tail.  Column layout matches core/encoding.posenc.
    """
    def pe_rows(n_freq):
        R = np.zeros((3, LANES), np.float32)
        ph = np.zeros((1, LANES), np.float32)
        trg = np.zeros((1, LANES), np.float32)
        for c in range(3):
            R[c, c] = 1.0
        for k in range(n_freq):
            f = float(2.0 ** k)
            base = 3 + 6 * k
            for c in range(3):
                R[c, base + c] = f
                R[c, base + 3 + c] = f
                trg[0, base + c] = 1.0
                trg[0, base + 3 + c] = 1.0
                ph[0, base + 3 + c] = 0.25    # cos = sin(+1/4 turn)
        return R, ph, trg

    PxR, phx, trgx = pe_rows(n_freq_xyz)
    PdR, phd, trgd = pe_rows(n_freq_dir)
    d_pe_dim = 3 + 6 * n_freq_dir
    ma = np.zeros((1, LANES), np.float32)
    ma[0, d_pe_dim:d_pe_dim + a_dim] = 1.0
    return {"PxR": PxR, "phx": phx, "trgx": trgx,
            "PdR": PdR, "phd": phd, "trgd": trgd, "ma": ma}


def default_scale_rows(n_freq_xyz: int, n_freq_dir: int, a_dim: int,
                       barf_w_xyz=None, barf_w_dir=None, device=None):
    """(1, 128) f32 per-column scale rows: 1 on identity columns, the BARF
    annealing weight (or 1) on each frequency's sin/cos block, 0 on
    padding."""
    def row(n_freq, extra_ident, w):
        wf = (torch.ones(n_freq, dtype=torch.float32, device=device)
              if w is None else torch.as_tensor(w, dtype=torch.float32,
                                                device=device))
        r = torch.cat([torch.ones(3, dtype=torch.float32, device=device),
                       wf.repeat_interleave(6),
                       torch.ones(extra_ident, dtype=torch.float32,
                                  device=device)])
        return torch.nn.functional.pad(r, (0, LANES - r.shape[0]))[None, :]
    return (row(n_freq_xyz, 0, barf_w_xyz),
            row(n_freq_dir, a_dim, barf_w_dir))


# ----------------------------------------------------------------------
# operand packing
# ----------------------------------------------------------------------

def pack_inputs(xyz, dirs, a_emb=None, t_emb=None) -> torch.Tensor:
    """One (N, 128) f32 row per point: [xyz | dir | a | t | 0]."""
    parts = [xyz, dirs] + [p for p in (a_emb, t_emb) if p is not None]
    inp = torch.cat([p.to(torch.float32) for p in parts], dim=-1)
    if inp.shape[-1] > LANES:
        raise ValueError(f"packed input has {inp.shape[-1]} > {LANES} columns")
    return torch.nn.functional.pad(inp, (0, LANES - inp.shape[-1]))


def pack_ipe_inputs(mean, dirs, var) -> torch.Tensor:
    """The IPE layout's (N, 128) f32 row per point: [mean | dir | var |
    0], a Gaussian's mean and diagonal variance and the unit view
    direction."""
    return pack_inputs(mean, dirs, var)


def ipe_k0(n_freq: int) -> int:
    """Padded width of the IPE: 6 n_freq columns."""
    return _round16(6 * n_freq)


class PackedNet(NamedTuple):
    ws: List[torch.Tensor]    # (K, N_out) compute dtype, contiguous
    bs: List[torch.Tensor]    # (N_out,) f32
    k0: int                   # padded PE(xyz) width
    kd: int                   # padded [PE(dir) | a] width
    kt: int                   # padded t width (0 without transient)


def field_linears(model: NeRF, has_transient: bool) -> List[torch.nn.Linear]:
    """The field's layers in the fixed order the autograd Function takes
    their (weight, bias) pairs: trunk 0..7, xyz_final, static_sigma, dir,
    static_rgb, then with transient: transient layers 0..3, rgb, sigma,
    beta."""
    lins = list(model.xyz) + [model.xyz_final, model.static_sigma,
                              model.dir, model.static_rgb]
    if has_transient:
        tp = model.transient
        lins += list(tp.layers) + [tp.rgb, tp.sigma, tp.beta]
    return lins


def pack_weights(model: NeRF, a_dim: int, has_transient: bool, dtype,
                 n_freq_xyz: int, n_freq_dir: int,
                 t_dim: int = 0, ipe: bool = False) -> PackedNet:
    """Lay the nn.Linear (out, in) weights out as the kernel reads them:
    (in, out) row-major, zero-padded to 16-multiples.  Head columns land at
    their packed output positions.  Layer order: trunk 0..7, fs2 =
    [xyz_final | static sigma at col 256+3], dir, static rgb head, then with
    transient: transient 0..3, fused transient heads [rgb | sigma | beta] at
    cols 4..8.  ``ipe``: mip-NeRF's field (no appearance, no transient),
    whose layer 5 takes [h | enc], packed as [enc padded to k0 | h], k0 =
    ``ipe_k0(n_freq_xyz)``."""
    params = [t.detach() for lin in field_linears(model, has_transient)
              for t in (lin.weight, lin.bias)]
    return _pack(params, a_dim, has_transient, dtype, n_freq_xyz, n_freq_dir,
                 t_dim, ipe)


def pack_sigma_weights(model: NeRF, n_freq_xyz: int) -> PackedNet:
    """``pack_weights``' first ``SIGMA_LAYERS`` layers in f32 (the trunk and
    fs2), all that the sigma-only kernel reads."""
    params = [t.detach() for lin in field_linears(model, False)[:10]
              for t in (lin.weight, lin.bias)]
    return _pack(params, 0, False, torch.float32, n_freq_xyz, 0, 0)


def _pack(params, a_dim: int, has_transient: bool, dtype, n_freq_xyz: int,
          n_freq_dir: int, t_dim: int, ipe: bool = False) -> PackedNet:
    """``pack_weights`` from the flat [weight, bias, ...] list of
    ``field_linears`` order (of its first ten layers alone: the trunk and
    fs2, ``pack_sigma_weights``)."""
    f32 = torch.float32
    dev = params[0].device
    k0 = ipe_k0(n_freq_xyz) if ipe else _round16(3 + 6 * n_freq_xyz)
    kd = _round16(3 + 6 * n_freq_dir + a_dim)
    kt = _round16(t_dim) if has_transient else 0
    lw = [w.to(f32).t() for w in params[0::2]]       # (in, out)
    lb = [b.to(f32) for b in params[1::2]]
    n_xyz_in = lw[0].shape[0]

    def pad_rows(w, rows):
        return torch.nn.functional.pad(w, (0, 0, 0, rows - w.shape[0]))

    def cols(n_in, n_out, parts):
        """(n_in, n_out) zeros with each (col, (in, k) block) placed."""
        out = torch.zeros(n_in, n_out, dtype=f32, device=dev)
        for at, w in parts:
            out[:, at:at + w.shape[1]] = w
        return out

    def bias_at(n_out, parts):
        out = torch.zeros(n_out, dtype=f32, device=dev)
        for at, b in parts:
            out[at:at + b.shape[0]] = b
        return out

    ws, bs = [], []
    for i in range(8):
        if i == 0:
            w = pad_rows(lw[0], k0)
        elif i == 4 and not ipe:
            w = torch.cat([pad_rows(lw[4][:n_xyz_in], k0), lw[4][n_xyz_in:]])
        elif i == IPE_SKIP and ipe:
            # mip-NeRF's [h | enc] rows as [enc | h]
            w = torch.cat([pad_rows(lw[i][W_TRUNK:], k0), lw[i][:W_TRUNK]])
        else:
            w = lw[i]
        ws.append(w)
        bs.append(lb[i])
    # fs2: (256, 256 + 16) = [xyz_final | static sigma at col 256 + 3]
    ws.append(cols(W_TRUNK, W_TRUNK + OUT_W,
                   [(0, lw[8]), (W_TRUNK + COL_S_SIGMA, lw[9])]))
    bs.append(bias_at(W_TRUNK + OUT_W,
                      [(0, lb[8]), (W_TRUNK + COL_S_SIGMA, lb[9])]))
    if len(lw) > 10:
        # dir branch: (256 + kd, 128)
        ws.append(torch.cat([lw[10][:W_TRUNK],
                             pad_rows(lw[10][W_TRUNK:], kd)]))
        bs.append(lb[10])
        # static rgb head at output cols 0..2: (128, 16)
        ws.append(cols(W_HALF, OUT_W, [(COL_S_RGB, lw[11])]))
        bs.append(bias_at(OUT_W, [(COL_S_RGB, lb[11])]))
    if has_transient:
        ws.append(torch.cat([lw[12][:W_TRUNK],
                             pad_rows(lw[12][W_TRUNK:], kt)]))
        bs.append(lb[12])
        ws += lw[13:16]
        bs += lb[13:16]
        heads_at = [(COL_T_RGB, 16), (COL_T_SIGMA, 17), (COL_T_BETA, 18)]
        ws.append(cols(W_HALF, OUT_W, [(c, lw[j]) for c, j in heads_at]))
        bs.append(bias_at(OUT_W, [(c, lb[j]) for c, j in heads_at]))
    ws = [w.to(dtype).contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    return PackedNet(ws, bs, k0, kd, kt)


def unpack_weight_grads(dws: List[torch.Tensor], dbs: List[torch.Tensor],
                        n_xyz_in: int, n_dir_in: int, n_t_in: int,
                        has_transient: bool,
                        ipe: bool = False) -> List[torch.Tensor]:
    """Padded (K, N_out) f32 weight-grad slabs and (N_out,) bias grads ->
    the flat [dweight (out, in), dbias, ...] list of ``field_linears``
    order.  ``n_dir_in`` / ``n_t_in`` are the dir / first transient layer's
    conditioning widths beyond the 256 trunk columns (27 + a_dim, t_dim).
    Every padded row and column is dropped: the kernels' heads compute all
    16 output columns, only the live ones are parameters.  ``ipe``: the
    IPE layout's (``pack_weights``)."""
    k0 = dws[0].shape[0]

    def lin(dw, db):
        return [dw.t().contiguous(), db.contiguous()]

    def split(dw, at, n, rest):
        return torch.cat([dw[:at], dw[rest:rest + n]])

    out = []
    for i in range(8):
        dw = dws[i]
        if i == 0:
            dw = dw[:n_xyz_in]
        elif i == 4 and not ipe:
            dw = torch.cat([dw[:n_xyz_in], dw[k0:]])
        elif i == IPE_SKIP and ipe:
            dw = torch.cat([dw[k0:], dw[:n_xyz_in]])
        out += lin(dw, dbs[i])
    c = W_TRUNK + COL_S_SIGMA
    out += lin(dws[8][:, :W_TRUNK], dbs[8][:W_TRUNK])
    out += lin(dws[8][:, c:c + 1], dbs[8][c:c + 1])
    out += lin(dws[9][:W_TRUNK + n_dir_in], dbs[9])
    out += lin(dws[10][:, COL_S_RGB:COL_S_RGB + 3],
               dbs[10][COL_S_RGB:COL_S_RGB + 3])
    if has_transient:
        out += lin(dws[11][:W_TRUNK + n_t_in], dbs[11])
        for i in (12, 13, 14):
            out += lin(dws[i], dbs[i])
        for c, n in ((COL_T_RGB, 3), (COL_T_SIGMA, 1), (COL_T_BETA, 1)):
            out += lin(dws[15][:, c:c + n], dbs[15][c:c + n])
    return out


# ----------------------------------------------------------------------
# the bf16 forward kernel's weight image and grid
# ----------------------------------------------------------------------

class Slab(NamedTuple):
    """One weight slab of an image: ``height`` image rows of 64 contraction
    values (128 bytes).  Forward slabs (``dgrad`` False) are W^T tiles: image
    row i is output column ``col0 + i``, contraction value k is input row
    ``row0 + k`` (``rows`` of them are real).  Dgrad slabs are tiles of W
    itself: image row i is input row ``row0 + i`` (``rows`` real),
    contraction value k is output column ``col0 + k`` (``cols`` real)."""
    layer: int
    dgrad: bool
    row0: int
    rows: int
    col0: int
    cols: int
    height: int
    at: int         # byte offset in the image


def _cut(slabs, at, layer, dgrad, row0, rows, col0, cols, height):
    """Append the slabs of one segment (one per 64 contraction values);
    returns the next byte offset."""
    n = cols if dgrad else rows
    for c in range(0, n, SLAB_K):
        m = min(SLAB_K, n - c)
        if dgrad:
            slabs.append(Slab(layer, True, row0, rows, col0 + c, m, height, at))
        else:
            slabs.append(Slab(layer, False, row0 + c, m, col0, cols, height, at))
        at += height * SLAB_K * 2
    return at


def _cut32(slabs, at, layer, dgrad, row0, rows, col0, cols, height):
    """``_cut`` for the f32 kernels: one stage per 32 contraction values
    and output piece (``_pieces(height)`` image rows, starting at the
    piece's first output column, or input row for dgrad), the hi then the
    lo part, each ``height`` rows of 32 tf32 values (128 bytes).  A stage's
    ``rows`` / ``cols`` count the real ones of its own range."""
    n = cols if dgrad else rows
    for c in range(0, n, F32_K):
        m = min(F32_K, n - c)
        p0 = 0
        for h in _pieces(height):
            if dgrad:
                slabs.append(Slab(layer, True, row0 + p0,
                                  max(0, min(h, rows - p0)), col0 + c, m, h,
                                  at))
            else:
                slabs.append(Slab(layer, False, row0 + c, m, col0 + p0,
                                  max(0, min(h, cols - p0)), h, at))
            at += 2 * h * F32_K * 4
            p0 += h
    return at


def _pieces(n: int):
    """The output pieces of an f32 product n wide (tf::plan_seg): 128
    columns each, the last taking up to 144."""
    if n <= F32_PIECE + OUT_W:
        return [n]
    k = n // F32_PIECE
    return [F32_PIECE] * (k - 1) + [n - F32_PIECE * (k - 1)]


def _trunk_slabs(slabs, at, k0, cut, skip=SKIP):
    """The trunk's slabs (layers 0..7, layer ``skip`` cut per source) in
    consumption order; returns the next byte offset."""
    at = cut(slabs, at, 0, False, 0, k0, 0, W_TRUNK, W_TRUNK)
    for i in range(1, 8):
        if i == skip:
            at = cut(slabs, at, i, False, 0, k0, 0, W_TRUNK, W_TRUNK)
        at = cut(slabs, at, i, False, k0 if i == skip else 0, W_TRUNK, 0,
                 W_TRUNK, W_TRUNK)
    return at


def _forward_slabs(slabs, at, k0, kd, kt, has_transient, heads, cut=_cut,
                   skip=SKIP):
    """The forward's slabs in consumption order.  A layer whose input is
    two sources ([pe | h], [xyz_final | tail]) is cut per source, so a slab
    never straddles them; a source's last slab may hold fewer than 64 rows
    and is zero-padded.  ``heads``: with fs2's sigma block and the two
    heads (the backward's recompute needs neither).  ``cut``: ``_cut`` (the
    bf16 image) or ``_cut32`` (the f32 image)."""
    def seg(layer, row0, rows, cols):
        return cut(slabs, at, layer, False, row0, rows, 0, cols, cols)

    at = _trunk_slabs(slabs, at, k0, cut, skip)
    at = seg(8, 0, W_TRUNK, W_TRUNK + OUT_W if heads else W_TRUNK)
    at = seg(9, 0, W_TRUNK, W_HALF)
    at = seg(9, W_TRUNK, kd, W_HALF)
    if heads:
        at = seg(10, 0, W_HALF, OUT_W)
    if has_transient:
        at = seg(11, 0, W_TRUNK, W_HALF)
        at = seg(11, W_TRUNK, kt, W_HALF)
        for i in (12, 13, 14):
            at = seg(i, 0, W_HALF, W_HALF)
        if heads:
            at = seg(15, 0, W_HALF, OUT_W)
    return at


def image_plan(k0: int, kd: int, kt: int, has_transient: bool):
    """The weight slabs in the order the bf16 forward kernel consumes them
    (csrc/fused_mlp_common.cuh:make_plan walks the same list), and the
    image's size in bytes."""
    slabs = []
    at = _forward_slabs(slabs, 0, k0, kd, kt, has_transient, True)
    return slabs, at


def bwd_image_plan(k0: int, kd: int, kt: int, has_transient: bool,
                   cut=_cut, ipe: bool = False):
    """The bf16 backward kernel's slabs (make_bwd_plan in the same header):
    the forward recompute, then for each layer from the heads down the
    tiles of W that ``g W^T`` contracts over, 64 output columns a slab.  A
    layer with two input sources runs two products: its 256 trunk rows
    (height 256) and its other rows padded to 128 (the pe / dir / t part).
    With ``cut=_cut32``, the f32 backward's stages (``f32_image_plan``);
    with ``ipe`` too, the IPE backward's (tf::make_bwd_plan with skip 5 and
    no d_inp): the skip at layer 5, without the products that only feed
    the input cotangent."""
    skip = IPE_SKIP if ipe else SKIP
    slabs = []
    at = _forward_slabs(slabs, 0, k0, kd, kt, has_transient, False, cut,
                        skip)

    def seg(layer, row0, rows, cols, height):
        return cut(slabs, at, layer, True, row0, rows, 0, cols, height)

    if has_transient:
        at = seg(15, 0, W_HALF, OUT_W, W_HALF)
        for i in (14, 13, 12):
            at = seg(i, 0, W_HALF, W_HALF, W_HALF)
        at = seg(11, 0, W_TRUNK, W_HALF, W_TRUNK)
        at = seg(11, W_TRUNK, kt, W_HALF, W_HALF)
    at = seg(10, 0, W_HALF, OUT_W, W_HALF)
    at = seg(9, 0, W_TRUNK, W_HALF, W_TRUNK)
    if not ipe:
        at = seg(9, W_TRUNK, kd, W_HALF, W_HALF)
    at = seg(8, 0, W_TRUNK, W_TRUNK + OUT_W, W_TRUNK)
    for i in range(7, 0, -1):
        if i == skip and not ipe:
            at = seg(i, 0, k0, W_TRUNK, W_HALF)
        at = seg(i, k0 if i == skip else 0, W_TRUNK, W_TRUNK, W_TRUNK)
    if not ipe:
        at = seg(0, 0, k0, W_TRUNK, W_HALF)
    return slabs, at


def f32_image_plan(k0: int, kd: int, kt: int, has_transient: bool,
                   backward: bool = False, ipe: bool = False):
    """The f32 kernels' stages (csrc/fused_mlp_common.cuh: tf::make_plan /
    tf::make_bwd_plan walk the same list) in consumption order, as ``Slab``
    rows of 32 contraction values and one output piece, and the image's
    size in bytes: the bf16 images' walks cut by ``_cut32``.  ``ipe``: the
    IPE kernels' (skip 5; the backward without the input cotangent's
    stages)."""
    if backward:
        return bwd_image_plan(k0, kd, kt, has_transient, cut=_cut32, ipe=ipe)
    slabs = []
    at = _forward_slabs(slabs, 0, k0, kd, kt, has_transient, True, _cut32,
                        IPE_SKIP if ipe else SKIP)
    return slabs, at


def f32_sigma_plan(k0: int):
    """``f32_image_plan`` of the sigma-only kernel (the header's
    tf::make_sigma_plan): the trunk's stages, then fs2's 16-column sigma
    block alone as one (256, 16) segment."""
    slabs = []
    at = _trunk_slabs(slabs, 0, k0, _cut32)
    at = _cut32(slabs, at, 8, False, 0, W_TRUNK, W_TRUNK, OUT_W, OUT_W)
    return slabs, at


def slab_index(shapes, slabs, nbytes: int) -> np.ndarray:
    """For every bf16 element of an image of ``slabs`` (``nbytes`` long) cut
    from layers of (K, N_out) ``shapes``, its index in the flat
    concatenation of those layers (row-major, layer after layer; a slab's
    ``layer`` is its position in ``shapes``), or the index one past its end
    for zero padding.

    A slab is a wgmma B operand's shared-memory image, K-major with the
    128-byte swizzle: one image row of 64 contraction values per column of
    the product, and 16-byte chunk c of image row i stored at chunk
    ``c ^ (i % 8)``.  So element [slab][i][c ^ (i % 8)][e] is contraction
    value ``8 c + e`` of image row i (see ``Slab``)."""
    base = np.concatenate([[0], np.cumsum([k * m for k, m in shapes])])
    idx = np.full(nbytes // 2, base[-1], np.int64)
    for sl in slabs:
        n_out = shapes[sl.layer][1]
        i = np.arange(sl.height)[:, None, None]
        c = np.arange(8)[None, :, None]
        e = np.arange(8)[None, None, :]
        k = 8 * c + e + 0 * i
        if sl.dgrad:
            src = base[sl.layer] + (sl.row0 + i) * n_out + sl.col0 + k
            real = (i < sl.rows) & (k < sl.cols)
        else:
            src = base[sl.layer] + (sl.row0 + k) * n_out + sl.col0 + i
            real = (k < sl.rows) & (i < sl.cols)
        dst = sl.at // 2 + i * SLAB_K + 8 * (c ^ (i % 8)) + e
        idx[dst.ravel()] = np.where(real, src, base[-1]).ravel()
    return idx


def f32_slab_index(shapes, slabs, nbytes: int) -> np.ndarray:
    """For every f32 element of an f32 image of ``slabs`` (``nbytes``
    long) cut from layers of (K, N_out) ``shapes``: its index into the
    concatenation [hi parts of those layers, lo parts, one zero], so that
    an image is that concatenation gathered through it.

    A stage is the hi then the lo part of a wgmma B operand's K-major
    image: one row of 32 tf32 values (128 bytes) per image row, 16-byte
    chunk c of row i at chunk ``c ^ (i % 8)``, and position k of a row holds
    contraction value ``8 (k // 8) + F32_K_ORDER[k % 8]`` of the stage."""
    base = np.concatenate([[0], np.cumsum([k * m for k, m in shapes])])
    total = int(base[-1])
    idx = np.full(nbytes // 4, 2 * total, np.int64)
    order = np.asarray(F32_K_ORDER)
    k = np.arange(F32_K)[None, :]
    kk = 8 * (k // 8) + order[k % 8]
    for sl in slabs:
        n_out = shapes[sl.layer][1]
        i = np.arange(sl.height)[:, None]
        if sl.dgrad:
            src = base[sl.layer] + (sl.row0 + i) * n_out + sl.col0 + kk
            real = (i < sl.rows) & (kk < sl.cols)
        else:
            src = base[sl.layer] + (sl.row0 + kk) * n_out + sl.col0 + i
            real = (kk < sl.rows) & (i < sl.cols)
        pos = i * F32_K + 4 * ((k // 4) ^ (i % 8)) + k % 4
        for part in (0, 1):
            dst = sl.at // 4 + part * sl.height * F32_K + pos
            idx[dst.ravel()] = np.where(real, src + part * total,
                                        2 * total).ravel()
    return idx


@functools.lru_cache(maxsize=32)
def _f32_image_index(k0: int, kd: int, kt: int, has_transient: bool,
                     backward: bool = False, ipe: bool = False) -> np.ndarray:
    """``f32_slab_index`` of the f32 kernels' image of ``PackedNet.ws``."""
    slabs, nbytes = f32_image_plan(k0, kd, kt, has_transient, backward, ipe)
    return f32_slab_index(_packed_shapes(k0, kd, kt, has_transient, ipe),
                          slabs, nbytes)


@functools.lru_cache(maxsize=8)
def _f32_sigma_index(k0: int) -> np.ndarray:
    """``f32_slab_index`` of the sigma-only kernel's image of the first
    ``SIGMA_LAYERS`` of ``PackedNet.ws``."""
    slabs, nbytes = f32_sigma_plan(k0)
    return f32_slab_index(_sigma_shapes(k0), slabs, nbytes)


@functools.lru_cache(maxsize=32)
def _image_index(k0: int, kd: int, kt: int, has_transient: bool,
                 backward: bool = False) -> np.ndarray:
    """``slab_index`` of the fused kernels' image of ``PackedNet.ws``."""
    slabs, nbytes = (bwd_image_plan if backward else image_plan)(
        k0, kd, kt, has_transient)
    return slab_index(_packed_shapes(k0, kd, kt, has_transient), slabs,
                      nbytes)


_IMAGE_INDEX_ON = {}


def gather_image(ws, key, index) -> torch.Tensor:
    """The tensors ``ws`` (bf16 weights, or the f32 weights' tf32 hi and lo
    parts) laid out as an image: a flat tensor on their device through the
    numpy index ``index()`` into their concatenation (``slab_index``,
    ``f32_slab_index``), whose device copy is cached under ``key``.  Two
    device launches: one cat, one gather."""
    dev = ws[0].device
    idx = _IMAGE_INDEX_ON.get(key + (dev,))
    if idx is None:
        idx = torch.from_numpy(index()).to(dev)
        _IMAGE_INDEX_ON[key + (dev,)] = idx
    flat = torch.cat([w.reshape(-1) for w in ws] + [ws[0].new_zeros(1)])
    return flat.index_select(0, idx)


def weight_image(net: PackedNet, has_transient: bool,
                 backward: bool = False) -> torch.Tensor:
    """``net.ws`` (bf16) laid out as the bf16 forward kernel (or, with
    ``backward``, the backward kernel) streams them: a flat bf16 tensor
    whose elements are the weights, each at least once, and zero padding
    (``_image_index``; the forward's image is a permutation)."""
    key = (net.k0, net.kd, net.kt, bool(has_transient), bool(backward))
    return gather_image(net.ws, key, lambda: _image_index(*key))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 fraction bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: on the bits, add half of the
    13 dropped bits' unit to the magnitude and clear them."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = ``tf32_round(x)``, lo = ``tf32_round(x - hi)``, the
    f32 kernels' split of every operand (tf::split); x - hi - lo is within
    2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def f32_weight_image(net: PackedNet, has_transient: bool,
                     backward: bool = False, ipe: bool = False
                     ) -> torch.Tensor:
    """``net.ws`` (f32) laid out as the f32 forward kernel (or, with
    ``backward``, the backward kernel) streams them: each weight split into
    its tf32 hi and lo parts (``tf32_split``), gathered through the cached
    ``_f32_image_index``: a flat f32 tensor of hi and lo parts and zero
    padding.  Device launches: one cat, the split, one cat, one gather.
    ``ipe``: the IPE kernels' image of the IPE layout."""
    key = ("f32", net.k0, net.kd, net.kt, bool(has_transient), bool(backward),
           bool(ipe))
    hi, lo = tf32_split(torch.cat([w.reshape(-1) for w in net.ws]))
    return gather_image([hi, lo], key, lambda: _f32_image_index(*key[1:]))


def f32_sigma_image(net: PackedNet) -> torch.Tensor:
    """``f32_weight_image`` of the sigma-only kernel, from the first
    ``SIGMA_LAYERS`` of ``net.ws`` (the trunk and fs2)."""
    key = ("f32-sigma", net.k0)
    hi, lo = tf32_split(torch.cat([w.reshape(-1)
                                   for w in net.ws[:SIGMA_LAYERS]]))
    return gather_image([hi, lo], key, lambda: _f32_sigma_index(net.k0))


def bwd_tile_counts(k0: int, kd: int, kt: int, has_transient: bool):
    """Operand tiles (64 points x 64 columns, 8 KB in bf16) the bf16
    backward moves per 64 points: (saved by the fused kernel, read by the
    wgrad kernel).  Saved: every layer's input activations and cotangent,
    each once (the heads and fs2's sigma block share one cotangent tile).
    Read: a wgrad block takes two 64-row chunks of a layer's input and all
    of its cotangent, so the cotangent is read once per two chunks
    (csrc/fused_mlp_bwd.cu:make_wplan)."""
    def t(cols):
        return -(-cols // SLAB_K)

    # (input chunks, cotangent tiles) per packed layer
    layers = [(t(k0), 4)] + [(4, 4)] * 3 + [(t(k0) + 4, 4)] + [(4, 4)] * 3 \
        + [(4, 5), (4 + t(kd), 2), (2, 1)]
    saved = t(k0) + 8 * 4 + 4 + t(kd) + 2 + 1 + 9 * 4 + 2
    if has_transient:
        layers += [(4 + t(kt), 2)] + [(2, 2)] * 3 + [(2, 1)]
        saved += t(kt) + 4 * 2 + 4 * 2
    read = sum(a + -(-a // 2) * g for a, g in layers)
    return saved, read


def fwd_tiles(n: int, rows: int = TILE_ROWS) -> int:
    """Tiles of ``rows`` points (TILE_ROWS for bf16, F32_ROWS for f32) in
    a launch of ``n`` points; rows past ``n`` in the last one are computed
    as zeros and not stored."""
    return -(-n // rows)


def fwd_grid(n: int, n_sm: int, rows: int = TILE_ROWS) -> int:
    """Persistent blocks of a forward or backward launch: one per SM,
    block b takes tiles b, b + grid, ...; no more blocks than tiles."""
    return min(fwd_tiles(n, rows), n_sm)


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------

def _pe_arg(inp, R, src, width):
    """E = sum_c inp[:, src+c] * R[c], columns [0, width) (exact: one
    non-zero term per column)."""
    E = inp[:, src:src + 1] * R[0:1, :width]
    for c in (1, 2):
        E = E + inp[:, src + c:src + c + 1] * R[c:c + 1, :width]
    return E


def _encode(inp, R, ph, trg, scale, src, width):
    """Columns [0, width) of where(trg, sin_cw(E, ph), E) * scale."""
    ph, trg, scale = (x[:, :width] for x in (ph, trg, scale))
    E = _pe_arg(inp, R, src, width)
    return torch.where(trg > 0, sin_cw(E, ph), E) * scale


def _consts(n_freq_xyz, n_freq_dir, a_dim, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in _encoder_consts(n_freq_xyz, n_freq_dir, a_dim).items()}


def _layers(net: PackedNet, dtype, matmul):
    """(mm, hidden) of the packed layers: ``mm(a, i)``, the f32 product
    with layer i's weight (by ``matmul``); ``hidden(a, i)``, that product
    rounded to ``dtype``, plus the rounded bias, ReLU."""
    f32 = torch.float32

    def mm(a, i):                       # f32 accumulation of exact products
        return matmul(a.to(f32), net.ws[i].to(f32))

    def hidden(a, i):
        y = mm(a, i).to(dtype)
        return torch.relu(y + net.bs[i].to(dtype))
    return mm, hidden


def _trunk(pe, hidden, skip=SKIP):
    """Layers 0..7 over the encoded positions, the skip at ``skip``
    (packed [pe | h]): (each layer's input, each layer's output)."""
    ins, outs = [], []
    h = pe
    for i in range(8):
        ins.append(torch.cat([pe, h], -1) if i == skip else h)
        h = hidden(ins[-1], i)
        outs.append(h)
    return ins, outs


def _forward(inp, net: PackedNet, sx, sd, c, *, n_freq_dir, a_dim, t_dim,
             has_transient, dtype, matmul=torch.matmul, ipe_freqs=0):
    """The fused forward in eager torch, keeping every activation the
    backward needs.  Returns (out, acts).  ``matmul``: the layer product
    (exact products, f32 sums; ``f32_ties.tf32x3_mm`` models the f32
    kernels').  ``ipe_freqs`` > 0: the IPE layout, its encoding at that
    many frequencies (the kernels' tf::encode_ipe: ``integrated_pos_enc``
    with the Cody-Waite sine) and the skip at layer 5."""
    bs = net.bs
    mm, hidden = _layers(net, dtype, matmul)
    if ipe_freqs:
        enc = integrated_pos_enc(inp[:, 0:3], inp[:, 6:9], ipe_freqs,
                                 fast=True)
        pe = torch.nn.functional.pad(
            enc, (0, net.k0 - enc.shape[1])).to(dtype)
    else:
        pe = _encode(inp, c["PxR"], c["phx"], c["trgx"], sx, 0,
                     net.k0).to(dtype)
    ins, outs = _trunk(pe, hidden, IPE_SKIP if ipe_freqs else SKIP)
    h = outs[-1]
    fs2 = mm(h, 8) + bs[8]
    xyz_final = fs2[:, :W_TRUNK].to(dtype)

    d_tail = _encode(inp, c["PdR"], c["phd"], c["trgd"], sd, 3, net.kd)
    if a_dim:
        ma = c["ma"][:, :net.kd]
        d_pe = 3 + 6 * n_freq_dir
        a_cols = torch.nn.functional.pad(
            inp[:, 6:6 + a_dim], (d_pe, net.kd - d_pe - a_dim))
        d_tail = torch.where(ma > 0, a_cols, d_tail)
    din = torch.cat([xyz_final, d_tail.to(dtype)], -1)
    hd = hidden(din, 9)
    out = (mm(hd, 10) + bs[10]) + fs2[:, W_TRUNK:]
    acts = {"ins": ins, "outs": outs, "din": din, "hd": hd}
    if has_transient:
        t0 = 6 + a_dim
        t = torch.nn.functional.pad(inp[:, t0:t0 + t_dim],
                                    (0, net.kt - t_dim)).to(dtype)
        tacts = [torch.cat([xyz_final, t], -1)]
        for i in (11, 12, 13, 14):
            tacts.append(hidden(tacts[-1], i))
        out = out + (mm(tacts[-1], 15) + bs[15])
        acts["tacts"] = tacts
    return out, acts


def fused_mlp_reference(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                        sd: torch.Tensor, *, n_freq_xyz: int, n_freq_dir: int,
                        a_dim: int, t_dim: int, has_transient: bool,
                        dtype, ipe: bool = False) -> torch.Tensor:
    """The kernel's function in eager torch: packed (N, 128) f32 input ->
    (N, 16) f32 pre-activations, with the kernel's rounding points.
    ``ipe``: the IPE kernel's (``n_freq_xyz`` IPE frequencies)."""
    c = _consts(n_freq_xyz, n_freq_dir, a_dim, inp.device)
    return _forward(inp, net, sx, sd, c, n_freq_dir=n_freq_dir, a_dim=a_dim,
                    t_dim=t_dim, has_transient=has_transient, dtype=dtype,
                    ipe_freqs=n_freq_xyz if ipe else 0)[0]


def fused_sigma_reference(xyz: torch.Tensor, net: PackedNet,
                          sx: torch.Tensor, *,
                          n_freq_xyz: int) -> torch.Tensor:
    """The sigma-only kernel's function in eager torch: (N, 3) f32
    positions -> (N,) f32 static-sigma pre-activations, through PE(xyz)
    times the scale row ``sx``, the trunk (``fused_mlp_reference``'s at
    f32) and fs2's 16-column sigma block plus its f32 bias: column
    ``COL_S_SIGMA`` of ``fused_mlp_reference``'s output at f32."""
    c = _consts(n_freq_xyz, 0, 0, xyz.device)
    _, hidden = _layers(net, torch.float32, torch.matmul)
    pe = _encode(xyz, c["PxR"], c["phx"], c["trgx"], sx, 0, net.k0)
    _, outs = _trunk(pe, hidden)
    block = slice(W_TRUNK, W_TRUNK + OUT_W)
    return (torch.matmul(outs[-1], net.ws[8][:, block])
            + net.bs[8][block])[:, COL_S_SIGMA]


def fused_mlp_bwd_reference(inp: torch.Tensor, net: PackedNet,
                            sx: torch.Tensor, sd: torch.Tensor,
                            g: torch.Tensor, *, n_freq_xyz: int,
                            n_freq_dir: int, a_dim: int, t_dim: int,
                            has_transient: bool, dtype, ipe: bool = False):
    """The backward kernel's function in eager torch, step for step with
    ``nerf_fl_tpu/ops/fused_mlp.py:_bwd_kernel`` and its rounding points:
    recompute the forward, then backprop the (N, 16) f32 cotangent ``g`` of
    the pre-activations.  Inter-layer cotangents are rounded to ``dtype``;
    weight and bias grads are f32 sums of exact products.  Returns
    (dws, dbs, d_inp): padded (K, N_out) and (N_out,) f32 grads per packed
    layer, and the (N, 128) f32 cotangent of the packed input.  (Not
    autograd of ``fused_mlp_reference``: that would keep f32 cotangents.)
    ``ipe``: the IPE backward's, whose d_inp is None (it takes no input
    cotangent)."""
    return _backward(inp, net, sx, sd, g, n_freq_xyz=n_freq_xyz,
                     n_freq_dir=n_freq_dir, a_dim=a_dim, t_dim=t_dim,
                     has_transient=has_transient, dtype=dtype, ipe=ipe)


def _backward(inp, net: PackedNet, sx, sd, g, *, n_freq_xyz, n_freq_dir,
              a_dim, t_dim, has_transient, dtype, matmul=torch.matmul,
              ipe=False):
    """``fused_mlp_bwd_reference`` with its layer products (the forward's,
    the dgrad's and the wgrad's) taken by ``matmul``."""
    f32 = torch.float32
    c = _consts(n_freq_xyz, n_freq_dir, a_dim, inp.device)
    _, acts = _forward(inp, net, sx, sd, c, n_freq_dir=n_freq_dir,
                       a_dim=a_dim, t_dim=t_dim, has_transient=has_transient,
                       dtype=dtype, matmul=matmul,
                       ipe_freqs=n_freq_xyz if ipe else 0)
    skip = IPE_SKIP if ipe else SKIP
    ws = net.ws
    dws: List[torch.Tensor] = [None] * len(ws)
    dbs: List[torch.Tensor] = [None] * len(ws)

    def dense_bwd(a_in, act_out, g, i):
        """dW += a_in^T g, db += sum g (f32); returns g W^T rounded."""
        if act_out is not None:              # ReLU mask, compared in f32
            g = torch.where(act_out.to(f32) > 0, g, torch.zeros_like(g))
        gc = g.to(dtype).to(f32)
        dws[i] = matmul(a_in.to(f32).t(), gc)
        dbs[i] = gc.sum(0)
        return matmul(gc, ws[i].to(f32).t()).to(dtype)

    def add(a, b):                           # one rounding, as a bf16 add
        return (a.to(f32) + b.to(f32)).to(dtype)

    gd = g.to(dtype)                         # the heads' cotangent
    d_hd = dense_bwd(acts["hd"], None, gd, 10)
    d_din = dense_bwd(acts["din"], acts["hd"], d_hd, 9)
    d_xf, d_dtail = d_din[:, :W_TRUNK], d_din[:, W_TRUNK:]
    if has_transient:
        tacts = acts["tacts"]
        gt = dense_bwd(tacts[4], None, gd, 15)
        for k in (2, 1, 0):
            gt = dense_bwd(tacts[k + 1], tacts[k + 2], gt, 12 + k)
        d_tin = dense_bwd(tacts[0], tacts[1], gt, 11)
        d_xf = add(d_xf, d_tin[:, :W_TRUNK])
        d_ttail = d_tin[:, W_TRUNK:]
    # fs2: [d_xyz_final | g]; only the sigma column meets non-zero weights
    ins, outs = acts["ins"], acts["outs"]
    gg = dense_bwd(outs[7], None, torch.cat([d_xf, gd], -1), 8)
    for i in range(7, -1, -1):
        gg = dense_bwd(ins[i], outs[i], gg, i)
        if i == skip:
            d_pe_skip, gg = gg[:, :net.k0], gg[:, net.k0:]
    if ipe:
        return dws, dbs, None
    d_pe = add(gg, d_pe_skip)

    # PE chain rule: dE = where(trig, cos, 1) * scale * d_pe, summed per
    # input component over its columns (the R rows hold 1 or 2^k)
    def d_enc(R, ph, trg, scale, src, width, d, mask=None):
        ph, trg, scale = (x[:, :width] for x in (ph, trg, scale))
        E = _pe_arg(inp, R, src, width)
        dE = torch.where(trg > 0, sin_cw(E, ph + 0.25),
                         torch.ones_like(E)) * scale
        if mask is not None:
            dE = torch.where(mask > 0, torch.zeros_like(dE), dE)
        dE = dE * d.to(f32)
        return [(dE * R[k:k + 1, :width]).sum(1) for k in range(3)]

    d_inp = torch.zeros(inp.shape, dtype=f32, device=inp.device)
    d_inp[:, 0:3] = torch.stack(d_enc(c["PxR"], c["phx"], c["trgx"], sx, 0,
                                      net.k0, d_pe), 1)
    d_inp[:, 3:6] = torch.stack(d_enc(c["PdR"], c["phd"], c["trgd"], sd, 3,
                                      net.kd, d_dtail,
                                      c["ma"][:, :net.kd]), 1)
    if a_dim:
        d_pe_dim = 3 + 6 * n_freq_dir
        d_inp[:, 6:6 + a_dim] = d_dtail[:, d_pe_dim:d_pe_dim + a_dim].to(f32)
    if has_transient:
        d_inp[:, 6 + a_dim:6 + a_dim + t_dim] = d_ttail[:, :t_dim].to(f32)
    return dws, dbs, d_inp


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

def kernel_block_info(dtype=torch.bfloat16):
    """The ``dtype`` kernels' blocks as their sources define them (the
    card's build): points a block, the forward's threads, dynamic
    shared-memory bytes, ring depth, the fused backward's threads and
    consumer warpgroups, and the wgrad's split of the points: bf16
    ``splits`` (a fixed count), f32 ``split_rows`` (64-point row blocks a
    split)."""
    f, b = (ctypes.c_int * 8)(), (ctypes.c_int * 12)()
    _lib().nerf_fused_mlp_fwd_info(f)
    _lib_bwd().nerf_fused_mlp_bwd_info(b)
    i, j = (0, 0) if dtype == torch.bfloat16 else (4, 5)
    return {"rows": f[i], "threads": f[i + 1], "fwd_smem": f[i + 2],
            "stages": f[i + 3], "bwd_threads": b[j + 1],
            "bwd_consumers": b[10 + j // 5], "bwd_smem": b[j + 2],
            "wgrad_smem": b[j + 3],
            ("splits" if j == 0 else "split_rows"): b[j + 4]}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_fwd")
    lib.nerf_fused_mlp_fwd.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p),
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p])
    lib.nerf_fused_mlp_fwd.restype = ctypes.c_int
    lib.nerf_fused_sigma_fwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p])
    lib.nerf_fused_sigma_fwd.restype = ctypes.c_int
    lib.nerf_fused_ipe_fwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.nerf_fused_ipe_fwd.restype = ctypes.c_int
    lib.nerf_fused_mlp_fwd_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nerf_fused_mlp_fwd_info.restype = None
    return lib


@functools.lru_cache(maxsize=1)
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_bwd")
    lib.nerf_fused_mlp_bwd_sizes.argtypes = (
        [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)])
    lib.nerf_fused_mlp_bwd_sizes.restype = ctypes.c_int
    lib.nerf_fused_mlp_bwd.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 5)
    lib.nerf_fused_mlp_bwd.restype = ctypes.c_int
    lib.nerf_fused_ipe_bwd_sizes.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)])
    lib.nerf_fused_ipe_bwd_sizes.restype = ctypes.c_int
    lib.nerf_fused_ipe_bwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6)
    lib.nerf_fused_ipe_bwd.restype = ctypes.c_int
    lib.nerf_fused_mlp_bwd_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nerf_fused_mlp_bwd_info.restype = None
    return lib


def _packed_shapes(k0: int, kd: int, kt: int, has_transient: bool,
                   ipe: bool = False):
    """(K, N_out) of every packed layer, in ``pack_weights`` order (with
    ``ipe``, the IPE layout's: the skip at layer 5)."""
    skip = IPE_SKIP if ipe else SKIP
    shapes = [(k0, W_TRUNK)] \
        + [(k0 + W_TRUNK if i == skip else W_TRUNK, W_TRUNK)
           for i in range(1, 8)] \
        + [(W_TRUNK, W_TRUNK + OUT_W), (W_TRUNK + kd, W_HALF),
           (W_HALF, OUT_W)]
    if has_transient:
        shapes += [(W_TRUNK + kt, W_HALF)] + [(W_HALF, W_HALF)] * 3 \
            + [(W_HALF, OUT_W)]
    return shapes


def _sigma_shapes(k0: int):
    """The sigma-only kernel's packed (K, N_out) shapes: the trunk's and
    fs2's."""
    return _packed_shapes(k0, 0, 0, False)[:SIGMA_LAYERS]


def _check_operands(name, inp, net, sx, sd, has_transient, dtype,
                    ipe=False):
    """Raise unless the operands are what the kernels take; returns the
    packed layer shapes."""
    dev = inp.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported compute dtype {dtype}")
    if ipe and (dtype != torch.float32 or has_transient):
        raise ValueError(f"{name}: the IPE kernels are f32 and have no "
                         "transient branch")
    if inp.dtype != torch.float32 or inp.dim() != 2 \
            or inp.shape[1] != LANES or not inp.is_contiguous():
        raise ValueError("inp must be a contiguous (N, 128) float32 tensor")
    shapes = _packed_shapes(net.k0, net.kd, net.kt, has_transient, ipe)
    if len(net.ws) != len(shapes) or len(net.bs) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed layers")
    _check_layers(net, shapes, dtype, dev, sx, sd)
    if inp.shape[0] >= 2 ** 31 // LANES:
        raise ValueError(f"too many points for one launch: {inp.shape[0]}")
    return shapes


def _check_layers(net, shapes, dtype, dev, *rows):
    """Raise unless the first ``len(shapes)`` packed layers have those
    (K, N_out) shapes in ``dtype`` (biases f32), contiguous on ``dev``, and
    each scale row is a contiguous (1, 128) f32 row there."""
    for w, b, s in zip(net.ws, net.bs, shapes):
        if tuple(w.shape) != s or w.dtype != dtype or w.device != dev \
                or not w.is_contiguous():
            raise ValueError(f"packed weight {tuple(w.shape)} {w.dtype} does "
                             f"not match {s} {dtype} on {dev}")
        if tuple(b.shape) != (s[1],) or b.dtype != torch.float32 \
                or b.device != dev or not b.is_contiguous():
            raise ValueError(f"packed bias {tuple(b.shape)} does not match "
                             f"({s[1]},) float32 on {dev}")
    for r in rows:
        if tuple(r.shape) != (1, LANES) or r.dtype != torch.float32 \
                or r.device != dev or not r.is_contiguous():
            raise ValueError("scale rows must be contiguous (1, 128) float32")


def _ptrs(ts):
    return (ctypes.c_void_p * N_LAYERS)(*[t.data_ptr() for t in ts])


def _image_and_grid(net: PackedNet, has_transient: bool, dtype,
                    backward: bool, n: int, dev, ipe: bool = False):
    """(image, its bytes, persistent blocks) of one launch: the bf16
    kernels' ``weight_image`` and 128-point tiles, the f32 kernels'
    ``f32_weight_image`` (the IPE kernels' with ``ipe``) and 64-point
    tiles."""
    if dtype == torch.bfloat16:
        image, rows = weight_image(net, has_transient, backward), TILE_ROWS
    else:
        image = f32_weight_image(net, has_transient, backward, ipe)
        rows = F32_ROWS
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return image, image.numel() * image.element_size(), \
        fwd_grid(n, n_sm, rows)


_RUNS: Dict[torch.device, torch.Tensor] = {}


def _runs(dev: torch.device) -> torch.Tensor:
    """The card's (5,) int64 counter of fused forward / backward /
    sigma-only / IPE forward / IPE backward kernel runs, to which each
    kernel adds one from its first thread (an IPE kernel to its slot and to
    the fused pair's).  A
    CUDA graph bakes its address in, so it lives as long as the process; it
    is made outside any capture (a capture would record, and each replay
    repeat, its zeroing)."""
    runs = _RUNS.get(dev)
    if runs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the fused kernels' run counter must exist "
                               "before a CUDA graph captures them: launch "
                               "once outside the capture first")
        runs = _RUNS[dev] = torch.zeros(5, dtype=torch.int64, device=dev)
    return runs


def _counted(device):
    """The run counter of ``device`` (None: the current CUDA device) read
    back after a synchronize, or zeros where no kernel has run."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _RUNS:
        return [0] * 5
    torch.cuda.synchronize(dev)
    return _RUNS[dev].tolist()


def kernel_runs(device=None):
    """(forward, backward): the fused kernels that have run on ``device``
    (None: the current CUDA device) in this process, counted on the card
    by the kernels themselves.  Unlike the wrappers' ``launches``, which
    count the host calls that launch (or, under a capture, record) a
    kernel, it counts each run of a CUDA graph's replay.  The sigma-only
    kernel's runs are not among them (``sigma_runs``); the IPE kernels'
    are, and ``ipe_runs`` counts them apart too.  Synchronizes the
    device."""
    fwd, bwd = _counted(device)[:2]
    return fwd, bwd


def sigma_runs(device=None) -> int:
    """The sigma-only kernel's runs on ``device`` in this process, counted
    on the card by the kernel itself, as ``kernel_runs`` counts the fused
    pair's.  Synchronizes the device."""
    return _counted(device)[2]


def ipe_runs(device=None):
    """(forward, backward): the IPE kernels' runs on ``device`` in this
    process, counted on the card by the kernels themselves (graph replays
    included); ``kernel_runs`` counts them too.  Synchronizes the
    device."""
    c = _counted(device)
    return c[3], c[4]


def fused_mlp_fwd_cuda(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                       sd: torch.Tensor, *, n_freq_xyz: int, n_freq_dir: int,
                       a_dim: int, t_dim: int, has_transient: bool,
                       dtype, ipe: bool = False) -> torch.Tensor:
    """Launch csrc/fused_mlp_fwd.cu on the current stream: packed (N, 128)
    f32 input -> (N, 16) f32 pre-activations.  bf16 runs the wgmma kernel
    on ``weight_image(net)``, f32 the 3xTF32 wgmma kernel on
    ``f32_weight_image(net)``, each with ``fwd_grid`` persistent blocks.
    Counts its launches in ``fused_mlp_fwd_cuda.launches``; the kernel
    counts its runs on the card (``kernel_runs``).  ``ipe``: the IPE kernel
    (f32, no appearance or transient) on the IPE layout's image, which
    counts its runs in ``ipe_runs`` as well."""
    _check_operands("fused_mlp_fwd_cuda", inp, net, sx, sd, has_transient,
                    dtype, ipe)
    dev, n = inp.device, inp.shape[0]
    runs = _runs(dev)
    out = torch.empty((n, OUT_W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    image, image_bytes, grid = _image_and_grid(net, has_transient, dtype,
                                               False, n, dev, ipe)
    with torch.cuda.device(dev):
        if ipe:
            err = _lib().nerf_fused_ipe_fwd(
                inp.data_ptr(), out.data_ptr(), n, _ptrs(net.bs),
                image.data_ptr(), image_bytes, grid, sd.data_ptr(),
                n_freq_xyz, n_freq_dir, runs.data_ptr(),
                runs.data_ptr() + 24, stream)
        else:
            err = _lib().nerf_fused_mlp_fwd(
                _DTYPE_CODE[dtype], inp.data_ptr(), out.data_ptr(), n,
                _ptrs(net.bs), image.data_ptr(), image_bytes, grid,
                sx.data_ptr(), sd.data_ptr(),
                n_freq_xyz, n_freq_dir, a_dim, t_dim, int(has_transient),
                runs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed: CUDA error "
                           f"{err}")
    fused_mlp_fwd_cuda.launches += 1
    return out


fused_mlp_fwd_cuda.launches = 0


def fused_sigma_cuda(xyz: torch.Tensor, net: PackedNet, sx: torch.Tensor, *,
                     n_freq_xyz: int) -> torch.Tensor:
    """Launch csrc/fused_mlp_fwd.cu's sigma-only kernel on the current
    stream: (N, 3) f32 positions -> (N,) f32 static-sigma pre-activations,
    the f32 kernel's column ``COL_S_SIGMA`` for the same points and
    weights.  ``net``: an f32 ``PackedNet`` (its trunk and fs2 are read:
    ``pack_sigma_weights`` packs no more); the kernel streams
    ``f32_sigma_image(net)`` with ``fwd_grid`` persistent blocks of 64
    points.  Counts its launches in ``fused_sigma_cuda.launches``; the
    kernel counts its runs on the card (``sigma_runs``)."""
    dev, n = xyz.device, xyz.shape[0]
    if dev.type != "cuda":
        raise ValueError("fused_sigma_cuda takes CUDA tensors")
    if xyz.dtype != torch.float32 or xyz.dim() != 2 or xyz.shape[1] != 3 \
            or not xyz.is_contiguous():
        raise ValueError("xyz must be a contiguous (N, 3) float32 tensor")
    if len(net.ws) < SIGMA_LAYERS or len(net.bs) < SIGMA_LAYERS:
        raise ValueError(f"expected at least {SIGMA_LAYERS} packed layers")
    _check_layers(net, _sigma_shapes(net.k0), torch.float32, dev, sx)
    if n >= 2 ** 31:
        raise ValueError(f"too many points for one launch: {n}")
    runs = _runs(dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    image = f32_sigma_image(net)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().nerf_fused_sigma_fwd(
            xyz.data_ptr(), out.data_ptr(), n, _ptrs(net.bs[:SIGMA_LAYERS]),
            image.data_ptr(), image.numel() * image.element_size(),
            fwd_grid(n, n_sm, F32_ROWS), sx.data_ptr(), n_freq_xyz,
            runs.data_ptr() + 16, stream)
    if err != 0:
        raise RuntimeError(f"fused sigma kernel launch failed: CUDA error "
                           f"{err}")
    fused_sigma_cuda.launches += 1
    return out


fused_sigma_cuda.launches = 0


def fused_mlp_bwd_cuda(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                       sd: torch.Tensor, g: torch.Tensor, *, n_freq_xyz: int,
                       n_freq_dir: int, a_dim: int, t_dim: int,
                       has_transient: bool, dtype, ipe: bool = False):
    """Launch csrc/fused_mlp_bwd.cu on the current stream: the fused
    recompute + dgrad kernel on ``weight_image(net, backward=True)`` (bf16)
    or ``f32_weight_image(net, backward=True)`` (f32, 3xTF32) with
    ``fwd_grid`` persistent blocks, the split-K wgrad kernel over the
    operand tiles it saved, and the fixed-order reductions of dW and db.
    Same operands as ``fused_mlp_bwd_reference`` plus the (N, 16)
    f32 cotangent ``g``; returns (dws, dbs, d_inp) as it does.
    Deterministic: two launches on the same inputs give bitwise-equal
    results.  Counts its launches in ``fused_mlp_bwd_cuda.launches``; the
    fused kernel counts its runs on the card (``kernel_runs``).  ``ipe``:
    the IPE backward (its runs also in ``ipe_runs``), which returns None
    for d_inp."""
    shapes = _check_operands("fused_mlp_bwd_cuda", inp, net, sx, sd,
                             has_transient, dtype, ipe)
    dev, n = inp.device, inp.shape[0]
    runs = _runs(dev)
    if g.dtype != torch.float32 or tuple(g.shape) != (n, OUT_W) \
            or g.device != dev or not g.is_contiguous():
        raise ValueError("g must be a contiguous (N, 16) float32 tensor on "
                         "the input's device")
    lib = _lib_bwd()
    image, image_bytes, grid = _image_and_grid(net, has_transient, dtype,
                                               True, n, dev, ipe)
    sizes = (ctypes.c_longlong * 3)()
    if ipe:
        err = lib.nerf_fused_ipe_bwd_sizes(n, grid, n_freq_xyz, n_freq_dir,
                                           sizes)
    else:
        err = lib.nerf_fused_mlp_bwd_sizes(
            _DTYPE_CODE[dtype], n, grid, n_freq_xyz, n_freq_dir, a_dim,
            t_dim, int(has_transient), sizes)
    if err != 0:
        raise ValueError(f"fused_mlp_bwd: unsupported shapes (error {err})")
    scratch_bytes, partial_floats, grad_floats = (int(v) for v in sizes)
    if grad_floats != sum(k * m + m for k, m in shapes):
        raise RuntimeError("fused_mlp_bwd: packed layout disagrees with the "
                           "kernel's")
    # the kernels write d_inp's live columns only; the IPE kernels none
    d_inp = None if ipe else torch.zeros((n, LANES), dtype=torch.float32,
                                         device=dev)
    grads = torch.empty(grad_floats, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8,
                          device=dev)
    partial = torch.empty(max(partial_floats, 1), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if ipe:
            err = lib.nerf_fused_ipe_bwd(
                inp.data_ptr(), g.data_ptr(), n, _ptrs(net.bs),
                image.data_ptr(), image_bytes, grid, sd.data_ptr(),
                n_freq_xyz, n_freq_dir, scratch.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), runs.data_ptr() + 8,
                runs.data_ptr() + 32, stream)
        else:
            err = lib.nerf_fused_mlp_bwd(
                _DTYPE_CODE[dtype], inp.data_ptr(), g.data_ptr(),
                d_inp.data_ptr(), n, _ptrs(net.bs), image.data_ptr(),
                image_bytes, grid, sx.data_ptr(), sd.data_ptr(), n_freq_xyz,
                n_freq_dir, a_dim, t_dim, int(has_transient),
                scratch.data_ptr(), partial.data_ptr(), grads.data_ptr(),
                runs.data_ptr() + 8, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd kernel launch failed: CUDA error "
                           f"{err}")
    fused_mlp_bwd_cuda.launches += 1
    dws, dbs, at = [], [], 0
    for k, m in shapes:
        dws.append(grads[at:at + k * m].view(k, m))
        dbs.append(grads[at + k * m:at + k * m + m])
        at += k * m + m
    return dws, dbs, d_inp


fused_mlp_bwd_cuda.launches = 0


# ----------------------------------------------------------------------
# autograd and the public entry
# ----------------------------------------------------------------------

class _FusedField(torch.autograd.Function):
    """Fused PE + MLP with its hand-written backward, as JAX's custom_vjp
    (``nerf_fl_tpu/ops/fused_mlp.py:588-639``).  Inputs: a dict of static
    settings, the packed input, the scale rows, and the f32 (weight, bias)
    pairs of ``field_linears`` order.  The weights are packed to the
    compute dtype inside ``forward``, so their grads reach ``.grad`` in f32.
    CUDA tensors launch the kernels; CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, meta, inp, sx, sd, *params):
        net = _pack(params, meta["a_dim"], meta["has_transient"],
                    meta["dtype"], meta["n_freq_xyz"], meta["n_freq_dir"],
                    meta["t_dim"], meta["ipe"])
        run = fused_mlp_fwd_cuda if inp.is_cuda else fused_mlp_reference
        pre = run(inp, net, sx, sd, **meta)
        # conditioning widths for unpack_weight_grads, from the weights of
        # xyz.0, dir and transient.layers.0 (field_linears order)
        lw = params[0::2]
        ctx.meta, ctx.net = meta, net
        ctx.widths = (lw[0].shape[1], lw[10].shape[1] - W_TRUNK,
                      lw[12].shape[1] - W_TRUNK
                      if meta["has_transient"] else 0)
        ctx.save_for_backward(inp, sx, sd)
        return pre

    @staticmethod
    def backward(ctx, g):
        inp, sx, sd = ctx.saved_tensors
        run = fused_mlp_bwd_cuda if inp.is_cuda else fused_mlp_bwd_reference
        dws, dbs, d_inp = run(inp, ctx.net, sx, sd, g.contiguous(),
                              **ctx.meta)
        grads = unpack_weight_grads(dws, dbs, *ctx.widths,
                                    ctx.meta["has_transient"],
                                    ctx.meta["ipe"])
        # the BARF scale rows are schedule values, not parameters
        return (None, d_inp, None, None, *grads)


def fused_apply_nerf(model: NeRF, xyz, dirs, a_emb=None, t_emb=None, *,
                     output_transient: bool = False,
                     compute_dtype=torch.bfloat16,
                     n_freq_xyz: int = 10, n_freq_dir: int = 4,
                     barf_w_xyz=None, barf_w_dir=None
                     ) -> Dict[str, torch.Tensor]:
    """Fused PE + MLP in place of embed + models.mlp.apply_nerf,
    differentiable in the field's parameters and in every input.

    xyz, dirs: (N, 3) raw positions and per-point view directions (the PE
    happens in the kernel); a_emb (N, a_dim) or None; t_emb (N, t_dim),
    required when output_transient; barf_w_xyz / barf_w_dir: (N_freqs,)
    BARF annealing weights or None.  CUDA tensors launch the forward kernel
    (and the backward kernel under autograd); CPU tensors run the plain
    versions.  Returns the same named-head dict as apply_nerf.
    """
    if output_transient and t_emb is None:
        raise ValueError("output_transient needs t_emb")
    if not output_transient:
        t_emb = None
    inputs = [x for x in (xyz, dirs, a_emb, t_emb) if x is not None]
    dev = xyz.device
    for x in inputs:
        if x.device != dev:
            raise ValueError("fused_apply_nerf: inputs on different devices")
        if not x.is_floating_point() or x.dim() != 2 \
                or x.shape[0] != xyz.shape[0]:
            raise ValueError("fused_apply_nerf: inputs must be (N, C) float")
    if xyz.shape[1] != 3 or dirs.shape[1] != 3:
        raise ValueError("xyz and dirs must be (N, 3)")
    if model.xyz[0].weight.device != dev:
        raise ValueError("fused_apply_nerf: model and inputs on different "
                         "devices")
    a_dim = 0 if a_emb is None else a_emb.shape[-1]
    t_dim = 0 if t_emb is None else t_emb.shape[-1]
    inp = pack_inputs(xyz, dirs, a_emb, t_emb).contiguous()
    with torch.no_grad():
        sx, sd = default_scale_rows(n_freq_xyz, n_freq_dir, a_dim,
                                    barf_w_xyz, barf_w_dir, device=dev)
    meta = dict(n_freq_xyz=n_freq_xyz, n_freq_dir=n_freq_dir, a_dim=a_dim,
                t_dim=t_dim, has_transient=bool(output_transient),
                dtype=compute_dtype, ipe=False)
    params = [t for lin in field_linears(model, bool(output_transient))
              for t in (lin.weight, lin.bias)]
    pre = _FusedField.apply(meta, inp, sx.contiguous(), sd.contiguous(),
                            *params)
    return heads(pre, output_transient)


def fused_apply_mip(model: NeRF, inp: torch.Tensor, *, n_freq_ipe: int = 16,
                    n_freq_dir: int = 4) -> Dict[str, torch.Tensor]:
    """mip-NeRF's field over packed (N, 128) IPE rows (``pack_ipe_inputs``:
    each point's Gaussian and unit view direction) in f32, differentiable
    in the field's parameters (not in the rows): CUDA tensors launch the
    IPE kernels, CPU tensors run their plain versions.  ``model``: a
    ``NeRF`` of the IPE layout (``NeRFConfig.skips`` (5,), ``skip_order``
    "h_first", 6 ``n_freq_ipe`` inputs, no appearance or transient).
    Returns {"raw_rgb": (N, 3), "raw_sigma": (N,)}, the pre-activations:
    mip-NeRF's heads (``models.mlp.mip_heads``) come after."""
    if inp.dim() != 2 or inp.shape[1] != LANES or inp.dtype != torch.float32:
        raise ValueError("inp must be (N, 128) float32 IPE rows")
    if model.xyz[0].weight.device != inp.device:
        raise ValueError("fused_apply_mip: model and rows on different "
                         "devices")
    with torch.no_grad():
        sd = default_scale_rows(0, n_freq_dir, 0, device=inp.device)[1]
    meta = dict(n_freq_xyz=n_freq_ipe, n_freq_dir=n_freq_dir, a_dim=0,
                t_dim=0, has_transient=False, dtype=torch.float32, ipe=True)
    params = [t for lin in field_linears(model, False)
              for t in (lin.weight, lin.bias)]
    pre = _FusedField.apply(meta, inp.contiguous(), sd, sd.contiguous(),
                            *params)
    return {"raw_rgb": pre[:, COL_S_RGB:COL_S_RGB + 3],
            "raw_sigma": pre[:, COL_S_SIGMA]}


def grad_needed(model: NeRF, *xs: torch.Tensor) -> bool:
    """Whether autograd would record a pass of ``model`` over ``xs`` here:
    grad mode is on and an input or a parameter requires grad."""
    return torch.is_grad_enabled() and (
        any(x.requires_grad for x in xs)
        or any(p.requires_grad for p in model.parameters()))


def fused_sigma(model: NeRF, xyz: torch.Tensor, *, n_freq_xyz: int = 10,
                barf_w_xyz=None) -> Dict[str, torch.Tensor]:
    """The static sigma alone, in f32, of (N, 3) raw positions: PE(xyz)
    (with BARF's annealing weights ``barf_w_xyz``, (n_freq_xyz,) or None),
    the trunk and the sigma head, as ``apply_nerf(..., sigma_only=True)``
    computes them, in the f32 fused kernel's arithmetic.  CUDA tensors
    launch the sigma-only kernel (``fused_sigma_cuda``), CPU tensors run
    its plain version.  It has no backward: it raises where autograd would
    record the pass (``grad_needed``).  Returns {"static_sigma": (N,)}."""
    if grad_needed(model, xyz):
        raise ValueError("fused_sigma has no backward: run it under "
                         "torch.no_grad() or on tensors that need no grad")
    if xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError("xyz must be (N, 3)")
    dev = xyz.device
    if model.xyz[0].weight.device != dev:
        raise ValueError("fused_sigma: model and positions on different "
                         "devices")
    net = pack_sigma_weights(model, n_freq_xyz)
    sx = default_scale_rows(n_freq_xyz, 0, 0, barf_w_xyz, device=dev)[0]
    run = fused_sigma_cuda if xyz.is_cuda else fused_sigma_reference
    pre = run(xyz.to(torch.float32).contiguous(), net, sx.contiguous(),
              n_freq_xyz=n_freq_xyz)
    return {"static_sigma": softplus(pre)}


def heads(pre: torch.Tensor, output_transient: bool) -> Dict[str, torch.Tensor]:
    """Activations of the packed (N, 16) pre-activations: sigmoid on the rgb
    columns, softplus (= jax.nn.softplus) on sigma and beta."""
    out = {"static_rgb": torch.sigmoid(pre[:, COL_S_RGB:COL_S_RGB + 3]),
           "static_sigma": softplus(pre[:, COL_S_SIGMA])}
    if output_transient:
        out["transient_rgb"] = torch.sigmoid(pre[:, COL_T_RGB:COL_T_RGB + 3])
        out["transient_sigma"] = softplus(pre[:, COL_T_SIGMA])
        out["transient_beta"] = softplus(pre[:, COL_T_BETA])
    return out
