"""Fused positional encoding + NeRF-W MLP, forward and backward: the Hopper
kernels, their plain PyTorch versions and the autograd wrapper.

Counterpart of ``nerf_fl_tpu/ops/fused_mlp.py``.  The kernels are
``csrc/fused_mlp_fwd.cu`` and ``csrc/fused_mlp_bwd.cu``; this module packs
their operands, launches them, and keeps their plain versions
(``fused_mlp_reference``, ``fused_mlp_bwd_reference``), the same
arithmetic in eager torch with the same rounding points.  The entries:
``fused_apply_nerf``, differentiable through a ``torch.autograd.Function``
(kernels for CUDA tensors, the plain versions for CPU ones);
``fused_sigma``, the render's test-time coarse pass, the static sigma
alone in f32 through the sigma-only kernel, with no backward;
``fused_apply_mip``, mip-NeRF's field through the f32 pair's IPE
instances (the integrated positional encoding of each point's Gaussian in
place of PE(xyz), the skip after layer 4, no input cotangent).

A ``Layout`` says what a packed net is; ``pack_weights`` sets it on the
``PackedNet``, and a launch reads from it the packed shapes, the image,
the tile rows, the C entry point and the run-counter slots.
``layout_for`` alone says which configurations a kernel takes.

Layouts:
  * input, one packed (N, 128) f32 row per point:
    ``[xyz 0:3 | dir 3:6 | a 6:6+a_dim | t ...+t_dim | 0]`` (as the TPU
    kernel's); the IPE layout's ``[mean 0:3 | dir 3:6 | var 6:9 | 0]``
    (``pack_ipe_inputs``);
  * output, (N, 16) f32 pre-activations: cols 0-2 static rgb, 3 static
    sigma, 4-6 transient rgb, 7 transient sigma, 8 beta, the rest zero;
  * weights, (K, N_out) row-major in the compute dtype, each K and N_out
    padded with zeros only to the next multiple of 16 (the tensor-core
    granule).  Biases f32.  See ``pack_weights``.  The kernels stream them
    from ``weight_image``: cut into slabs in the layout their tensor-core
    operand has in shared memory, in f32 split into tf32 hi and lo parts.
"""
from __future__ import annotations

import ctypes
import functools
from collections import namedtuple
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.encoding import integrated_pos_enc, sin_cw
from ..models.mlp import NeRF, NeRFConfig, softplus
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
F32_ROWS = 64       # points a block, which two consumer warpgroups share
F32_K = 32          # contraction values of a stage: one 128-byte tf32 row
F32_PIECE = 128     # output columns of a stage (the last of fs2's 272: 144)
# the order of each 8 contraction values in an f32 stage: the A fragment of
# a thread holds columns 2q and 2q + 1 of its group at indices q and q + 4
F32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

# the slots of the card's int64 run counter, in order: each kernel adds one
# to its own from its first thread (an IPE kernel to the fused pair's too)
RUN_SLOTS = ("fwd", "bwd", "sigma", "ipe_fwd", "ipe_bwd")

# the layout variants
FULL = "full"       # NeRF / NeRF-W: the fused pair, bf16 or f32
SIGMA = "sigma"     # the trunk and fs2 alone: the sigma-only kernel, f32
IPE = "ipe"         # mip-NeRF's field: the fused pair's IPE instances, f32
# a variant's C entry points (forward, backward, the backward's sizes),
# whether they take a leading compute-dtype code, their scale rows ("x":
# PE(xyz)'s, "d": the direction tail's), how many of (n_freq_xyz,
# n_freq_dir, a_dim, t_dim, has_transient) they take, and the run-counter
# slots the forward and the backward add one to
_Entry = namedtuple("_Entry", "fwd bwd sizes dtype_code rows n_nums "
                    "fwd_slots bwd_slots")
_ENTRY = {
    FULL: _Entry("nerf_fused_mlp_fwd", "nerf_fused_mlp_bwd",
                 "nerf_fused_mlp_bwd_sizes", True, "xd", 5, ("fwd",),
                 ("bwd",)),
    SIGMA: _Entry("nerf_fused_sigma_fwd", None, None, False, "x", 1,
                  ("sigma",), ()),
    IPE: _Entry("nerf_fused_ipe_fwd", "nerf_fused_ipe_bwd",
                "nerf_fused_ipe_bwd_sizes", False, "d", 2,
                ("fwd", "ipe_fwd"), ("bwd", "ipe_bwd")),
}


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@dataclass(frozen=True)
class Layout:
    """What a packed net is, and so which kernel, image, grid and run
    counter a launch of it takes.  ``variant``: ``FULL``, NeRF / NeRF-W's
    field (the skip at layer 4: [PE(xyz) | h]); ``SIGMA``, its trunk and
    fs2 alone; ``IPE``, mip-NeRF's field (layer 5 takes [h | enc], packed
    [enc | h]; no input cotangent).  ``dtype``: bf16 or f32 (``SIGMA`` and
    ``IPE``: f32).  ``n_freq_xyz`` / ``n_freq_dir``: the PE (IPE)
    frequencies; ``a_dim`` / ``t_dim``: the appearance / transient
    embedding widths, ``t_dim`` 0 meaning no transient branch."""
    dtype: torch.dtype
    n_freq_xyz: int = 10
    n_freq_dir: int = 4
    a_dim: int = 0
    t_dim: int = 0
    variant: str = FULL

    def __post_init__(self):
        if self.dtype not in _DTYPE_CODE:
            raise TypeError(f"unsupported compute dtype {self.dtype}")
        if self.variant not in _ENTRY:
            raise ValueError(f"layout variant {self.variant!r}")
        if self.variant != FULL and (self.dtype != torch.float32
                                     or self.a_dim or self.t_dim):
            raise ValueError("the sigma-only and IPE kernels are f32 and "
                             "take no appearance or transient embedding")
        if self.variant == SIGMA:
            object.__setattr__(self, "n_freq_dir", 0)

    # derived: the skip layer; whether the backward leaves out the input
    # cotangent; the widths of the encoded positions (PE(xyz) or IPE) and
    # of [PE(dir) | a], and k0 / kd / kt padded; a kernel block's points
    has_transient = property(lambda self: self.t_dim > 0)
    skip = property(lambda self: IPE_SKIP if self.variant == IPE else SKIP)
    no_d_inp = property(lambda self: self.variant == IPE)
    x_in = property(lambda self: 6 * self.n_freq_xyz
                    + (0 if self.variant == IPE else 3))
    d_in = property(lambda self: 3 + 6 * self.n_freq_dir + self.a_dim)
    k0 = property(lambda self: _round16(self.x_in))
    kd = property(lambda self: _round16(self.d_in))
    kt = property(lambda self: _round16(self.t_dim))
    rows = property(lambda self: TILE_ROWS if self.dtype == torch.bfloat16
                    else F32_ROWS)

    @functools.cached_property
    def shapes(self):
        """(K, N_out) of every packed layer, in ``pack_weights`` order."""
        shapes = [(self.k0, W_TRUNK)] \
            + [(self.k0 + W_TRUNK if i == self.skip else W_TRUNK, W_TRUNK)
               for i in range(1, 8)] + [(W_TRUNK, W_TRUNK + OUT_W)]
        if self.variant == SIGMA:
            return shapes
        shapes += [(W_TRUNK + self.kd, W_HALF), (W_HALF, OUT_W)]
        if self.has_transient:
            shapes += [(W_TRUNK + self.kt, W_HALF)] \
                + [(W_HALF, W_HALF)] * 3 + [(W_HALF, OUT_W)]
        return shapes

    @property
    def sigma(self) -> "Layout":
        """The sigma-only kernel's layout of this net's trunk and fs2: it
        reads f32 nets of the skip-4 layout, full or sigma-only."""
        if self.dtype != torch.float32 or self.variant == IPE:
            raise ValueError("the sigma-only kernel takes f32 nets of the "
                             "skip-4 layout")
        return Layout(torch.float32, self.n_freq_xyz, 0, variant=SIGMA)


def layout_for(mcfg: NeRFConfig, dtype, *, sigma_only: bool = False,
               needs_grad: bool = False,
               transient: bool = False) -> Optional[Layout]:
    """The layout in which a hand-written kernel runs a field of ``mcfg``
    in ``dtype`` (``sigma_only``: its static sigma alone; ``needs_grad``:
    under autograd; ``transient``: with its transient heads), or None where
    none takes that case and the plain ``apply_nerf`` runs it.  The kernels
    take depth 8 and width 256: nerf_pl's field (the skip at layer 4, its
    encodings, [PE(dir) | a] and t each at most 128 wide) in bf16 or f32,
    its sigma-only pass in f32 with no backward; mip-NeRF's (``skip_order``
    "hidden_first", the skip at layer 5, 1 to 20 IPE frequencies, no
    appearance or transient) in f32."""
    n_xyz, n_dir = mcfg.in_channels_xyz, mcfg.in_channels_dir
    if mcfg.D != 8 or mcfg.W != W_TRUNK or dtype not in _DTYPE_CODE \
            or n_dir > LANES or (n_dir - 3) % 6:
        return None
    if mcfg.skip_order == "hidden_first":
        if tuple(mcfg.skips) != (IPE_SKIP,) or dtype != torch.float32 \
                or sigma_only or n_xyz % 6 or not 6 <= n_xyz <= 120 \
                or mcfg.a_dim or mcfg.encode_transient:
            return None
        return Layout(torch.float32, n_xyz // 6, (n_dir - 3) // 6,
                      variant=IPE)
    if tuple(mcfg.skips) != (SKIP,) or n_xyz > LANES or (n_xyz - 3) % 6 \
            or n_dir + mcfg.a_dim > LANES or mcfg.in_channels_t > LANES:
        return None
    if sigma_only:
        if dtype != torch.float32 or needs_grad:
            return None
        return Layout(torch.float32, (n_xyz - 3) // 6, variant=SIGMA)
    return Layout(dtype, (n_xyz - 3) // 6, (n_dir - 3) // 6, mcfg.a_dim,
                  mcfg.in_channels_t if transient else 0)


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


class PackedNet(NamedTuple):
    ws: List[torch.Tensor]    # (K, N_out) compute dtype, contiguous
    bs: List[torch.Tensor]    # (N_out,) f32
    layout: Layout


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


def pack_weights(model: NeRF, layout: Layout) -> PackedNet:
    """Lay the nn.Linear (out, in) weights of ``model`` out as the kernels
    of ``layout`` read them: (in, out) row-major, zero-padded to
    16-multiples, head columns at their packed output positions.  Layer
    order: trunk 0..7, fs2 = [xyz_final | static sigma at col 256+3], dir,
    static rgb head, then with transient: transient 0..3, fused transient
    heads [rgb | sigma | beta] at cols 4..8; ``SIGMA`` the trunk and fs2
    alone; ``IPE``'s layer 5 mip-NeRF's [h | enc] as [enc padded | h]."""
    lins = field_linears(model, layout.has_transient)
    if layout.variant == SIGMA:
        lins = lins[:10]
    params = [t.detach() for lin in lins for t in (lin.weight, lin.bias)]
    return _pack(params, layout)


def _pack(params, lay: Layout) -> PackedNet:
    """``pack_weights`` from the flat [weight, bias, ...] list."""
    f32 = torch.float32
    dev = params[0].device
    k0, kd, kt = lay.k0, lay.kd, lay.kt
    lw = [w.to(f32).t() for w in params[0::2]]       # (in, out)
    lb = [b.to(f32) for b in params[1::2]]
    live = [lw[i].shape[0] for i in (0, 10, 12) if i < len(lw)]
    want = [lay.x_in, W_TRUNK + lay.d_in, W_TRUNK + lay.t_dim][:len(live)]
    if live != want:
        raise ValueError(f"the field's input widths {live} are not its "
                         f"layout's {want}")
    n_xyz_in = lay.x_in

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
        elif i == lay.skip and lay.variant == IPE:
            # mip-NeRF's [h | enc] rows as [enc | h]
            w = torch.cat([pad_rows(lw[i][W_TRUNK:], k0), lw[i][:W_TRUNK]])
        elif i == lay.skip:
            w = torch.cat([pad_rows(lw[i][:n_xyz_in], k0), lw[i][n_xyz_in:]])
        else:
            w = lw[i]
        ws.append(w)
        bs.append(lb[i])
    # fs2: (256, 256 + 16) = [xyz_final | static sigma at col 256 + 3]
    ws.append(cols(W_TRUNK, W_TRUNK + OUT_W,
                   [(0, lw[8]), (W_TRUNK + COL_S_SIGMA, lw[9])]))
    bs.append(bias_at(W_TRUNK + OUT_W,
                      [(0, lb[8]), (W_TRUNK + COL_S_SIGMA, lb[9])]))
    if lay.variant != SIGMA:
        # dir branch: (256 + kd, 128)
        ws.append(torch.cat([lw[10][:W_TRUNK],
                             pad_rows(lw[10][W_TRUNK:], kd)]))
        bs.append(lb[10])
        # static rgb head at output cols 0..2: (128, 16)
        ws.append(cols(W_HALF, OUT_W, [(COL_S_RGB, lw[11])]))
        bs.append(bias_at(OUT_W, [(COL_S_RGB, lb[11])]))
    if lay.has_transient:
        ws.append(torch.cat([lw[12][:W_TRUNK],
                             pad_rows(lw[12][W_TRUNK:], kt)]))
        bs.append(lb[12])
        ws += lw[13:16]
        bs += lb[13:16]
        heads_at = [(COL_T_RGB, 16), (COL_T_SIGMA, 17), (COL_T_BETA, 18)]
        ws.append(cols(W_HALF, OUT_W, [(c, lw[j]) for c, j in heads_at]))
        bs.append(bias_at(OUT_W, [(c, lb[j]) for c, j in heads_at]))
    ws = [w.to(lay.dtype).contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    return PackedNet(ws, bs, lay)


def unpack_weight_grads(dws: List[torch.Tensor], dbs: List[torch.Tensor],
                        layout: Layout) -> List[torch.Tensor]:
    """Padded (K, N_out) f32 weight-grad slabs and (N_out,) bias grads of a
    net of ``layout`` -> the flat [dweight (out, in), dbias, ...] list of
    ``field_linears`` order.  Every padded row and column is dropped: the
    kernels' heads compute all 16 output columns, only the live ones are
    parameters."""
    k0, n_xyz_in, skip = layout.k0, layout.x_in, layout.skip

    def lin(dw, db):
        return [dw.t().contiguous(), db.contiguous()]

    out = []
    for i in range(8):
        dw = dws[i]
        if i == 0:
            dw = dw[:n_xyz_in]
        elif i == skip and layout.variant == IPE:
            dw = torch.cat([dw[k0:], dw[:n_xyz_in]])
        elif i == skip:
            dw = torch.cat([dw[:n_xyz_in], dw[k0:]])
        out += lin(dw, dbs[i])
    c = W_TRUNK + COL_S_SIGMA
    out += lin(dws[8][:, :W_TRUNK], dbs[8][:W_TRUNK])
    out += lin(dws[8][:, c:c + 1], dbs[8][c:c + 1])
    out += lin(dws[9][:W_TRUNK + layout.d_in], dbs[9])
    out += lin(dws[10][:, COL_S_RGB:COL_S_RGB + 3],
               dbs[10][COL_S_RGB:COL_S_RGB + 3])
    if layout.has_transient:
        out += lin(dws[11][:W_TRUNK + layout.t_dim], dbs[11])
        for i in (12, 13, 14):
            out += lin(dws[i], dbs[i])
        for c, n in ((COL_T_RGB, 3), (COL_T_SIGMA, 1), (COL_T_BETA, 1)):
            out += lin(dws[15][:, c:c + n], dbs[15][c:c + n])
    return out


# ----------------------------------------------------------------------
# the kernels' weight images and grid
# ----------------------------------------------------------------------

class Slab(NamedTuple):
    """One weight slab of an image: ``height`` image rows of 128 bytes (64
    bf16 or 32 tf32 contraction values).  Forward slabs (``dgrad`` False) are W^T tiles: image
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


def _cut(slabs, at, layer, dgrad, row0, rows, col0, cols, height,
         f32=False):
    """Append the slabs of one segment; returns the next byte offset: one
    per 64 contraction values, ``height`` image rows of 128 bytes; with
    ``f32``, the f32 kernels' stages, one per 32 contraction values and
    output piece (``_pieces(height)``), the hi then the lo part.  A slab's
    ``rows`` / ``cols`` count the real ones of its own range."""
    kc, pieces = (F32_K, _pieces(height)) if f32 else (SLAB_K, [height])
    n = cols if dgrad else rows
    for c in range(0, n, kc):
        m = min(kc, n - c)
        p0 = 0
        for h in pieces:
            if dgrad:
                slabs.append(Slab(layer, True, row0 + p0,
                                  max(0, min(h, rows - p0)), col0 + c, m, h,
                                  at))
            else:
                slabs.append(Slab(layer, False, row0 + c, m, col0 + p0,
                                  max(0, min(h, cols - p0)), h, at))
            at += (2 if f32 else 1) * h * 128
            p0 += h
    return at


def _pieces(n: int):
    """The output pieces of an f32 product n wide (tf::plan_seg): 128
    columns each, the last taking up to 144."""
    if n <= F32_PIECE + OUT_W:
        return [n]
    k = n // F32_PIECE
    return [F32_PIECE] * (k - 1) + [n - F32_PIECE * (k - 1)]


def image_plan(lay: Layout, backward: bool = False):
    """The weight slabs (``_cut``) of ``lay``'s kernel (``backward``: its
    backward kernel) in the order it consumes them, and the image's bytes;
    csrc/fused_mlp_common.cuh's hop:: (bf16) and tf:: (f32) make_plan,
    make_bwd_plan and make_sigma_plan walk the same lists.  A layer whose
    input is two sources ([pe | h], [xyz_final | tail]) is cut per source,
    its last slab zero-padded.  The sigma-only kernel's: the trunk, then
    fs2's 16-column sigma block alone.  The backward's: the forward's
    recompute without fs2's sigma block and the heads, then from the heads
    down the tiles of W that ``g W^T`` contracts over, a layer of two
    sources as two products (its 256 trunk rows, and its other rows padded
    to 128); the IPE layout's without the input cotangent's products."""
    f32 = lay.dtype == torch.float32
    k0, kd, kt, skip = lay.k0, lay.kd, lay.kt, lay.skip
    heads = not backward
    slabs, at = [], 0

    def seg(layer, row0, rows, cols, height=None, dgrad=False, col0=0):
        nonlocal at
        at = _cut(slabs, at, layer, dgrad, row0, rows, col0, cols,
                  cols if height is None else height, f32)

    seg(0, 0, k0, W_TRUNK)
    for i in range(1, 8):
        if i == skip:
            seg(i, 0, k0, W_TRUNK)
        seg(i, k0 if i == skip else 0, W_TRUNK, W_TRUNK)
    if lay.variant == SIGMA:
        if backward:
            raise ValueError("the sigma-only kernel has no backward")
        seg(8, 0, W_TRUNK, OUT_W, col0=W_TRUNK)
        return slabs, at
    seg(8, 0, W_TRUNK, W_TRUNK + OUT_W if heads else W_TRUNK)
    seg(9, 0, W_TRUNK, W_HALF)
    seg(9, W_TRUNK, kd, W_HALF)
    if heads:
        seg(10, 0, W_HALF, OUT_W)
    if lay.has_transient:
        seg(11, 0, W_TRUNK, W_HALF)
        seg(11, W_TRUNK, kt, W_HALF)
        for i in (12, 13, 14):
            seg(i, 0, W_HALF, W_HALF)
        if heads:
            seg(15, 0, W_HALF, OUT_W)
    if not backward:
        return slabs, at

    def dgrad(layer, row0, rows, cols, height):
        seg(layer, row0, rows, cols, height, dgrad=True)

    d_inp = not lay.no_d_inp
    if lay.has_transient:
        dgrad(15, 0, W_HALF, OUT_W, W_HALF)
        for i in (14, 13, 12):
            dgrad(i, 0, W_HALF, W_HALF, W_HALF)
        dgrad(11, 0, W_TRUNK, W_HALF, W_TRUNK)
        dgrad(11, W_TRUNK, kt, W_HALF, W_HALF)
    dgrad(10, 0, W_HALF, OUT_W, W_HALF)
    dgrad(9, 0, W_TRUNK, W_HALF, W_TRUNK)
    if d_inp:
        dgrad(9, W_TRUNK, kd, W_HALF, W_HALF)
    dgrad(8, 0, W_TRUNK, W_TRUNK + OUT_W, W_TRUNK)
    for i in range(7, 0, -1):
        if i == skip and d_inp:
            dgrad(i, 0, k0, W_TRUNK, W_HALF)
        dgrad(i, k0 if i == skip else 0, W_TRUNK, W_TRUNK, W_TRUNK)
    if d_inp:
        dgrad(0, 0, k0, W_TRUNK, W_HALF)
    return slabs, at


def slab_index(shapes, slabs, nbytes: int, parts: int = 1) -> np.ndarray:
    """For every element of an image of ``slabs`` (``nbytes`` long) cut
    from layers of (K, N_out) ``shapes``, its index in the flat
    concatenation of those layers (row-major, layer after layer; a slab's
    ``layer`` is its position in ``shapes``), or one past its end for zero
    padding.  ``parts`` 2: an f32 image, a stage the hi then the lo part,
    indexing [hi parts of those layers, lo parts, one zero].

    A slab is a wgmma B operand's shared-memory image, K-major with the
    128-byte swizzle: an image row of contraction values (64 bf16, 32 tf32)
    per column of the product (``Slab``), its 16-byte chunk c at chunk
    ``c ^ (i % 8)`` of row i; in tf32 position k of a row holds contraction
    value ``8 (k // 8) + F32_K_ORDER[k % 8]``."""
    base = np.concatenate([[0], np.cumsum([k * m for k, m in shapes])])
    total = int(base[-1])
    kc, chunk, size = (F32_K, 4, 4) if parts == 2 else (SLAB_K, 8, 2)
    idx = np.full(nbytes // size, parts * total, np.int64)
    order = np.asarray(F32_K_ORDER if parts == 2 else range(8))
    k = np.arange(kc)[None, :]
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
        pos = i * kc + chunk * ((k // chunk) ^ (i % 8)) + k % chunk
        for part in range(parts):
            dst = sl.at // size + part * sl.height * kc + pos
            idx[dst.ravel()] = np.where(real, src + part * total,
                                        parts * total).ravel()
    return idx


@functools.lru_cache(maxsize=32)
def image_index(lay: Layout, backward: bool = False) -> np.ndarray:
    """``slab_index`` of ``lay``'s image: what ``weight_image`` gathers."""
    slabs, nbytes = image_plan(lay, backward)
    return slab_index(lay.shapes, slabs, nbytes,
                      2 if lay.dtype == torch.float32 else 1)


_IMAGE_INDEX_ON = {}


def gather_image(ws, key, index) -> torch.Tensor:
    """The tensors ``ws`` (bf16 weights, or the f32 weights' tf32 hi and lo
    parts) laid out as an image: a flat tensor on their device through the
    numpy index ``index()`` into their concatenation (``slab_index``),
    whose device copy is cached under ``key``.  One cat, one gather."""
    dev = ws[0].device
    idx = _IMAGE_INDEX_ON.get(key + (dev,))
    if idx is None:
        idx = torch.from_numpy(index()).to(dev)
        _IMAGE_INDEX_ON[key + (dev,)] = idx
    flat = torch.cat([w.reshape(-1) for w in ws] + [ws[0].new_zeros(1)])
    return flat.index_select(0, idx)


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


def weight_image(net: PackedNet, backward: bool = False) -> torch.Tensor:
    """``net.ws`` as its layout's kernel (``backward``: its backward kernel)
    streams them, gathered through the cached ``image_index``: each weight
    at least once (the bf16 forward's image is a permutation), in f32 as
    its tf32 hi and lo parts (``tf32_split``), and zero padding.  Device
    launches: one cat, one gather; in f32 the split and one cat more."""
    lay, ws = net.layout, net.ws
    if lay.dtype == torch.float32:
        ws = tf32_split(torch.cat([w.reshape(-1) for w in ws]))
    return gather_image(ws, (lay, bool(backward)),
                        lambda: image_index(lay, backward))


def bwd_tile_counts(lay: Layout):
    """Operand tiles (64 points x 64 columns, 8 KB in bf16) the bf16
    backward of ``lay`` moves per 64 points: (saved by the fused kernel,
    read by the wgrad kernel).  Saved: every layer's input activations and cotangent,
    each once (the heads and fs2's sigma block share one cotangent tile).
    Read: a wgrad block takes two 64-row chunks of a layer's input and all
    of its cotangent, so the cotangent is read once per two chunks
    (csrc/fused_mlp_bwd.cu:make_wplan)."""
    def t(cols):
        return -(-cols // SLAB_K)

    k0, kd, kt = lay.k0, lay.kd, lay.kt
    # (input chunks, cotangent tiles) per packed layer
    layers = [(t(k0), 4)] + [(4, 4)] * 3 + [(t(k0) + 4, 4)] + [(4, 4)] * 3 \
        + [(4, 5), (4 + t(kd), 2), (2, 1)]
    saved = t(k0) + 8 * 4 + 4 + t(kd) + 2 + 1 + 9 * 4 + 2
    if lay.has_transient:
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


def _consts(lay: Layout, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in _encoder_consts(lay.n_freq_xyz, lay.n_freq_dir,
                                        lay.a_dim).items()}


def _layers(net: PackedNet, matmul):
    """(mm, hidden) of the packed layers: ``mm(a, i)``, the f32 product
    with layer i's weight (by ``matmul``); ``hidden(a, i)``, that product
    rounded to the layout's dtype, plus the rounded bias, ReLU."""
    f32, dtype = torch.float32, net.layout.dtype

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


def _forward(inp, net: PackedNet, sx, sd, matmul=torch.matmul):
    """The fused forward in eager torch, keeping every activation the
    backward needs.  Returns (out, acts).  ``matmul``: the layer product
    (exact products, f32 sums; ``f32_ties.tf32x3_mm`` models the f32
    kernels').  The IPE layout encodes as the kernels' tf::encode_ipe:
    ``integrated_pos_enc`` with the Cody-Waite sine."""
    lay, bs = net.layout, net.bs
    dtype, a_dim, t_dim = lay.dtype, lay.a_dim, lay.t_dim
    c = _consts(lay, inp.device)
    mm, hidden = _layers(net, matmul)
    if lay.variant == IPE:
        enc = integrated_pos_enc(inp[:, 0:3], inp[:, 6:9], lay.n_freq_xyz,
                                 fast=True)
        pe = torch.nn.functional.pad(
            enc, (0, lay.k0 - enc.shape[1])).to(dtype)
    else:
        pe = _encode(inp, c["PxR"], c["phx"], c["trgx"], sx, 0,
                     lay.k0).to(dtype)
    ins, outs = _trunk(pe, hidden, lay.skip)
    h = outs[-1]
    fs2 = mm(h, 8) + bs[8]
    xyz_final = fs2[:, :W_TRUNK].to(dtype)

    d_tail = _encode(inp, c["PdR"], c["phd"], c["trgd"], sd, 3, lay.kd)
    if a_dim:
        ma = c["ma"][:, :lay.kd]
        d_pe = 3 + 6 * lay.n_freq_dir
        a_cols = torch.nn.functional.pad(
            inp[:, 6:6 + a_dim], (d_pe, lay.kd - d_pe - a_dim))
        d_tail = torch.where(ma > 0, a_cols, d_tail)
    din = torch.cat([xyz_final, d_tail.to(dtype)], -1)
    hd = hidden(din, 9)
    out = (mm(hd, 10) + bs[10]) + fs2[:, W_TRUNK:]
    acts = {"ins": ins, "outs": outs, "din": din, "hd": hd}
    if lay.has_transient:
        t0 = 6 + a_dim
        t = torch.nn.functional.pad(inp[:, t0:t0 + t_dim],
                                    (0, lay.kt - t_dim)).to(dtype)
        tacts = [torch.cat([xyz_final, t], -1)]
        for i in (11, 12, 13, 14):
            tacts.append(hidden(tacts[-1], i))
        out = out + (mm(tacts[-1], 15) + bs[15])
        acts["tacts"] = tacts
    return out, acts


def fused_mlp_reference(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                        sd: torch.Tensor) -> torch.Tensor:
    """The kernel's function in eager torch: packed (N, 128) f32 input ->
    (N, 16) f32 pre-activations, with the kernel's rounding points."""
    return _forward(inp, net, sx, sd)[0]


def _sigma_net(net: PackedNet) -> PackedNet:
    """``net`` as the sigma-only kernel reads it: its trunk and fs2 under
    its layout's ``sigma``."""
    return PackedNet(net.ws[:SIGMA_LAYERS], net.bs[:SIGMA_LAYERS],
                     net.layout.sigma)


def fused_sigma_reference(xyz: torch.Tensor, net: PackedNet,
                          sx: torch.Tensor) -> torch.Tensor:
    """The sigma-only kernel's function in eager torch: (N, 3) f32
    positions -> (N,) f32 static-sigma pre-activations, through PE(xyz)
    times the scale row ``sx``, the trunk and fs2's 16-column sigma block
    plus its f32 bias: column ``COL_S_SIGMA`` of ``fused_mlp_reference``'s
    output for an f32 net of the skip-4 layout, full or sigma-only."""
    net = _sigma_net(net)
    c = _consts(net.layout, xyz.device)
    _, hidden = _layers(net, torch.matmul)
    pe = _encode(xyz, c["PxR"], c["phx"], c["trgx"], sx, 0, net.layout.k0)
    _, outs = _trunk(pe, hidden)
    block = slice(W_TRUNK, W_TRUNK + OUT_W)
    return (torch.matmul(outs[-1], net.ws[8][:, block])
            + net.bs[8][block])[:, COL_S_SIGMA]


def fused_mlp_bwd_reference(inp: torch.Tensor, net: PackedNet,
                            sx: torch.Tensor, sd: torch.Tensor,
                            g: torch.Tensor, matmul=torch.matmul):
    """The backward kernel's function in eager torch, step for step with
    ``nerf_fl_tpu/ops/fused_mlp.py:_bwd_kernel`` and its rounding points:
    recompute the forward, then backprop the (N, 16) f32 cotangent ``g`` of
    the pre-activations.  Inter-layer cotangents are rounded to the
    layout's dtype; weight and bias grads are f32 sums of exact products.
    Returns (dws, dbs, d_inp): padded (K, N_out) and (N_out,) f32 grads per
    packed layer, and the (N, 128) f32 cotangent of the packed input, None
    for the IPE layout (its kernels take no input cotangent).  (Not
    autograd of ``fused_mlp_reference``: that would keep f32 cotangents.)
    ``matmul`` takes every layer product."""
    f32 = torch.float32
    lay = net.layout
    dtype, a_dim, t_dim = lay.dtype, lay.a_dim, lay.t_dim
    c = _consts(lay, inp.device)
    _, acts = _forward(inp, net, sx, sd, matmul)
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
    if lay.has_transient:
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
        if i == lay.skip:
            d_pe_skip, gg = gg[:, :lay.k0], gg[:, lay.k0:]
    if lay.no_d_inp:
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
                                      lay.k0, d_pe), 1)
    d_inp[:, 3:6] = torch.stack(d_enc(c["PdR"], c["phd"], c["trgd"], sd, 3,
                                      lay.kd, d_dtail,
                                      c["ma"][:, :lay.kd]), 1)
    if a_dim:
        d_pe_dim = 3 + 6 * lay.n_freq_dir
        d_inp[:, 6:6 + a_dim] = d_dtail[:, d_pe_dim:d_pe_dim + a_dim].to(f32)
    if lay.has_transient:
        d_inp[:, 6 + a_dim:6 + a_dim + t_dim] = d_ttail[:, :t_dim].to(f32)
    return dws, dbs, d_inp


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

def kernel_block_info(dtype=torch.bfloat16):
    """The ``dtype`` kernels' blocks as their sources define them (the
    card's build): points a block, the forward's threads and consumer
    warpgroups, dynamic shared-memory bytes, ring depth, the fused
    backward's threads and consumer warpgroups, and the wgrad's split of
    the points: bf16 ``splits`` (a fixed count), f32 ``split_rows``
    (64-point row blocks a split)."""
    f, b = (ctypes.c_int * 10)(), (ctypes.c_int * 12)()
    _lib().nerf_fused_mlp_fwd_info(f)
    _lib_bwd().nerf_fused_mlp_bwd_info(b)
    i, j = (0, 0) if dtype == torch.bfloat16 else (4, 5)
    return {"rows": f[i], "threads": f[i + 1], "consumers": f[8 + i // 4],
            "fwd_smem": f[i + 2], "stages": f[i + 3],
            "bwd_threads": b[j + 1],
            "bwd_consumers": b[10 + j // 5], "bwd_smem": b[j + 2],
            "wgrad_smem": b[j + 3],
            ("splits" if j == 0 else "split_rows"): b[j + 4]}


_V, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PV, _PI, _PL = (ctypes.POINTER(t) for t in (_V, _I, _L))
# each library's entry points and their arguments (the _info ones return
# nothing, the others a CUDA error)
_ARGTYPES = {
    "fused_mlp_fwd": {
        "nerf_fused_mlp_fwd":
            [_I, _V, _V, _I, _PV, _V, _L, _I, _V, _V] + [_I] * 5 + [_V] * 2,
        "nerf_fused_sigma_fwd": [_V, _V, _I, _PV, _V, _L, _I, _V, _I, _V, _V],
        "nerf_fused_ipe_fwd":
            [_V, _V, _I, _PV, _V, _L, _I, _V, _I, _I] + [_V] * 3,
        "nerf_fused_mlp_fwd_info": [_PI]},
    "fused_mlp_bwd": {
        "nerf_fused_mlp_bwd_sizes": [_I] * 8 + [_PL],
        "nerf_fused_mlp_bwd":
            [_I, _V, _V, _V, _I, _PV, _V, _L, _I, _V, _V] + [_I] * 5
            + [_V] * 5,
        "nerf_fused_ipe_bwd_sizes": [_I] * 4 + [_PL],
        "nerf_fused_ipe_bwd":
            [_V, _V, _I, _PV, _V, _L, _I, _V, _I, _I] + [_V] * 6,
        "nerf_fused_mlp_bwd_info": [_PI]},
}


def _load(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for symbol, argtypes in _ARGTYPES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = None if symbol.endswith("_info") else _I
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return _load("fused_mlp_fwd")


@functools.lru_cache(maxsize=1)
def _lib_bwd() -> ctypes.CDLL:
    return _load("fused_mlp_bwd")


def _check_operands(name, x, cols, net, *rows):
    """Raise unless ``x`` is a (N, cols) f32 CUDA tensor whose values one
    launch can index, the packed layers have their layout's shapes and
    dtype (biases f32) and the scale rows are (1, 128) f32, all contiguous
    on its device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols \
            or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (N, {cols}) float32 "
                         "tensor")
    if x.shape[0] >= 2 ** 31 // (LANES if cols == LANES else 1):
        raise ValueError(f"too many points for one launch: {x.shape[0]}")
    shapes = net.layout.shapes
    if len(net.ws) != len(shapes) or len(net.bs) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed layers")
    f32 = torch.float32
    want = [(w, s, net.layout.dtype) for w, s in zip(net.ws, shapes)] \
        + [(b, (s[1],), f32) for b, s in zip(net.bs, shapes)] \
        + [(r, (1, LANES), f32) for r in rows]
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} "
                             f"on {t.device} is not a contiguous {shape} "
                             f"{dtype} tensor on {dev}")


def _ptrs(ts):
    return (ctypes.c_void_p * N_LAYERS)(*[t.data_ptr() for t in ts])


def _grid(net: PackedNet, n: int, dev) -> int:
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return fwd_grid(n, n_sm, net.layout.rows)


def _c_layout(lay: Layout):
    """What ``lay``'s entry points take of it: (dtype code, numbers)."""
    e = _ENTRY[lay.variant]
    code = (_DTYPE_CODE[lay.dtype],) if e.dtype_code else ()
    nums = (lay.n_freq_xyz, lay.n_freq_dir, lay.a_dim, lay.t_dim,
            int(lay.has_transient))
    return code, nums[:e.n_nums]


def _launch(net, backward, image, data, grid, sx, sd, tail=()):
    """Launch the forward (``backward``: backward) kernel of ``net``'s
    layout on the current stream of ``data``' device, streaming ``image``
    (``weight_image(net, backward)``): ``data`` (the operands and the point
    count) and ``tail`` (the backward's buffers) in the places its entry
    point takes them (``_ENTRY``)."""
    e, dev = _ENTRY[net.layout.variant], data[0].device
    runs = _runs(dev)
    symbol, slots = (e.bwd, e.bwd_slots) if backward else (e.fwd, e.fwd_slots)
    code, nums = _c_layout(net.layout)
    rows = [{"x": sx, "d": sd}[r].data_ptr() for r in e.rows]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_lib_bwd() if backward else _lib(), symbol)(
            *code, *[x if isinstance(x, int) else x.data_ptr() for x in data],
            _ptrs(net.bs), image.data_ptr(),
            image.numel() * image.element_size(), grid, *rows, *nums,
            *[x.data_ptr() for x in tail],
            *[runs.data_ptr() + 8 * RUN_SLOTS.index(s) for s in slots],
            stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")


_RUNS: Dict[torch.device, torch.Tensor] = {}


def _runs(dev: torch.device) -> torch.Tensor:
    """The card's int64 run counter (``RUN_SLOTS``).  A CUDA graph bakes
    its address in, so it lives as long as the process; it is made outside
    any capture (a capture would record, and each replay repeat, its
    zeroing)."""
    runs = _RUNS.get(dev)
    if runs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the fused kernels' run counter must exist "
                               "before a CUDA graph captures them: launch "
                               "once outside the capture first")
        runs = _RUNS[dev] = torch.zeros(len(RUN_SLOTS), dtype=torch.int64,
                                        device=dev)
    return runs


def _counted(device) -> Dict[str, int]:
    """The run counter of ``device`` (None: the current CUDA device) read
    back after a synchronize, by slot, or zeros where no kernel has run."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _RUNS:
        return dict.fromkeys(RUN_SLOTS, 0)
    torch.cuda.synchronize(dev)
    return dict(zip(RUN_SLOTS, _RUNS[dev].tolist()))


def kernel_runs(device=None):
    """(forward, backward): the fused kernels that have run on ``device``
    (None: the current CUDA device) in this process, counted on the card
    by the kernels themselves: unlike the wrappers' ``launches`` (host
    calls), each run of a CUDA graph's replay.  The IPE kernels' runs are
    among them, the sigma-only kernel's not.  Synchronizes the device."""
    c = _counted(device)
    return c["fwd"], c["bwd"]


def sigma_runs(device=None) -> int:
    """The sigma-only kernel's runs on ``device``, as ``kernel_runs``."""
    return _counted(device)["sigma"]


def ipe_runs(device=None):
    """(forward, backward): the IPE kernels' runs on ``device``, as
    ``kernel_runs`` (which counts them too)."""
    c = _counted(device)
    return c["ipe_fwd"], c["ipe_bwd"]


def fused_mlp_fwd_cuda(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                       sd: torch.Tensor) -> torch.Tensor:
    """Launch csrc/fused_mlp_fwd.cu's kernel of ``net``'s layout on the
    current stream: packed (N, 128) f32 input -> (N, 16) f32
    pre-activations: bf16 the wgmma kernel, f32 the 3xTF32 one (the IPE
    layout its IPE instance), on ``weight_image(net)`` with ``fwd_grid``
    persistent blocks.  Counts its launches in
    ``fused_mlp_fwd_cuda.launches``; the kernel counts its runs on the card
    (``kernel_runs``; the IPE kernel in ``ipe_runs`` too)."""
    if net.layout.variant == SIGMA:
        raise ValueError("a sigma-only net runs on fused_sigma_cuda")
    _check_operands("fused_mlp_fwd_cuda", inp, LANES, net, sx, sd)
    n = inp.shape[0]
    out = torch.empty((n, OUT_W), dtype=torch.float32, device=inp.device)
    _launch(net, False, weight_image(net), (inp, out, n),
            _grid(net, n, inp.device), sx, sd)
    fused_mlp_fwd_cuda.launches += 1
    return out


fused_mlp_fwd_cuda.launches = 0


def fused_sigma_cuda(xyz: torch.Tensor, net: PackedNet,
                     sx: torch.Tensor) -> torch.Tensor:
    """Launch csrc/fused_mlp_fwd.cu's sigma-only kernel on the current
    stream: (N, 3) f32 positions -> (N,) f32 static-sigma pre-activations,
    the f32 kernel's column ``COL_S_SIGMA`` for the same points and
    weights, of an f32 net of the skip-4 layout, full or sigma-only (its
    trunk and fs2 are read).  Counts its launches in
    ``fused_sigma_cuda.launches``, its runs in ``sigma_runs``."""
    net = _sigma_net(net)
    _check_operands("fused_sigma_cuda", xyz, 3, net, sx)
    n = xyz.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=xyz.device)
    _launch(net, False, weight_image(net), (xyz, out, n),
            _grid(net, n, xyz.device), sx, None)
    fused_sigma_cuda.launches += 1
    return out


fused_sigma_cuda.launches = 0


def fused_mlp_bwd_cuda(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                       sd: torch.Tensor, g: torch.Tensor):
    """Launch csrc/fused_mlp_bwd.cu's backward of ``net``'s layout on the
    current stream: the fused recompute + dgrad kernel on
    ``weight_image(net, backward=True)`` with ``fwd_grid`` persistent
    blocks, the split-K wgrad kernel over the operand tiles it saved, and
    the fixed-order reductions of dW and db.  Operands and result as
    ``fused_mlp_bwd_reference``'s.  Deterministic: two launches on the same
    inputs give bitwise-equal results.  Counts its launches in
    ``fused_mlp_bwd_cuda.launches``, its runs as the forward does."""
    lay, e = net.layout, _ENTRY[net.layout.variant]
    if e.bwd is None:
        raise ValueError("a sigma-only net has no backward")
    _check_operands("fused_mlp_bwd_cuda", inp, LANES, net, sx, sd)
    dev, n = inp.device, inp.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, OUT_W) \
            or g.device != dev or not g.is_contiguous():
        raise ValueError("g must be a contiguous (N, 16) float32 tensor on "
                         "the input's device")
    # the image first: its temporaries are freed before the buffers below
    # are made, which keeps them out of the launch's peak memory
    image, grid = weight_image(net, backward=True), _grid(net, n, dev)
    sizes = (ctypes.c_longlong * 3)()
    code, nums = _c_layout(lay)
    if getattr(_lib_bwd(), e.sizes)(*code, n, grid, *nums, sizes) != 0:
        raise ValueError("fused_mlp_bwd: unsupported shapes")
    scratch_bytes, partial_floats, grad_floats = (int(v) for v in sizes)
    if grad_floats != sum(k * m + m for k, m in lay.shapes):
        raise RuntimeError("fused_mlp_bwd: packed layout disagrees with the "
                           "kernel's")
    # the kernels write d_inp's live columns only; the IPE kernels none
    d_inp = None if lay.no_d_inp else torch.zeros(
        (n, LANES), dtype=torch.float32, device=dev)
    grads = torch.empty(grad_floats, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8,
                          device=dev)
    partial = torch.empty(max(partial_floats, 1), dtype=torch.float32,
                          device=dev)
    operands = [x for x in (inp, g, d_inp) if x is not None]
    _launch(net, True, image, (*operands, n), grid, sx, sd,
            (scratch, partial, grads))
    fused_mlp_bwd_cuda.launches += 1
    per = list(zip(grads.split([k * m + m for k, m in lay.shapes]),
                   lay.shapes))
    return ([x[:k * m].view(k, m) for x, (k, m) in per],
            [x[k * m:] for x, (k, m) in per], d_inp)


fused_mlp_bwd_cuda.launches = 0


# ----------------------------------------------------------------------
# autograd and the public entry
# ----------------------------------------------------------------------

class _FusedField(torch.autograd.Function):
    """Fused PE + MLP with its hand-written backward, as JAX's custom_vjp
    (``nerf_fl_tpu/ops/fused_mlp.py:588-639``): the ``Layout``, the packed
    input, the scale rows and the f32 (weight, bias) pairs of
    ``field_linears`` order, packed inside ``forward`` so that their grads
    reach ``.grad`` in f32.  CUDA tensors launch the kernels; CPU tensors
    run the plain versions."""

    @staticmethod
    def forward(ctx, layout, inp, sx, sd, *params):
        ctx.net = net = _pack(params, layout)
        run = fused_mlp_fwd_cuda if inp.is_cuda else fused_mlp_reference
        pre = run(inp, net, sx, sd)
        ctx.save_for_backward(inp, sx, sd)
        return pre

    @staticmethod
    def backward(ctx, g):
        inp, sx, sd = ctx.saved_tensors
        run = fused_mlp_bwd_cuda if inp.is_cuda else fused_mlp_bwd_reference
        dws, dbs, d_inp = run(inp, ctx.net, sx, sd, g.contiguous())
        grads = unpack_weight_grads(dws, dbs, ctx.net.layout)
        # the BARF scale rows are schedule values, not parameters
        return (None, d_inp, None, None, *grads)


def _field_params(name, model: NeRF, layout: Layout, dev):
    """``model``'s (weight, bias) pairs of ``field_linears`` order for
    ``layout``, which must be on ``dev``."""
    if model.xyz[0].weight.device != dev:
        raise ValueError(f"{name}: model and inputs on different devices")
    return [t for lin in field_linears(model, layout.has_transient)
            for t in (lin.weight, lin.bias)]


def fused_apply_nerf(model: NeRF, layout: Layout, xyz, dirs, a_emb=None,
                     t_emb=None, *, barf_w_xyz=None, barf_w_dir=None
                     ) -> Dict[str, torch.Tensor]:
    """Fused PE + MLP in place of embed + models.mlp.apply_nerf,
    differentiable in the field's parameters and in every input.

    ``layout``: a ``FULL`` layout of ``model`` (``layout_for``).  xyz,
    dirs: (N, 3) raw positions and per-point view directions (the PE
    happens in the kernel); a_emb (N, a_dim) or None; t_emb (N, t_dim),
    read where the layout has the transient branch; barf_w_xyz /
    barf_w_dir: (N_freqs,) BARF annealing weights or None.  CUDA tensors
    launch the forward kernel (and the backward kernel under autograd); CPU
    tensors run the plain versions.  Returns apply_nerf's named-head dict.
    """
    transient = layout.has_transient
    if transient and t_emb is None:
        raise ValueError("a transient layout needs t_emb")
    if not transient:
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
    widths = tuple(0 if x is None else x.shape[-1] for x in (a_emb, t_emb))
    if widths != (layout.a_dim, layout.t_dim):
        raise ValueError(f"embedding widths {widths} are not the layout's "
                         f"{(layout.a_dim, layout.t_dim)}")
    params = _field_params("fused_apply_nerf", model, layout, dev)
    inp = pack_inputs(xyz, dirs, a_emb, t_emb).contiguous()
    with torch.no_grad():
        sx, sd = default_scale_rows(layout.n_freq_xyz, layout.n_freq_dir,
                                    layout.a_dim, barf_w_xyz, barf_w_dir,
                                    device=dev)
    pre = _FusedField.apply(layout, inp, sx.contiguous(), sd.contiguous(),
                            *params)
    return heads(pre, transient)


def fused_apply_mip(model: NeRF, layout: Layout,
                    inp: torch.Tensor) -> Dict[str, torch.Tensor]:
    """mip-NeRF's field over packed (N, 128) IPE rows (``pack_ipe_inputs``:
    each point's Gaussian and unit view direction) in f32, differentiable
    in the field's parameters (not in the rows): CUDA tensors launch the
    IPE kernels, CPU tensors run their plain versions.  ``layout``: the IPE
    layout of ``model`` (``layout_for``).  Returns {"raw_rgb": (N, 3),
    "raw_sigma": (N,)}, the pre-activations before ``models.mlp.mip_heads``."""
    if inp.dim() != 2 or inp.shape[1] != LANES or inp.dtype != torch.float32:
        raise ValueError("inp must be (N, 128) float32 IPE rows")
    params = _field_params("fused_apply_mip", model, layout, inp.device)
    with torch.no_grad():
        sd = default_scale_rows(0, layout.n_freq_dir, 0,
                                device=inp.device)[1]
    pre = _FusedField.apply(layout, inp.contiguous(), sd, sd.contiguous(),
                            *params)
    return {"raw_rgb": pre[:, COL_S_RGB:COL_S_RGB + 3],
            "raw_sigma": pre[:, COL_S_SIGMA]}


def grad_needed(model: NeRF, *xs: torch.Tensor) -> bool:
    """Whether autograd would record a pass of ``model`` over ``xs`` here:
    grad mode is on and an input or a parameter requires grad."""
    return torch.is_grad_enabled() and (
        any(x.requires_grad for x in xs)
        or any(p.requires_grad for p in model.parameters()))


def fused_sigma(model: NeRF, layout: Layout, xyz: torch.Tensor, *,
                barf_w_xyz=None) -> Dict[str, torch.Tensor]:
    """The static sigma alone, in f32, of (N, 3) raw positions: PE(xyz)
    (with BARF's annealing weights ``barf_w_xyz``, (n_freq_xyz,) or None),
    the trunk and the sigma head, as ``apply_nerf(..., sigma_only=True)``
    computes them, in the f32 fused kernel's arithmetic, for ``model`` of
    ``layout`` (its ``sigma`` is taken).  CUDA tensors launch the sigma-only
    kernel (``fused_sigma_cuda``), CPU tensors run its plain version.  No
    backward: it raises where autograd would record the pass
    (``grad_needed``).  Returns {"static_sigma": (N,)}."""
    if grad_needed(model, xyz):
        raise ValueError("fused_sigma has no backward: run it under "
                         "torch.no_grad() or on tensors that need no grad")
    if xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError("xyz must be (N, 3)")
    _field_params("fused_sigma", model, layout.sigma, xyz.device)
    net = pack_weights(model, layout.sigma)
    sx = default_scale_rows(layout.n_freq_xyz, 0, 0, barf_w_xyz,
                            device=xyz.device)[0]
    run = fused_sigma_cuda if xyz.is_cuda else fused_sigma_reference
    pre = run(xyz.to(torch.float32).contiguous(), net, sx.contiguous())
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
