"""Fused positional encoding + NeRF-W MLP forward: the Hopper kernel, its
plain PyTorch version and the wrapper that chooses between them.

Counterpart of ``nerf_fl_tpu/ops/fused_mlp.py`` (forward only).  The kernel
is ``csrc/fused_mlp_fwd.cu``; this module packs its operands, launches it,
and keeps ``fused_mlp_reference``, the same arithmetic in eager torch with
the same rounding points.  The wrapper ``fused_apply_nerf`` launches the
kernel for CUDA tensors (or raises) and runs the plain version only for
tensors on the CPU.

Layouts:
  * input, one packed (N, 128) f32 row per point:
    ``[xyz 0:3 | dir 3:6 | a 6:6+a_dim | t ...+t_dim | 0]`` (as the TPU
    kernel's);
  * output, (N, 16) f32 pre-activations: cols 0-2 static rgb, 3 static
    sigma, 4-6 transient rgb, 7 transient sigma, 8 beta, the rest zero;
  * weights, (K, N_out) row-major in the compute dtype, each K and N_out
    padded with zeros only to the next multiple of 16 (the tensor-core
    granule).  Biases f32.  See ``pack_weights``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..core.encoding import sin_cw
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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


class PackedNet(NamedTuple):
    ws: List[torch.Tensor]    # (K, N_out) compute dtype, contiguous
    bs: List[torch.Tensor]    # (N_out,) f32
    k0: int                   # padded PE(xyz) width
    kd: int                   # padded [PE(dir) | a] width
    kt: int                   # padded t width (0 without transient)


def pack_weights(model: NeRF, a_dim: int, has_transient: bool, dtype,
                 n_freq_xyz: int, n_freq_dir: int,
                 t_dim: int = 0) -> PackedNet:
    """Lay the nn.Linear (out, in) weights out as the kernel reads them:
    (in, out) row-major, zero-padded to 16-multiples.  Head columns land at
    their packed output positions.  Layer order: trunk 0..7, fs2 =
    [xyz_final | static sigma at col 256+3], dir, static rgb head, then with
    transient: transient 0..3, fused transient heads [rgb | sigma | beta] at
    cols 4..8."""
    f32 = torch.float32
    dev = model.xyz[0].weight.device
    k0 = _round16(3 + 6 * n_freq_xyz)
    kd = _round16(3 + 6 * n_freq_dir + a_dim)
    kt = _round16(t_dim) if has_transient else 0
    n_xyz_in = model.xyz[0].in_features

    def wt(lin, rows=None):
        w = lin.weight.detach().t().to(f32)
        return w if rows is None else w[rows]

    def pad_rows(w, rows):
        return torch.nn.functional.pad(w, (0, 0, 0, rows - w.shape[0]))

    def bias(lin, n_out=None, at=0):
        b = lin.bias.detach().to(f32)
        if n_out is None:
            return b
        out = torch.zeros(n_out, dtype=f32, device=dev)
        out[at:at + b.shape[0]] = b
        return out

    ws, bs = [], []
    for i, lin in enumerate(model.xyz):
        if i == 0:
            w = pad_rows(wt(lin), k0)
        elif i == 4:
            w = torch.cat([pad_rows(wt(lin)[:n_xyz_in], k0),
                           wt(lin)[n_xyz_in:]])
        else:
            w = wt(lin)
        ws.append(w)
        bs.append(bias(lin))
    # fs2: (256, 256 + 16)
    wfs = torch.zeros(W_TRUNK, W_TRUNK + OUT_W, dtype=f32, device=dev)
    wfs[:, :W_TRUNK] = wt(model.xyz_final)
    wfs[:, W_TRUNK + COL_S_SIGMA] = wt(model.static_sigma)[:, 0]
    bfs = torch.zeros(W_TRUNK + OUT_W, dtype=f32, device=dev)
    bfs[:W_TRUNK] = bias(model.xyz_final)
    bfs[W_TRUNK + COL_S_SIGMA] = bias(model.static_sigma)[0]
    ws.append(wfs)
    bs.append(bfs)
    # dir branch: (256 + kd, 128)
    wd = wt(model.dir)
    ws.append(torch.cat([wd[:W_TRUNK], pad_rows(wd[W_TRUNK:], kd)]))
    bs.append(bias(model.dir))
    # static rgb head at output cols 0..2: (128, 16)
    wr = torch.zeros(W_HALF, OUT_W, dtype=f32, device=dev)
    wr[:, COL_S_RGB:COL_S_RGB + 3] = wt(model.static_rgb)
    ws.append(wr)
    bs.append(bias(model.static_rgb, OUT_W, COL_S_RGB))
    if has_transient:
        tp = model.transient
        w0 = wt(tp.layers[0])
        ws.append(torch.cat([w0[:W_TRUNK], pad_rows(w0[W_TRUNK:], kt)]))
        bs.append(bias(tp.layers[0]))
        for lin in tp.layers[1:]:
            ws.append(wt(lin))
            bs.append(bias(lin))
        wth = torch.zeros(W_HALF, OUT_W, dtype=f32, device=dev)
        wth[:, COL_T_RGB:COL_T_RGB + 3] = wt(tp.rgb)
        wth[:, COL_T_SIGMA] = wt(tp.sigma)[:, 0]
        wth[:, COL_T_BETA] = wt(tp.beta)[:, 0]
        bth = torch.zeros(OUT_W, dtype=f32, device=dev)
        bth[COL_T_RGB:COL_T_RGB + 3] = bias(tp.rgb)
        bth[COL_T_SIGMA] = bias(tp.sigma)[0]
        bth[COL_T_BETA] = bias(tp.beta)[0]
        ws.append(wth)
        bs.append(bth)
    ws = [w.to(dtype).contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    return PackedNet(ws, bs, k0, kd, kt)


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------

def _encode(inp, R, ph, trg, scale, src, width):
    """Columns [0, width) of where(trg, sin_cw(E, ph), E) * scale with
    E = sum_c inp[:, src+c] * R[c] (exact: one non-zero term per column)."""
    R, ph, trg, scale = (x[:, :width] for x in (R, ph, trg, scale))
    E = inp[:, src:src + 1] * R[0:1]
    for c in (1, 2):
        E = E + inp[:, src + c:src + c + 1] * R[c:c + 1]
    return torch.where(trg > 0, sin_cw(E, ph), E) * scale


def fused_mlp_reference(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                        sd: torch.Tensor, *, n_freq_xyz: int, n_freq_dir: int,
                        a_dim: int, t_dim: int, has_transient: bool,
                        dtype) -> torch.Tensor:
    """The kernel's function in eager torch: packed (N, 128) f32 input ->
    (N, 16) f32 pre-activations, with the kernel's rounding points."""
    f32 = torch.float32
    c = {k: torch.as_tensor(v, device=inp.device)
         for k, v in _encoder_consts(n_freq_xyz, n_freq_dir, a_dim).items()}
    ws, bs = net.ws, net.bs

    def mm(a, i):                       # f32 accumulation of exact products
        return a.to(f32) @ ws[i].to(f32)

    def hidden(a, i):
        y = mm(a, i).to(dtype)
        return torch.relu(y + bs[i].to(dtype))

    pe = _encode(inp, c["PxR"], c["phx"], c["trgx"], sx, 0, net.k0).to(dtype)
    h = hidden(pe, 0)
    for i in range(1, 8):
        h = hidden(torch.cat([pe, h], -1) if i == 4 else h, i)
    fs2 = mm(h, 8) + bs[8]
    xyz_final = fs2[:, :W_TRUNK].to(dtype)

    d_tail = _encode(inp, c["PdR"], c["phd"], c["trgd"], sd, 3, net.kd)
    if a_dim:
        ma = c["ma"][:, :net.kd]
        d_pe = 3 + 6 * n_freq_dir
        a_cols = torch.nn.functional.pad(
            inp[:, 6:6 + a_dim], (d_pe, net.kd - d_pe - a_dim))
        d_tail = torch.where(ma > 0, a_cols, d_tail)
    hd = hidden(torch.cat([xyz_final, d_tail.to(dtype)], -1), 9)
    out = (mm(hd, 10) + bs[10]) + fs2[:, W_TRUNK:]
    if has_transient:
        t0 = 6 + a_dim
        t = torch.nn.functional.pad(inp[:, t0:t0 + t_dim],
                                    (0, net.kt - t_dim)).to(dtype)
        th = hidden(torch.cat([xyz_final, t], -1), 11)
        for i in (12, 13, 14):
            th = hidden(th, i)
        out = out + (mm(th, 15) + bs[15])
    return out


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_fwd")
    lib.nerf_fused_mlp_fwd.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
         ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.nerf_fused_mlp_fwd.restype = ctypes.c_int
    return lib


def _expected_shapes(net: PackedNet, has_transient: bool):
    k0, kd, kt = net.k0, net.kd, net.kt
    shapes = [(k0, W_TRUNK)] + [(W_TRUNK, W_TRUNK)] * 3 \
        + [(k0 + W_TRUNK, W_TRUNK)] + [(W_TRUNK, W_TRUNK)] * 3 \
        + [(W_TRUNK, W_TRUNK + OUT_W), (W_TRUNK + kd, W_HALF),
           (W_HALF, OUT_W)]
    if has_transient:
        shapes += [(W_TRUNK + kt, W_HALF)] + [(W_HALF, W_HALF)] * 3 \
            + [(W_HALF, OUT_W)]
    return shapes


def fused_mlp_fwd_cuda(inp: torch.Tensor, net: PackedNet, sx: torch.Tensor,
                       sd: torch.Tensor, *, n_freq_xyz: int, n_freq_dir: int,
                       a_dim: int, t_dim: int, has_transient: bool,
                       dtype) -> torch.Tensor:
    """Launch csrc/fused_mlp_fwd.cu on the current stream: packed (N, 128)
    f32 input -> (N, 16) f32 pre-activations.  Counts its launches in
    ``fused_mlp_fwd_cuda.launches``."""
    dev = inp.device
    if dev.type != "cuda":
        raise ValueError("fused_mlp_fwd_cuda takes CUDA tensors")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported compute dtype {dtype}")
    if inp.dtype != torch.float32 or inp.dim() != 2 \
            or inp.shape[1] != LANES or not inp.is_contiguous():
        raise ValueError("inp must be a contiguous (N, 128) float32 tensor")
    shapes = _expected_shapes(net, has_transient)
    if len(net.ws) != len(shapes) or len(net.bs) != len(shapes):
        raise ValueError(f"expected {len(shapes)} packed layers")
    for w, b, s in zip(net.ws, net.bs, shapes):
        if tuple(w.shape) != s or w.dtype != dtype or w.device != dev \
                or not w.is_contiguous():
            raise ValueError(f"packed weight {tuple(w.shape)} {w.dtype} does "
                             f"not match {s} {dtype} on {dev}")
        if tuple(b.shape) != (s[1],) or b.dtype != torch.float32 \
                or b.device != dev or not b.is_contiguous():
            raise ValueError(f"packed bias {tuple(b.shape)} does not match "
                             f"({s[1]},) float32 on {dev}")
    for r in (sx, sd):
        if tuple(r.shape) != (1, LANES) or r.dtype != torch.float32 \
                or r.device != dev or not r.is_contiguous():
            raise ValueError("scale rows must be contiguous (1, 128) float32")
    n = inp.shape[0]
    if n >= 2 ** 31 // LANES:
        raise ValueError(f"too many points for one launch: {n}")
    out = torch.empty((n, OUT_W), dtype=torch.float32, device=dev)
    w_arr = (ctypes.c_void_p * N_LAYERS)(*[w.data_ptr() for w in net.ws])
    b_arr = (ctypes.c_void_p * N_LAYERS)(*[b.data_ptr() for b in net.bs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().nerf_fused_mlp_fwd(
            _DTYPE_CODE[dtype], inp.data_ptr(), out.data_ptr(), n, w_arr,
            b_arr, sx.data_ptr(), sd.data_ptr(), n_freq_xyz, n_freq_dir,
            a_dim, t_dim, int(has_transient), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed: CUDA error "
                           f"{err}")
    fused_mlp_fwd_cuda.launches += 1
    return out


fused_mlp_fwd_cuda.launches = 0


# ----------------------------------------------------------------------
# public entry
# ----------------------------------------------------------------------

def fused_apply_nerf(model: NeRF, xyz, dirs, a_emb=None, t_emb=None, *,
                     output_transient: bool = False,
                     compute_dtype=torch.bfloat16,
                     n_freq_xyz: int = 10, n_freq_dir: int = 4,
                     barf_w_xyz=None, barf_w_dir=None
                     ) -> Dict[str, torch.Tensor]:
    """Fused PE + MLP forward in place of embed + models.mlp.apply_nerf.

    xyz, dirs: (N, 3) raw positions and per-point view directions (the PE
    happens in the kernel); a_emb (N, a_dim) or None; t_emb (N, t_dim),
    required when output_transient; barf_w_xyz / barf_w_dir: (N_freqs,)
    BARF annealing weights or None.  CUDA tensors launch the kernel; CPU
    tensors run ``fused_mlp_reference``.  Forward only: the backward kernel
    is not ported yet.  Returns the same named-head dict as apply_nerf.
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
    on_cuda = dev.type == "cuda"
    if on_cuda and torch.is_grad_enabled() and (
            any(x.requires_grad for x in inputs)
            or any(p.requires_grad for p in model.parameters())):
        raise NotImplementedError(
            "fused_apply_nerf is forward-only: the backward kernel "
            "(nerf_fl_tpu/ops/fused_mlp.py:_bwd_kernel) is ported in the "
            "training slice; call it under torch.no_grad()")
    a_dim = 0 if a_emb is None else a_emb.shape[-1]
    t_dim = 0 if t_emb is None else t_emb.shape[-1]
    with torch.no_grad():
        inp = pack_inputs(xyz, dirs, a_emb, t_emb).contiguous()
        net = pack_weights(model, a_dim, output_transient, compute_dtype,
                           n_freq_xyz, n_freq_dir, t_dim)
        sx, sd = default_scale_rows(n_freq_xyz, n_freq_dir, a_dim,
                                    barf_w_xyz, barf_w_dir, device=dev)
        kw = dict(n_freq_xyz=n_freq_xyz, n_freq_dir=n_freq_dir, a_dim=a_dim,
                  t_dim=t_dim, has_transient=bool(output_transient),
                  dtype=compute_dtype)
        if on_cuda:
            pre = fused_mlp_fwd_cuda(inp, net, sx.contiguous(),
                                     sd.contiguous(), **kw)
        else:
            pre = fused_mlp_reference(inp, net, sx, sd, **kw)
    return heads(pre, output_transient)


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
