"""The kernel-anatomy probes: eleven small kernels that take the fused PE +
MLP kernel apart, each with its operands, its plain PyTorch version and the
wrapper that launches its Hopper kernel.

Counterpart of the Pallas probe kernels inside ``main()`` of
``experiments/kernel_anatomy.py`` and ``experiments/kernel_anatomy2.py``.
The CUDA sources are ``csrc/anatomy_chain.cu`` (chain8, concat, split),
``csrc/anatomy_net.cu`` (static, full, consol) and ``csrc/anatomy_pe.cu``
(pe_mm, pe_vpu, sin, pe_mm_bf16, pe_only).  The three chain probes, the
three net probes and the two PE-matmul probes run on the Hopper block of
``csrc/fused_mlp_common.cuh``, as the bf16 fused kernels do: each reads its
weights laid out as the wgmma operand's shared-memory image
(``chain8_image``, ``chain_image``, ``net_image``, ``pe_image``), which the
wrapper builds per call.  ``pe_mm`` runs its f32 product as six bf16 passes
over a three-term split of each operand (``split_terms``, ``PE_PASSES``),
``pe_mm_bf16`` as one pass over operands rounded to bf16.  No probe runs on
the header's first block; the other encoder probes are elementwise.

Every probe is a ``Probe`` in ``PROBES``.  Calling it with its operands, in
the order the Pallas kernel takes its input refs, launches the kernel when
they lie on a CUDA device (or raises) and runs the plain version only when
they lie on the CPU; all return (N, 128) f32.  ``probe.launches`` counts
kernel launches.  The entry points that time the probes are
``nerf_fl_torch/experiments/kernel_anatomy.py`` and ``kernel_anatomy2.py``.

The operand makers (``chain_operands``, ``net_operands``) carry state across
from the JAX files: from the same seed they draw with numpy in those files'
order and shapes and round as ``jnp.asarray(float64 array, dtype)`` does,
to f32 to nearest and from there to bf16 to nearest even, so the tensors
equal the JAX operands bit for bit.

``experiments/kernel_anatomy.py:145`` calls ``_encoder_consts`` with an
argument the function no longer takes and reads a key, ``Px``, that it no
longer returns, so the four PE probes of that file cannot run in the JAX
package as it stands.  The kernels take P, ph, trg and s as operands;
``pe_mm_rows`` builds them as that line meant them: ``P`` is ``PxR`` padded
with zero rows to (128, 128), ``ph`` the quarter-turn phases in radians
(these kernels call a plain sin), ``trg = trgx``, ``s = 1``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.encoding import sin_cw
from . import _build
from .fused_mlp import (LANES, W_HALF, W_TRUNK, _cut, _encoder_consts,
                        _pe_arg, default_scale_rows, gather_image, slab_index)

BF, F32 = torch.bfloat16, torch.float32
ACT_W = W_HALF + W_TRUNK           # 384: [pe | h], [xf | dt], fs2
MID = (1, 2, 3, 5, 6, 7)           # trunk layers stacked into w_mid
# (K, N_out) of the net probes' fs2, dir and rgb layers (padded shapes)
NET_HEADS = [(W_TRUNK, ACT_W), (ACT_W, W_HALF), (W_HALF, W_HALF)]


def _trunk_k(i: int) -> int:
    """Input rows of trunk layer ``i`` at the net probes' padded shapes."""
    return W_HALF if i == 0 else ACT_W if i == 4 else W_TRUNK


# ----------------------------------------------------------------------
# operands
# ----------------------------------------------------------------------

def _draw(rng, scale: float, shape, dtype, device) -> torch.Tensor:
    """One ``rng.normal`` draw, rounded f64 -> f32 -> dtype."""
    a = torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
    return a.to(dtype).to(device)


def chain_operands(n: int, seed: int = 0, device="cpu") -> Dict[str, object]:
    """The draws of ``experiments/kernel_anatomy.py:67-74``: ``ws`` 8 x
    (256, 256) bf16, ``bs`` 8 x (1, 256) f32, ``w4c`` (384, 256) bf16,
    ``x256`` (n, 256) bf16, ``x128`` (n, 128) f32."""
    rng = np.random.default_rng(seed)
    ws = [_draw(rng, 0.05, (W_TRUNK, W_TRUNK), BF, device) for _ in range(8)]
    bs = [_draw(rng, 0.05, (1, W_TRUNK), F32, device) for _ in range(8)]
    w4c = _draw(rng, 0.05, (ACT_W, W_TRUNK), BF, device)
    x256 = _draw(rng, 1.0, (n, W_TRUNK), BF, device)
    x128 = _draw(rng, 1.0, (n, LANES), F32, device)
    return {"ws": ws, "bs": bs, "w4c": w4c, "x256": x256, "x128": x128}


def chain_inputs(o, skip: bool) -> List[torch.Tensor]:
    """chain8 / concat / split operand list: w0 b0 .. w7 b7 [w4c] x."""
    ins = [t for pair in zip(o["ws"], o["bs"]) for t in pair]
    return ins + ([o["w4c"]] if skip else []) + [o["x256"]]


# the skip probes' (concat, split) weight image: layers 0-3, w4c, layers
# 5-7 (never ws[4], which they do not read), as (K, N_out) in consumption
# order; chain8's: the eight layers
CHAIN_IMAGE_SHAPES = [(W_TRUNK, W_TRUNK)] * 4 + [(ACT_W, W_TRUNK)] \
    + [(W_TRUNK, W_TRUNK)] * 3
CHAIN8_IMAGE_SHAPES = [(W_TRUNK, W_TRUNK)] * 8
CHAIN_PROBES = ("chain8", "concat", "split")   # by the kernel's skip


def chain_image_plan(skip: bool = True):
    """The chain kernel's weight slabs in the order it consumes them
    (``csrc/anatomy_chain.cu:make_chain_plan`` walks the same list): every
    layer of ``CHAIN_IMAGE_SHAPES`` (with a skip: concat, split) or
    ``CHAIN8_IMAGE_SHAPES`` (without: chain8) cut into W^T slabs of 64
    input rows x 256 image rows (32 KB); ``Slab.layer`` indexes that list.
    Returns the slabs and the image's size in bytes (34 slabs, 1,114,112 B
    with a skip; 32 slabs, 1,048,576 B without).  split's two products at
    layer 4 (x[:, :128] with w4c[:128], then h with w4c[128:]) read w4c's
    slabs in this order, so split streams concat's image."""
    slabs, at = [], 0
    shapes = CHAIN_IMAGE_SHAPES if skip else CHAIN8_IMAGE_SHAPES
    for layer, (k, m) in enumerate(shapes):
        at = _cut(slabs, at, layer, False, 0, k, 0, m, m)
    return slabs, at


@functools.lru_cache(maxsize=2)
def _chain_index(skip: bool = True):
    slabs, nbytes = chain_image_plan(skip)
    return slab_index(CHAIN_IMAGE_SHAPES if skip else CHAIN8_IMAGE_SHAPES,
                      slabs, nbytes)


def chain_image(ws: Sequence[torch.Tensor], w4c: torch.Tensor
                ) -> torch.Tensor:
    """The eight chain weights ``ws`` (256, 256) and ``w4c`` (384, 256), bf16,
    laid out as the concat and split kernels stream them
    (``chain_image_plan``): a flat bf16 tensor, a permutation of ws[0..3],
    w4c, ws[5..7] (no padding: every K and N is a multiple of 64).
    ``ws[4]`` is never read.  Two device launches: one cat, one gather
    through an index cached per device."""
    layers = list(ws[:4]) + [w4c] + list(ws[5:8])
    return gather_image(layers, ("chain",), _chain_index)


def chain8_image(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The eight chain weights ``ws`` (256, 256) bf16 laid out as the
    chain8 kernel streams them (``chain_image_plan(False)``): a flat bf16
    tensor, a permutation of ws[0..7].  One cat, one gather."""
    return gather_image(list(ws[:8]), ("chain8",),
                        lambda: _chain_index(False))


# pe_mm / pe_mm_bf16: bf16 terms of each operand the kernel multiplies
PE_TERMS = {"pe_mm": 3, "pe_mm_bf16": 1}
# pe_mm's passes as (A term, B term), terms 0 hi, 1 mid, 2 lo, in the
# kernel's order (csrc/anatomy_pe.cu:PASSES): the cross products whose term
# indices sum to at most 2, smallest first.  pe_mm_bf16 runs the last alone.
PE_PASSES = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def split_terms(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """f32 ``x`` as hi + mid + lo by truncation: ``hi`` is x with the low 16
    bits of its f32 pattern cleared, ``mid`` the same of ``x - hi``, ``lo =
    x - hi - mid``; all three f32 tensors that hold bf16 values exactly.
    They share x's sign and lie within 24 bits below hi's leading bit, so
    ``hi + mid + lo == x`` bit for bit while lo is normal (|x| over about
    2^-103; below that lo's last bits fall under f32's normal range).  Not
    for non-finite x: ±inf splits into ±inf, NaN, NaN (``x - hi`` is inf -
    inf), so the six-pass product gives NaN where ``x @ P`` gives ±inf."""
    hi = (x.view(torch.int32) & -0x10000).view(F32)
    rest = x - hi
    mid = (rest.view(torch.int32) & -0x10000).view(F32)
    return hi, mid, rest - mid


def pe_image_plan(terms: int):
    """The pe_mm kernel's view of P's image (``csrc/anatomy_pe.cu:
    make_pe_plan`` walks the same list): each of ``terms`` bf16 terms of P
    (128, 128) cut into W^T slabs of 64 input rows x 128 image rows (16
    KB); ``Slab.layer`` is the term.  Returns the slabs and the image's
    size in bytes (6 slabs, 98,304 B for 3 terms; 2, 32,768 B for 1)."""
    slabs, at = [], 0
    for term in range(terms):
        at = _cut(slabs, at, term, False, 0, LANES, 0, LANES, LANES)
    return slabs, at


@functools.lru_cache(maxsize=2)
def _pe_index(terms: int):
    slabs, nbytes = pe_image_plan(terms)
    return slab_index([(LANES, LANES)] * terms, slabs, nbytes)


def pe_image(P: torch.Tensor, terms: int) -> torch.Tensor:
    """P (128, 128) f32 as the kernel's bf16 terms (3: ``split_terms``, hi,
    mid, lo, exact; 1: P rounded to nearest even), laid out as the pe_mm
    kernel holds them (``pe_image_plan``): a flat bf16 tensor, a permutation
    of the terms.  The split, one cat and one gather through an index
    cached per device."""
    layers = [t.to(BF) for t in split_terms(P)] if terms == 3 \
        else [P.to(BF)]
    return gather_image(layers, ("pe", terms), lambda: _pe_index(terms))


def pe_mm_rows(device="cpu") -> List[torch.Tensor]:
    """P (128, 128), ph, trg, s (1, 128) f32 of the pe_mm / pe_vpu /
    pe_mm_bf16 probes (see the module docstring)."""
    c = _encoder_consts(10, 4, 48)
    P = np.zeros((LANES, LANES), np.float32)
    P[:3] = c["PxR"]
    ph = (2.0 * np.pi * c["phx"].astype(np.float64)).astype(np.float32)
    s = np.ones((1, LANES), np.float32)
    return [torch.from_numpy(a).to(device) for a in (P, ph, c["trgx"], s)]


def net_operands(n: int, seed: int = 0, device="cpu") -> Dict[str, object]:
    """The draws of ``experiments/kernel_anatomy2.py:69-93`` and ``:175``:
    ``trunk`` [w0, b0, .., w7, b7] at the padded shapes (128 / 256 / 384 ->
    256), the fs2, dir, rgb, transient and transient-head layers, the bf16
    inputs ``pe`` / ``dt`` / ``tt`` (n, 128) and the f32 ``inp`` (n, 128) of
    the encoder probe."""
    rng = np.random.default_rng(seed)

    def W(r, c):
        return _draw(rng, 0.05, (r, c), BF, device)

    def B(c):
        return _draw(rng, 0.05, (1, c), F32, device)

    o: Dict[str, object] = {}
    trunk = []
    for i in range(8):
        trunk += [W(_trunk_k(i), W_TRUNK), B(W_TRUNK)]
    o["trunk"] = trunk
    o["wfs"], o["bfs"] = W(W_TRUNK, ACT_W), B(ACT_W)
    o["wd"], o["bd"] = W(ACT_W, W_HALF), B(W_HALF)
    o["wr"], o["br"] = W(W_HALF, W_HALF), B(W_HALF)
    o["wt0"], o["bt0"] = W(ACT_W, W_HALF), B(W_HALF)
    o["wtm"] = [W(W_HALF, W_HALF) for _ in range(3)]
    o["btm"] = [B(W_HALF) for _ in range(3)]
    o["wth"], o["bth"] = W(W_HALF, W_HALF), B(W_HALF)
    for k in ("pe", "dt", "tt"):
        o[k] = _draw(rng, 1.0, (n, LANES), BF, device)
    o["inp"] = _draw(rng, 1.0, (n, LANES), F32, device)
    return o


def net_inputs(o, variant: str) -> List[torch.Tensor]:
    """Operand list of ``static`` / ``full`` / ``consol`` from
    ``net_operands``, in the Pallas kernel's order."""
    heads = [o[k] for k in ("wfs", "bfs", "wd", "bd", "wr", "br")]
    if variant == "static":
        return o["trunk"] + heads + [o["pe"], o["dt"]]
    if variant == "full":
        return (o["trunk"] + heads + [o["wt0"], o["bt0"]] + o["wtm"]
                + o["btm"] + [o["wth"], o["bth"], o["pe"], o["dt"], o["tt"]])
    if variant == "consol":
        return consolidate(o["trunk"]) + heads + [o["pe"], o["dt"]]
    raise ValueError(f"unknown net variant {variant!r}")


def net_image_shapes(transient: bool, stacked: bool = False
                     ) -> List[Tuple[int, int]]:
    """(K, N_out) of the weights a net image is cut from, in operand order:
    the eight trunk weights (``stacked``: w0, w_mid (256, 1536), w_skip, as
    ``consol`` takes them), fs2, dir, rgb, and with ``transient`` t0, t1-t3
    and the transient head."""
    trunk = [(W_HALF, W_TRUNK), (W_TRUNK, 6 * W_TRUNK), (ACT_W, W_TRUNK)] \
        if stacked else [(_trunk_k(i), W_TRUNK) for i in range(8)]
    heads = list(NET_HEADS)
    if transient:
        heads += [(ACT_W, W_HALF)] + [(W_HALF, W_HALF)] * 4
    return trunk + heads


def net_image_plan(transient: bool, stacked: bool = False):
    """The net kernel's weight slabs in the order it consumes them
    (``csrc/anatomy_net.cu:make_net_plan`` walks the same list), cut from
    the layers of ``net_image_shapes``: W^T slabs of 64 input rows, 256
    image rows for the trunk and 128 for the rest.  fs2 is three products
    over h (its columns 256..383, then 0..127, then 128..255); a layer over
    [pe | h] or [xf | dt] reads its rows in order.  ``stacked`` cuts the
    middle trunk layers out of w_mid's column blocks (``Slab.col0``); the
    offsets and sizes do not depend on it.  Returns the slabs and the
    image's size in bytes (52 slabs, 1,376,256 B; 66 and 1,605,632 B with
    the transient branch)."""
    slabs, at = [], 0
    for i in range(8):
        layer, col0 = (i, 0) if not stacked else \
            (0, 0) if i == 0 else (2, 0) if i == 4 else \
            (1, W_TRUNK * MID.index(i))
        at = _cut(slabs, at, layer, False, 0, _trunk_k(i), col0, W_TRUNK,
                  W_TRUNK)
    fs = 3 if stacked else 8
    for col0 in (W_TRUNK, 0, W_HALF):
        at = _cut(slabs, at, fs, False, 0, W_TRUNK, col0, W_HALF, W_HALF)
    shapes = net_image_shapes(transient, stacked)
    for layer in range(fs + 1, len(shapes)):
        at = _cut(slabs, at, layer, False, 0, shapes[layer][0], 0, W_HALF,
                  W_HALF)
    return slabs, at


@functools.lru_cache(maxsize=4)
def _net_index(transient: bool, stacked: bool):
    slabs, nbytes = net_image_plan(transient, stacked)
    return slab_index(net_image_shapes(transient, stacked), slabs, nbytes)


def net_image(layers: Sequence[torch.Tensor], transient: bool,
              stacked: bool = False) -> torch.Tensor:
    """The bf16 weights ``layers`` (shapes ``net_image_shapes``) laid out as
    the net kernel streams them (``net_image_plan``): a flat bf16 tensor, a
    permutation of the weights (no padding: every K and N is a multiple of
    64), 688,128 elements for the static net and 802,816 with the
    transient branch.  The stacked operands give the same bytes as the
    separate ones.  Two device launches: one cat, one gather through an
    index cached per device."""
    key = ("net", bool(transient), bool(stacked))
    return gather_image(layers, key, lambda: _net_index(*key[1:]))


def consolidate(trunk: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """[w0, w_mid (256, 1536), w_skip, b_all (1, 2048)]: the six middle
    trunk weights side by side, every trunk bias in one row
    (``kernel_anatomy2.py:204-205``)."""
    w_mid = torch.cat([trunk[2 * i] for i in MID], 1).contiguous()
    b_all = torch.cat([trunk[2 * i + 1] for i in range(8)], 1).contiguous()
    return [trunk[0], w_mid, trunk[8], b_all]


def encoder_rows(device="cpu") -> List[torch.Tensor]:
    """The nine encoder rows of the fused kernel at its flagship setting
    (10 / 4 frequencies, appearance 48): PxR, phx, trgx, sx, PdR, phd, trgd,
    sd, ma."""
    c = _encoder_consts(10, 4, 48)
    sx, sd = default_scale_rows(10, 4, 48)
    rows = [c["PxR"], c["phx"], c["trgx"], sx, c["PdR"], c["phd"], c["trgd"],
            sd, c["ma"]]
    return [torch.as_tensor(r).to(device).contiguous() for r in rows]


# ----------------------------------------------------------------------
# plain versions (operands in the Pallas kernels' order)
# ----------------------------------------------------------------------

def _mm(a, w):                        # f32 accumulation of exact products
    return a.to(F32) @ w.to(F32)


def _chain_reference(skip: Optional[str], *ops):
    w = ops[:16]
    w4, x = (ops[16], ops[17]) if skip else (None, ops[16])
    h = x
    for i in range(8):
        if i == 4 and skip == "concat":
            y = _mm(torch.cat([x[:, :W_HALF], h], -1), w4)
        elif i == 4 and skip == "split":
            y = _mm(x[:, :W_HALF], w4[:W_HALF]) + _mm(h, w4[W_HALF:])
        else:
            y = _mm(h, w[2 * i])
        h = torch.relu(y + w[2 * i + 1]).to(BF)   # f32 relu, one rounding
    return h[:, :W_HALF].to(F32)


def _dense(a, w, b):
    """``kernel_anatomy2.py``'s dense: the fused kernel's own rounding."""
    return torch.relu(_mm(a, w).to(BF) + b.to(BF))


def _net_reference(transient: bool, *ops):
    tw = ops[:16]
    wfs, bfs, wd, bd, wr, br = ops[16:22]
    pe, dt = (ops[32], ops[33]) if transient else (ops[22], ops[23])
    h = pe
    for i in range(8):
        if i == 4:
            h = torch.cat([pe, h], -1)
        h = _dense(h, tw[2 * i], tw[2 * i + 1])
    fs2 = _mm(h, wfs) + bfs
    xf = fs2[:, :W_TRUNK].to(BF)
    hd = _dense(torch.cat([xf, dt], -1), wd, bd)
    out = (_mm(hd, wr) + br) + fs2[:, W_TRUNK:]
    if transient:
        wt0, bt0 = ops[22], ops[23]
        wtm, btm = ops[24:27], ops[27:30]
        wth, bth, tt = ops[30], ops[31], ops[34]
        th = _dense(torch.cat([xf, tt], -1), wt0, bt0)
        for k in range(3):
            th = _dense(th, wtm[k], btm[k])
        out = out + (_mm(th, wth) + bth)
    return out


def _consol_reference(w0, w_mid, w_skip, b_all, *rest):
    """The static net reading the same numbers out of the stacked operands."""
    ws = {0: w0, 4: w_skip}
    for j, i in enumerate(MID):
        ws[i] = w_mid[:, W_TRUNK * j:W_TRUNK * (j + 1)].contiguous()
    trunk = []
    for i in range(8):
        trunk += [ws[i], b_all[:, W_TRUNK * i:W_TRUNK * (i + 1)]]
    return _net_reference(False, *trunk, *rest)


def _pe_out(E, ph, trg, s):
    return torch.where(trg > 0, torch.sin(E + ph), E) * s


def _pe_mm_reference(P, ph, trg, s, x):
    return _pe_out(x @ P, ph, trg, s)


def _pe_vpu_reference(P, ph, trg, s, x):
    return _pe_out(_pe_arg(x, P, 0, LANES), ph, trg, s)


def _pe_mm_bf16_reference(P, ph, trg, s, x):
    return _pe_out(_mm(x.to(BF), P.to(BF)), ph, trg, s)


def _sin_reference(x):
    return torch.sin(x)


def _pe_only_reference(PxR, phx, trgx, sx, PdR, phd, trgd, sd, ma, inp):
    Ex = _pe_arg(inp, PxR, 0, LANES)
    pe = torch.where(trgx > 0, sin_cw(Ex, phx), Ex) * sx
    Ed = _pe_arg(inp, PdR, 3, LANES)
    dt = torch.where(trgd > 0, sin_cw(Ed, phd), Ed) * sd
    # roll(inp, s)[:, j] = inp[:, (j - s) mod 128], as pltpu.roll
    dt = torch.where(ma > 0, torch.roll(inp, 21, 1), dt)
    return pe + dt + torch.roll(inp, 74, 1)


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

def _card_plan(source: str, fn: str, *args: int) -> Dict[str, object]:
    """A Hopper-block kernel's block and plan as its source defines them
    (the card's build): ``nerf_<fn>(*args, info, off, bytes)`` fills points
    a block, threads, shared-memory bytes, ring depth, slabs, image bytes
    and bytes a ring slab, then every slab's offset and size."""
    n = 128                                   # hop::MAX_SLABS
    info, off, size = (ctypes.c_int * 7)(), (ctypes.c_int * n)(), \
        (ctypes.c_int * n)()
    getattr(_build.load(source), "nerf_" + fn)(*args, info, off, size)
    k = info[4]
    return {"rows": info[0], "threads": info[1], "smem": info[2],
            "stages": info[3], "slabs": k, "image_bytes": info[5],
            "stage_bytes": info[6], "off": list(off[:k]),
            "bytes": list(size[:k])}


@functools.lru_cache(maxsize=None)
def chain_plan(skip: int) -> Dict[str, object]:
    """The chain kernel's block and plan (``_card_plan``) for ``skip`` 0
    (chain8), 1 (concat) or 2 (split): ``CHAIN_PROBES``."""
    return _card_plan("anatomy_chain", "anatomy_chain_plan", skip)


@functools.lru_cache(maxsize=None)
def net_plan(transient: bool) -> Dict[str, object]:
    """The net kernel's block and plan (``_card_plan``), static or with the
    transient branch."""
    return _card_plan("anatomy_net", "anatomy_net_plan", int(transient))


def _check_plan(name: str, plan, slabs, nbytes) -> None:
    if plan["image_bytes"] != nbytes or plan["off"] != [s.at for s in slabs] \
            or plan["bytes"] != [s.height * 128 for s in slabs]:
        raise RuntimeError(f"{name}: the kernel's weight plan disagrees with "
                           f"the Python plan")


@functools.lru_cache(maxsize=None)
def pe_plan(terms: int) -> Dict[str, object]:
    """The pe_mm kernel's block and P's image (``_card_plan``) for 3 terms
    (pe_mm) or 1 (pe_mm_bf16); ``stages`` is 0: the image stays resident."""
    return _card_plan("anatomy_pe", "anatomy_pe_plan", terms)


@functools.lru_cache(maxsize=None)
def _check_chain_plan(skip: int) -> None:
    """Raise unless the chain kernel's plan for ``skip`` is
    ``chain_image_plan``'s."""
    _check_plan(CHAIN_PROBES[skip], chain_plan(skip),
                *chain_image_plan(skip != 0))


@functools.lru_cache(maxsize=None)
def _check_net_plan(transient: bool) -> None:
    """Raise unless the net kernel's plan is ``net_image_plan``."""
    _check_plan("full" if transient else "static", net_plan(transient),
                *net_image_plan(transient))


def _chain_scratch(skip: int):
    """The chain kernel's scratch for chain8 / concat / split (``skip``
    0 / 1 / 2): its weight image, cut from the probe's operands (split's
    is concat's)."""
    def scratch(ops) -> torch.Tensor:
        _check_chain_plan(skip)
        if skip == 0:
            return chain8_image(ops[0:16:2])
        return chain_image(ops[0:16:2], ops[16])
    return scratch


def _net_scratch(transient: bool, stacked: bool = False):
    """The net kernel's scratch for ``static`` / ``full`` / ``consol``
    (``stacked``): its weight image, cut from the probe's operands."""
    def scratch(ops) -> torch.Tensor:
        _check_net_plan(transient)
        if stacked:                       # w0 w_mid w_skip b_all wfs bfs ..
            layers = list(ops[0:3]) + list(ops[4:10:2])
        else:                             # w0 b0 .. w7 b7 wfs bfs wd bd ..
            layers = list(ops[0:22:2])
            if transient:                 # wt0 bt0 wtm0-2 btm0-2 wth bth
                layers += [ops[22], *ops[24:27], ops[30]]
        return net_image(layers, transient, stacked)
    return scratch


@functools.lru_cache(maxsize=None)
def _check_pe_plan(terms: int) -> None:
    """Raise unless the pe_mm kernel's plan for ``terms`` is
    ``pe_image_plan``'s."""
    _check_plan(f"pe_mm ({terms} terms)", pe_plan(terms),
                *pe_image_plan(terms))


def _pe_scratch(terms: int):
    """The pe_mm kernel's scratch for pe_mm (3 terms) or pe_mm_bf16 (1):
    P's image, cut from the probe's P."""
    def scratch(ops) -> torch.Tensor:
        _check_pe_plan(terms)
        return pe_image(ops[0], terms)
    return scratch


@functools.lru_cache(maxsize=None)
def _launcher(source: str):
    """``nerf_<source>(variant, operand pointers, out, n, scratch, stream)``
    of ``csrc/<source>.cu``."""
    fn = getattr(_build.load(source), "nerf_" + source)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


Spec = Tuple[Tuple[Optional[int], int], torch.dtype]   # (rows or None = N, cols)


class Probe:
    """One probe kernel: its plain version, its launcher and its launch
    count.  ``spec`` lists each operand's (shape, dtype) in the Pallas
    kernel's input order, ``None`` standing for the point count N;
    ``scratch(ops)``, where given, makes the one tensor the launcher takes
    besides them (the Hopper-block probes' weight images)."""

    def __init__(self, name: str, replaces: str, source: str, variant: int,
                 spec: Sequence[Spec], plain: Callable[..., torch.Tensor],
                 scratch: Optional[Callable[..., torch.Tensor]] = None):
        self.name, self.replaces, self.variant = name, replaces, variant
        self.source = source
        self.spec, self.plain, self.scratch = list(spec), plain, scratch
        self.launches = 0

    def check(self, ops, device_type: Optional[str] = None) -> int:
        """Raise unless ``ops`` are what the kernel takes; returns N."""
        if len(ops) != len(self.spec):
            raise ValueError(f"{self.name} takes {len(self.spec)} operands, "
                             f"got {len(ops)}")
        n, dev = ops[-1].shape[0], ops[-1].device
        if device_type is not None and dev.type != device_type:
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors")
        if n >= 2 ** 31 // (2 * LANES):
            raise ValueError(f"too many points for one launch: {n}")
        for k, (t, ((rows, cols), dtype)) in enumerate(zip(ops, self.spec)):
            want = (n if rows is None else rows, cols)
            if tuple(t.shape) != want or t.dtype != dtype \
                    or t.device != dev or not t.is_contiguous():
                raise ValueError(
                    f"{self.name}: operand {k} is {tuple(t.shape)} {t.dtype} "
                    f"on {t.device}, expected contiguous {want} {dtype} on "
                    f"{dev}")
        return n

    def cuda(self, *ops: torch.Tensor) -> torch.Tensor:
        """Launch the kernel on the current stream; counts in
        ``self.launches``."""
        n = self.check(ops, "cuda")
        dev = ops[-1].device
        out = torch.empty((n, LANES), dtype=F32, device=dev)
        ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
        # a tensor the launcher takes besides the operands, made from them
        scratch = None if self.scratch is None else self.scratch(ops)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = _launcher(self.source)(
                self.variant, ptrs, out.data_ptr(), n,
                None if scratch is None else scratch.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out

    def __call__(self, *ops: torch.Tensor) -> torch.Tensor:
        if ops and ops[-1].is_cuda:
            return self.cuda(*ops)
        self.check(ops)
        return self.plain(*ops)


def _layers(shapes) -> List[Spec]:
    """[(w, bf16), (b, f32)] per (K, N_out)."""
    out: List[Spec] = []
    for k, m in shapes:
        out += [((k, m), BF), ((1, m), F32)]
    return out


_TRUNK = _layers([(_trunk_k(i), W_TRUNK) for i in range(8)])
_HEADS = _layers(NET_HEADS)
_CHAIN = _layers([(W_TRUNK, W_TRUNK)] * 8)
_ROW = ((1, LANES), F32)
_PTS_BF, _PTS_F32 = ((None, LANES), BF), ((None, LANES), F32)
_X256, _W4C = ((None, W_TRUNK), BF), ((ACT_W, W_TRUNK), BF)
_PE_MM = [((LANES, LANES), F32), _ROW, _ROW, _ROW, _PTS_F32]
_ENC = [((3, LANES), F32), _ROW, _ROW, _ROW] * 2 + [_ROW]
_K1, _K2 = "experiments/kernel_anatomy.py", "experiments/kernel_anatomy2.py"

PROBES: Dict[str, Probe] = {p.name: p for p in (
    Probe("static", f"{_K2}:100", "anatomy_net", 0,
          _TRUNK + _HEADS + [_PTS_BF] * 2,
          functools.partial(_net_reference, False),
          scratch=_net_scratch(False)),
    Probe("full", f"{_K2}:130", "anatomy_net", 1,
          _TRUNK + _HEADS + [((ACT_W, W_HALF), BF), _ROW]
          + [((W_HALF, W_HALF), BF)] * 3 + [_ROW] * 3
          + [((W_HALF, W_HALF), BF), _ROW] + [_PTS_BF] * 3,
          functools.partial(_net_reference, True),
          scratch=_net_scratch(True)),
    Probe("consol", f"{_K2}:207", "anatomy_net", 2,
          [((W_HALF, W_TRUNK), BF), ((W_TRUNK, 6 * W_TRUNK), BF),
           ((ACT_W, W_TRUNK), BF), ((1, 8 * W_TRUNK), F32)]
          + _HEADS + [_PTS_BF] * 2, _consol_reference,
          scratch=_net_scratch(False, stacked=True)),
    Probe("chain8", f"{_K1}:77", "anatomy_chain", 0, _CHAIN + [_X256],
          functools.partial(_chain_reference, None),
          scratch=_chain_scratch(0)),
    Probe("concat", f"{_K1}:98", "anatomy_chain", 1,
          _CHAIN + [_W4C, _X256],
          functools.partial(_chain_reference, "concat"),
          scratch=_chain_scratch(1)),
    Probe("split", f"{_K1}:120", "anatomy_chain", 2, _CHAIN + [_W4C, _X256],
          functools.partial(_chain_reference, "split"),
          scratch=_chain_scratch(2)),
    Probe("pe_mm", f"{_K1}:151", "anatomy_pe", 0, _PE_MM, _pe_mm_reference,
          scratch=_pe_scratch(3)),
    Probe("pe_vpu", f"{_K1}:164", "anatomy_pe", 1, _PE_MM,
          _pe_vpu_reference),
    Probe("sin", f"{_K1}:180", "anatomy_pe", 2, [_PTS_F32], _sin_reference),
    Probe("pe_mm_bf16", f"{_K1}:188", "anatomy_pe", 3, _PE_MM,
          _pe_mm_bf16_reference, scratch=_pe_scratch(1)),
    Probe("pe_only", f"{_K2}:177", "anatomy_pe", 4, _ENC + [_PTS_F32],
          _pe_only_reference),
)}
