"""Holding the f32 fused kernels to their plain version at ReLU ties.

The f32 kernels take their layer products as 3xTF32 on the tensor cores
(``tf32x3_mm`` is a plain model of them); the plain versions
(``fused_mlp.fused_mlp_reference`` / ``fused_mlp_bwd_reference``) take them
as f32 matrix products.  Where a hidden unit's pre-activation lies within
f32 rounding of zero, the two can decide its ReLU differently (so can the
same products summed in another order, or in float64), and the backward
then passes or stops that unit's whole cotangent: the point's d_inp and its
share of every dW move by far more than the products' rounding, and a
max-abs limit cannot tell that from a fault.

``matched_backward`` is the plain backward with each such unit (a *tie
unit*: the plain forward's |pre-activation| < ``tol``) on the side of its
ReLU that the kernel took.  The side is read off the kernel's own d_inp,
point by point, among every choice for the point's first ``MAX_TIES`` tie
units; units further from zero, and a point's later tie units, keep the
plain decision.  Every point and every tensor of the kernel's output can
then be held to the f32 limit.  For chip_smoke.py, tests/test_torch_cuda.py
and the CPU tests; no path of the port calls this module.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import fused_mlp as fm

HIDDEN = tuple(range(8)) + (9, 11, 12, 13, 14)   # packed layers with a ReLU
MAX_TIES = 3    # a point's tie units matched to a kernel: 2^3 choices


def tf32x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the f32 kernels take it on the tensor cores: both
    operands split by ``fused_mlp.tf32_split``, the product hi @ hi +
    lo @ hi + hi @ lo (lo @ lo left out) in f32."""
    ah, al = fm.tf32_split(a)
    bh, bl = fm.tf32_split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def _hidden(has_transient: bool):
    return [i for i in HIDDEN if has_transient or i < 11]


def _matmul(flips: Dict[int, torch.Tensor], net: fm.PackedNet,
            base=torch.matmul):
    """A ``matmul`` for ``fused_mlp._forward`` / ``fused_mlp_bwd_reference``
    of ``net`` (which take packed layer i's forward product as their i-th
    call) that puts every unit marked in ``flips[i]`` on the other side of
    its ReLU: an alive unit's pre-activation becomes 0, a dead one's the
    least positive value ``product + bias`` can reach.  Either way it moves
    by no more than the unit's |pre-activation| plus one unit in the last
    place of the bias."""
    calls = [0]
    bs, n_fwd = net.bs, len(net.bs)

    def mm(a, b):
        i = calls[0]
        calls[0] += 1
        y = base(a, b)
        f = flips.get(i) if i < n_fwd else None
        if f is None or not bool(f.any()):
            return y
        nb = -bs[i].to(y.dtype)
        alive = torch.nextafter(nb, torch.full_like(nb, float("inf")))
        return torch.where(f, torch.where(y - nb > 0, nb, alive), y)

    return mm


def pre_activations(inp, net: fm.PackedNet, sx, sd, matmul=torch.matmul):
    """{packed layer: (N, cols) f32 pre-activation} of every hidden layer
    of the plain forward of the f32 ``net`` (its products taken by
    ``matmul``)."""
    outs = []

    def mm(a, b):
        outs.append(matmul(a, b))
        return outs[-1]

    fm._forward(inp, net, sx, sd, mm)
    return {i: outs[i] + net.bs[i]
            for i in _hidden(net.layout.has_transient)}


def tie_units(inp, net: fm.PackedNet, sx, sd, *, tol: float):
    """{packed layer: (N, cols) bool}: the hidden units whose plain f32
    pre-activation lies within ``tol`` of zero."""
    return {i: p.abs() < tol
            for i, p in pre_activations(inp, net, sx, sd).items()}


def matched_backward(d_inp: torch.Tensor, inp, net: fm.PackedNet, sx, sd,
                     g, *, tol: float):
    """(ref, stats): ``fused_mlp_bwd_reference``'s (dws, dbs, d_inp) with
    each point's first ``MAX_TIES`` tie units (``tie_units(tol)``, in layer
    and column order) on the side of their ReLU whose d_inp lies closest
    to ``d_inp``, a kernel's, by max |d| over the point's columns; the
    plain side where that is no farther.  ``stats``: points that have a tie
    unit, the most tie units a point has, points with tie units past
    ``MAX_TIES`` (those keep the plain decision), points on which the
    matched side differs from the plain one, and the largest plain
    |pre-activation| of a unit taken to its other side."""
    pre = pre_activations(inp, net, sx, sd)
    ties = {i: p.abs() < tol for i, p in pre.items()}
    layers = list(ties)
    cat = torch.cat([ties[i] for i in layers], 1)
    rank = cat.to(torch.int32).cumsum(1) - 1
    per_point = cat.sum(1)
    m = min(MAX_TIES, int(per_point.max()))

    def flips(choice):
        bit = (choice[:, None] >> rank.clamp(0, 30)) & 1
        f = cat & (bit > 0) & (rank < m)
        return dict(zip(layers, f.split([ties[i].shape[1] for i in layers],
                                        1)))

    def backward(choice):
        return fm.fused_mlp_bwd_reference(
            inp, net, sx, sd, g, matmul=_matmul(flips(choice), net))

    n = inp.shape[0]
    best = torch.zeros(n, dtype=torch.int64, device=inp.device)
    best_err = None
    for v in range(2 ** m):
        choice = torch.full_like(best, v)
        err = (backward(choice)[2] - d_inp).abs().amax(1)
        if best_err is None:
            best_err = err
            continue
        better = err < best_err
        best = torch.where(better, choice, best)
        best_err = torch.where(better, err, best_err)
    ref = backward(best)
    moved = flips(best)
    farthest = max([float(pre[i][moved[i]].abs().max()) for i in layers
                    if moved[i].any()] or [0.0])
    stats = {"points": n, "tie_points": int((per_point > 0).sum()),
             "most_ties": int(per_point.max()),
             "past_max_ties": int((per_point > m).sum()),
             "moved_points": int(torch.stack(
                 [moved[i].any(1) for i in layers]).any(0).sum()),
             "farthest_moved": farthest}
    return ref, stats
