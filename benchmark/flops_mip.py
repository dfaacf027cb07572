"""Operation and byte counts of mip-NeRF's cells, beside `flops.py` (whose
counts this module does not change): what the algorithm needs for the
inputs, from the shapes alone, never the recompute a kernel may choose.

A point of mip-NeRF's field runs the NeRF trunk on the 6 (max_deg_point -
min_deg_point) columns of its IPE, the skip's 256 + 96 columns at layer 5
and the condition layer on the view direction's 27: `flops.fine_macs` of
that shape, 610,304 multiply-adds at the published widths.  A forward is 2
operations a multiply-add; a backward is the wgrad (every layer) and the
dgrad of every layer whose input has a parameter upstream: not layer 0,
not the skip layer's IPE rows, not the condition layer's direction rows,
since the Gaussians and the view direction are no parameters.  Bytes count
each input once and each output once: a point reads its mean, variance
and direction (9 floats) and writes rgb and density (4); the backward reads
those and the cotangent of the 4 outputs and writes no input cotangent;
the weights are read once (and their gradient written once).
"""
from __future__ import annotations

from types import SimpleNamespace

from benchmark import flops

IN_FLOATS = 9       # mean, direction, variance
OUT_FLOATS = 4      # rgb, density


def shape(config: dict) -> SimpleNamespace:
    """The configuration's sizes under the names `flops.fine_macs` reads."""
    m = config["model"]
    return SimpleNamespace(
        N_a=0, encode_a=False, encode_t=False, N_tau=0, mlp_width=m["W"],
        in_channels_xyz=6 * (m["max_deg_point"] - m["min_deg_point"]),
        in_channels_dir=6 * m["deg_view"] + 3)


def macs(config: dict) -> int:
    """Multiply-adds a point of the field's forward."""
    return flops.fine_macs(shape(config), 0, False)


def dgrad_macs(config: dict) -> int:
    """Multiply-adds a point of the dgrad the backward needs."""
    c = shape(config)
    W, H = c.mlp_width, c.mlp_width // 2
    return macs(config) - 2 * c.in_channels_xyz * W - c.in_channels_dir * H


def points(config: dict) -> int:
    """Field points a level of a train step: the batch's rays times the
    intervals a ray."""
    return config["train"]["batch_size"] * config["render"]["N_samples"]


def train_flops(config: dict) -> float:
    """Model operations of one train step, the convention of
    `flops.train_flops`: the forward of every level, times 3."""
    levels = config["model"]["num_levels"]
    return 3.0 * 2.0 * levels * points(config) * macs(config)


def fused_fwd(config: dict, n: int):
    """(operations, bytes) of one forward launch over n points."""
    k = macs(config)
    return 2.0 * k * n, 4.0 * (n * (IN_FLOATS + OUT_FLOATS) + k)


def fused_bwd(config: dict, n: int):
    """(operations, bytes) of one backward launch over n points: wgrad and
    the needed dgrad; reads the inputs, the outputs' cotangent and the
    weights, writes the weights' gradient."""
    k = macs(config)
    return 2.0 * (k + dgrad_macs(config)) * n, \
        4.0 * (n * (IN_FLOATS + OUT_FLOATS) + 2 * k)


def launches(config: dict):
    """Points of each fused launch of a train step: one a level, each run
    forward and backward once."""
    return [points(config)] * config["model"]["num_levels"]
