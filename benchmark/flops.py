"""Operation and byte counts behind every roofline share and `mfu` metric.

Counts are what the algorithm needs for the inputs, from the shapes alone:
a forward is 2 operations a multiply-add, a backward the dgrad and the
wgrad (2 x the forward), never the recompute a kernel may choose.  Bytes
count each input once and each output once.  `fine_macs` is a copy of
`chip_smoke.py:fine_macs`; later changes may add functions here but must
not change what an existing one counts.
"""
from __future__ import annotations

from types import SimpleNamespace


def shape(config: dict) -> SimpleNamespace:
    """The configuration's sizes under the names `fine_macs` reads."""
    m = config["model"]
    return SimpleNamespace(
        N_a=m["N_a"], encode_a=m["encode_a"], encode_t=m["encode_t"],
        N_tau=m["N_tau"], mlp_width=m["W"],
        in_channels_xyz=6 * m["N_emb_xyz"] + 3,
        in_channels_dir=6 * m["N_emb_dir"] + 3)


def fine_macs(cfg, a_dim=None, transient=None) -> int:
    """Multiply-adds per point of the fine MLP, unpadded (the coarse one
    with a_dim 0 and no transient)."""
    a_dim = cfg.N_a * cfg.encode_a if a_dim is None else a_dim
    transient = cfg.encode_t if transient is None else transient
    W, H = cfg.mlp_width, cfg.mlp_width // 2
    x, d = cfg.in_channels_xyz, cfg.in_channels_dir + a_dim
    m = x * W + 6 * W * W + (x + W) * W          # trunk
    m += W * W + W                               # xyz_final, sigma
    m += (W + d) * H + H * 3                     # dir, rgb
    if transient:
        m += (W + cfg.N_tau) * H + 3 * H * H + H * 5
    return m


def sigma_macs(cfg) -> int:
    """Multiply-adds per point of a sigma-only pass: the trunk and the
    sigma head."""
    W, x = cfg.mlp_width, cfg.in_channels_xyz
    return x * W + 6 * W * W + (x + W) * W + W


def train_flops(config: dict) -> float:
    """Model operations of one train step: the coarse field over
    N_samples points a ray and the fine field over N_samples +
    N_importance, forward and backward, for the batch."""
    c, r = shape(config), config["render"]
    B = config["train"]["batch_size"]
    fwd = 2.0 * B * (r["N_samples"] * fine_macs(c, 0, False)
                     + (r["N_samples"] + r["N_importance"]) * fine_macs(c))
    return 3.0 * fwd


def frame_flops(config: dict, rays: int) -> float:
    """Model operations of rendering `rays` rays at test time: the
    sigma-only coarse pass and the fine pass with its transient head."""
    c, r = shape(config), config["render"]
    return 2.0 * rays * (r["N_samples"] * sigma_macs(c)
                         + (r["N_samples"] + r["N_importance"])
                         * fine_macs(c))


def _io(c, a_dim: int, transient: bool):
    """Floats a point reads (position, direction, codes) and writes
    (static rgb and sigma; transient rgb, sigma and beta)."""
    return 6 + a_dim + (c.N_tau if transient else 0), 4 + (5 if transient
                                                           else 0)


def fused_fwd(config: dict, points: int, a_dim: int, transient: bool):
    """(operations, bytes) of one fused forward launch over `points`."""
    c = shape(config)
    macs = fine_macs(c, a_dim, transient)
    i, o = _io(c, a_dim, transient)
    return 2.0 * macs * points, 4.0 * (points * (i + o) + macs)


def fused_bwd(config: dict, points: int, a_dim: int, transient: bool):
    """(operations, bytes) of one fused backward launch over `points`:
    dgrad and wgrad; it reads the inputs, the cotangent and the weights
    and writes the inputs' gradient and the weights'."""
    c = shape(config)
    macs = fine_macs(c, a_dim, transient)
    i, o = _io(c, a_dim, transient)
    return 4.0 * macs * points, 4.0 * (points * (2 * i + o) + 2 * macs)


def train_launches(config: dict):
    """The fused launches of one train step: (points, a_dim, transient)
    of the coarse field and of the fine field; each runs forward and
    backward once."""
    m, r = config["model"], config["render"]
    B = config["train"]["batch_size"]
    return [(B * r["N_samples"], 0, False),
            (B * (r["N_samples"] + r["N_importance"]),
             m["N_a"] if m["encode_a"] else 0, m["encode_t"])]


def least_seconds(ops: float, nbytes: float, peak_flops: float,
                  peak_bw: float) -> float:
    """The least time the card could take: operations over the peak rate
    or bytes over the bandwidth, the larger."""
    return max(ops / peak_flops, nbytes / peak_bw)
