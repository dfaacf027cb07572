"""Plain float32 NeRF-W in PyTorch: the reference that decides `correct`.

It follows the published model (NeRF-W, Martin-Brualla et al. 2021, as
`nerf_pl`'s nerfw branch implements it) with BARF's coarse-to-fine encoding
and learned poses (Lin et al. 2021, as the fork's `--refine_pose` applies
it), written out in plain torch operations at float32 with TF32 off.  It
imports nothing of the program under test.

It also makes the weights and the pose table from the seed (`make_weights`):
the harness loads the same tensors into the program, so both sides start
from one draw that neither side made.

Departures from the published model, each also the program's: the last
sample's interval is 1e2 (`nerf_pl`), the beta term carries `nerf_pl`'s +3
offset, `beta_min` is added after compositing, the static colour takes the
white background from the combined opacity, and the importance samples
come from sorted uniforms made as normalised cumulative exponential
spacings, in the draw order of the program's generator (stratified jitter,
then the coarse sigma noise where `noise_std` > 0, then the spacings).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

DELTA_INF = 1e2


def exact_f32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

def layer_spec(model: dict, typ: str) -> List[Tuple[str, int, int]]:
    """(name, fan_out, fan_in) of every linear layer of one field, in the
    published layout: an 8-layer trunk with the encoded position
    concatenated before layer `skips`, a linear `xyz_final`, the direction
    layer on [xyz_final | encoded direction | appearance], the sigma and
    rgb heads, and for the fine field with a transient head, four layers on
    [xyz_final | transient code] and its sigma, rgb and beta heads."""
    W, D, H = model["W"], model["D"], model["W"] // 2
    x = 3 + 6 * model["N_emb_xyz"]
    d = 3 + 6 * model["N_emb_dir"]
    fine = typ == "fine"
    a = model["N_a"] if fine and model["encode_a"] else 0
    out = []
    for i in range(D):
        fan_in = x if i == 0 else (W + x if i in model["skips"] else W)
        out.append((f"xyz.{i}", W, fan_in))
    out += [("xyz_final", W, W), ("dir", H, W + d + a),
            ("static_sigma", 1, W), ("static_rgb", 3, H)]
    if fine and model["encode_t"]:
        out += [("transient.layers.0", H, W + model["N_tau"])]
        out += [(f"transient.layers.{i}", H, H) for i in (1, 2, 3)]
        out += [("transient.sigma", 1, H), ("transient.rgb", 3, H),
                ("transient.beta", 1, H)]
    return out


def leaf_shapes(config: dict) -> List[Tuple[str, tuple]]:
    """Every trainable leaf's name and shape, in the program's naming
    (`<field>.<layer>.weight` / `.bias`, the embedding tables, the pose
    deltas)."""
    m = config["model"]
    out = []
    for field in ("coarse", "fine"):
        for name, fo, fi in layer_spec(m, field):
            out += [(f"nerf_{field}.{name}.weight", (fo, fi)),
                    (f"nerf_{field}.{name}.bias", (fo,))]
    if m["encode_a"]:
        out.append(("embedding_a", (m["N_vocab"], m["N_a"])))
    if m["encode_t"]:
        out.append(("embedding_t", (m["N_vocab"], m["N_tau"])))
    if config.get("refine_pose"):
        n = config["scene"]["n_images"]
        out += [("learn_poses.r", (n, 3)), ("learn_poses.t", (n, 3))]
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from `seed`, on `device`, in three draws: one
    uniform for every linear layer (weight and bias in U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), torch's default), one normal for the embedding
    tables (N(0, 1)), and zero pose deltas."""
    gen = torch.Generator(device).manual_seed(seed)
    shapes = leaf_shapes(config)
    lin = [(n, s) for n, s in shapes if n.startswith("nerf_")]
    emb = [(n, s) for n, s in shapes if n.startswith("embedding_")]
    out = {}
    u = torch.rand(sum(math.prod(s) for _, s in lin), generator=gen,
                   device=device) * 2.0 - 1.0
    at = 0
    fan = {}
    for name, s in lin:
        if name.endswith(".weight"):
            fan[name[:-len(".weight")]] = s[1]
    for name, s in lin:
        k = math.prod(s)
        bound = 1.0 / math.sqrt(fan[name.rsplit(".", 1)[0]])
        out[name] = (u[at:at + k] * bound).view(s).clone()
        at += k
    if emb:
        z = torch.randn(sum(math.prod(s) for _, s in emb), generator=gen,
                        device=device)
        at = 0
        for name, s in emb:
            k = math.prod(s)
            out[name] = z[at:at + k].view(s).clone()
            at += k
    for name, s in shapes:
        if name.startswith("learn_poses."):
            out[name] = torch.zeros(s, device=device)
    return out


# ----------------------------------------------------------------------
# the field
# ----------------------------------------------------------------------

def barf_weights(epoch: float, n_freqs: int, start: int, end: int,
                 schedule: str, device) -> torch.Tensor:
    """BARF's per-frequency weights.  "fork": alpha = n_freqs / epoch
    between `start` and `end` (0 before, n_freqs after), compared with the
    frequency 2^k; "paper": alpha = n_freqs * clamp((epoch - start) /
    (end - start), 0, 1), compared with the index k.  Weight 0 below,
    (1 - cos(pi (alpha - f))) / 2 within one, 1 above."""
    if schedule == "paper":
        alpha = n_freqs * min(max((epoch - start) / max(end - start, 1e-8),
                                  0.0), 1.0)
        f = torch.arange(n_freqs, dtype=torch.float64)
    else:
        alpha = (n_freqs if epoch > end else
                 n_freqs / max(epoch, 1e-8) if epoch > start else 0.0)
        f = 2.0 ** torch.arange(n_freqs, dtype=torch.float64)
    d = alpha - f
    w = torch.where(d < 0, torch.zeros_like(d),
                    torch.where(d < 1, (1 - torch.cos(d * math.pi)) / 2,
                                torch.ones_like(d)))
    return w.to(torch.float32).to(device)


def posenc(x: torch.Tensor, n_freqs: int,
           w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(2^(n-1) x)],
    each block over x's channels, frequency k's blocks scaled by w[k]."""
    parts = [x]
    for k in range(n_freqs):
        s, c = torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)
        if w is not None:
            s, c = s * w[k], c * w[k]
        parts += [s, c]
    return torch.cat(parts, -1)


def _lin(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def field(p: Dict[str, torch.Tensor], prefix: str, model: dict,
          xyz_emb: torch.Tensor, dir_emb: Optional[torch.Tensor] = None,
          a: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
          sigma_only: bool = False) -> Dict[str, torch.Tensor]:
    """One NeRF-W field over points: the static sigma and rgb, and with a
    transient code `t` the transient sigma, rgb and beta."""
    q = {k[len(prefix) + 1:]: v for k, v in p.items()
         if k.startswith(prefix + ".")}
    h = xyz_emb
    for i in range(model["D"]):
        if i in model["skips"]:
            h = torch.cat([xyz_emb, h], -1)
        h = torch.relu(_lin(q, f"xyz.{i}", h))
    out = {"static_sigma": softplus(_lin(q, "static_sigma", h))[..., 0]}
    if sigma_only:
        return out
    xf = _lin(q, "xyz_final", h)
    parts = [xf, dir_emb] + ([a] if a is not None else [])
    dh = torch.relu(_lin(q, "dir", torch.cat(parts, -1)))
    out["static_rgb"] = torch.sigmoid(_lin(q, "static_rgb", dh))
    if t is None:
        return out
    th = torch.relu(_lin(q, "transient.layers.0", torch.cat([xf, t], -1)))
    for i in (1, 2, 3):
        th = torch.relu(_lin(q, f"transient.layers.{i}", th))
    out["transient_sigma"] = softplus(_lin(q, "transient.sigma", th))[..., 0]
    out["transient_rgb"] = torch.sigmoid(_lin(q, "transient.rgb", th))
    out["transient_beta"] = softplus(_lin(q, "transient.beta", th))[..., 0]
    return out


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), without F.softplus's linear cut-over above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ----------------------------------------------------------------------
# rays, samples, compositing
# ----------------------------------------------------------------------

def exp_so3(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, batched; its Taylor forms below |r|^2 = 1e-9."""
    zero = torch.zeros_like(r[..., 0])
    K = torch.stack([torch.stack([zero, -r[..., 2], r[..., 1]], -1),
                     torch.stack([r[..., 2], zero, -r[..., 0]], -1),
                     torch.stack([-r[..., 1], r[..., 0], zero], -1)], -2)
    sq = (r * r).sum(-1)[..., None, None]
    small = sq < 1e-9
    safe = torch.where(small, torch.ones_like(sq), sq)
    n = torch.sqrt(safe)
    A = torch.where(small, 1 - sq / 6, torch.sin(n) / n)
    B = torch.where(small, 0.5 - sq / 24, (1 - torch.cos(n)) / safe)
    eye = torch.eye(3, device=r.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def posed_rays(p: Dict[str, torch.Tensor], init_c2w: torch.Tensor,
               cam: torch.Tensor, cam_rays: torch.Tensor) -> torch.Tensor:
    """World rays [o, d, near, far] of camera-frame rays [dir, near, far]:
    each ray's camera pose exp(r, t) @ init_c2w of its row `cam`, the
    direction rotated and normalised."""
    R = exp_so3(p["learn_poses.r"])
    top = torch.cat([R, p["learn_poses.t"][..., None]], -1)
    bottom = torch.zeros_like(top[:, :1, :])
    bottom[:, 0, 3] = 1.0
    c2w = (torch.cat([top, bottom], -2) @ init_c2w)[cam]
    d = torch.einsum("nc,nrc->nr", cam_rays[:, :3], c2w[:, :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.cat([c2w[:, :3, 3], d, cam_rays[:, 3:5]], -1)


def stratified(near, far, n: int, perturb: float, gen) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = (near * (1 - t) + far * t).expand(near.shape[0], n)
    if perturb > 0:
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        hi = torch.cat([mid, z[:, -1:]], -1)
        lo = torch.cat([z[:, :1], mid], -1)
        u = torch.rand(z.shape, generator=gen, device=z.device)
        z = lo + (hi - lo) * (perturb * u)
    return z


def sample_pdf(bins, weights, n: int, det: bool, gen,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf `weights` over
    `bins`; `det` takes evenly spaced quantiles, else sorted uniforms."""
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if det:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(
            bins.shape[0], n)
    else:
        e = torch.empty((bins.shape[0], n + 1), device=bins.device)
        e.exponential_(generator=gen)
        s = torch.cumsum(e, -1)
        u = s[:, :-1] / s[:, -1:]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def transmittance(alpha: torch.Tensor) -> torch.Tensor:
    return torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                    1 - alpha[:, :-1]], -1), -1)


def deltas(z: torch.Tensor) -> torch.Tensor:
    d = z[:, 1:] - z[:, :-1]
    return torch.cat([d, torch.full_like(d[:, :1], DELTA_INF)], -1)


def render(p: Dict[str, torch.Tensor], config: dict, rays: torch.Tensor,
           ts: torch.Tensor, gen, *, test_time: bool, perturb: float,
           noise_std: float, epoch: float) -> Dict[str, torch.Tensor]:
    """Coarse samples, the coarse field (sigma only at test time), its
    weights, importance samples, the merge, the fine field with its
    appearance and transient codes, and the static + transient
    composite."""
    m, r = config["model"], config["render"]
    barf = config.get("refine_pose", False)
    wx = wd = None
    if barf:
        b = config["barf"]
        wx, wd = (barf_weights(epoch, n, b["epoch_start"], b["epoch_end"],
                               b["schedule"], rays.device)
                  for n in (m["N_emb_xyz"], m["N_emb_dir"]))
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    n_rays = rays.shape[0]
    z = stratified(near, far, r["N_samples"], perturb, gen)
    S = z.shape[1]

    def pts(zz):
        return (o[:, None] + d[:, None] * zz[..., None]).reshape(-1, 3)

    def dirs(k):
        return posenc(d, m["N_emb_dir"], wd)[:, None].expand(
            n_rays, k, -1).reshape(n_rays * k, -1)

    out = {}
    xe = posenc(pts(z), m["N_emb_xyz"], wx)
    if test_time:
        c = field(p, "nerf_coarse", m, xe, sigma_only=True)
        sig = c["static_sigma"].view(n_rays, S)
    else:
        c = field(p, "nerf_coarse", m, xe, dirs(S))
        sig = c["static_sigma"].view(n_rays, S)
        if noise_std > 0:
            sig = sig + torch.randn(sig.shape, generator=gen,
                                    device=sig.device) * noise_std
    alpha = 1 - torch.exp(-deltas(z) * torch.relu(sig))
    w = alpha * transmittance(alpha)
    if not test_time:
        rgb = (w[..., None] * c["static_rgb"].view(n_rays, S, 3)).sum(1)
        if r["white_back"]:
            rgb = rgb + (1 - w.sum(-1, keepdim=True))
        out["rgb_coarse"] = rgb

    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    zf = sample_pdf(mid, w[:, 1:-1].detach(), r["N_importance"],
                    det=perturb == 0, gen=gen)
    z = torch.sort(torch.cat([z, zf], -1), dim=-1, stable=True).values
    S = z.shape[1]
    ids = ts.long()
    a = p["embedding_a"][ids] if m["encode_a"] else None
    t = p["embedding_t"][ids] if m["encode_t"] else None

    def per_point(v):
        return None if v is None else v[:, None].expand(
            n_rays, S, -1).reshape(n_rays * S, -1)

    f = field(p, "nerf_fine", m, posenc(pts(z), m["N_emb_xyz"], wx),
              dirs(S), per_point(a), per_point(t))
    dl = deltas(z)
    s_sig = f["static_sigma"].view(n_rays, S)
    s_rgb = f["static_rgb"].view(n_rays, S, 3)
    if t is None:
        alpha = 1 - torch.exp(-dl * s_sig)
        w = alpha * transmittance(alpha)
        rgb = (w[..., None] * s_rgb).sum(1)
        if r["white_back"]:
            rgb = rgb + (1 - w.sum(-1, keepdim=True))
        out["rgb_fine"] = rgb
        return out
    t_sig = f["transient_sigma"].view(n_rays, S)
    alpha = 1 - torch.exp(-dl * (s_sig + t_sig))
    T = transmittance(alpha)
    sw = (1 - torch.exp(-dl * s_sig)) * T
    tw = (1 - torch.exp(-dl * t_sig)) * T
    static = (sw[..., None] * s_rgb).sum(1)
    if r["white_back"]:
        static = static + (1 - (alpha * T).sum(-1, keepdim=True))
    transient = (tw[..., None] * f["transient_rgb"].view(n_rays, S, 3)).sum(1)
    out["rgb_fine"] = static + transient
    out["beta"] = (tw * f["transient_beta"].view(n_rays, S)).sum(-1) \
        + m["beta_min"]
    out["transient_sigmas"] = t_sig
    return out


def nerfw_loss(res: Dict[str, torch.Tensor], rgbs: torch.Tensor):
    """NeRF-W's loss (eq. 13 with `nerf_pl`'s constants): half the coarse
    MSE, the fine colour's beta-weighted error, 3 + mean log beta, and
    0.01 x the mean transient density."""
    loss = 0.5 * torch.mean((res["rgb_coarse"] - rgbs) ** 2)
    if "beta" in res:
        beta = res["beta"]
        loss = loss + torch.mean((res["rgb_fine"] - rgbs) ** 2
                                 / (2 * beta[:, None] ** 2))
        loss = loss + 3 + torch.mean(torch.log(beta))
        loss = loss + 0.01 * torch.mean(res["transient_sigmas"])
    else:
        loss = loss + 0.5 * torch.mean((res["rgb_fine"] - rgbs) ** 2)
    return loss
