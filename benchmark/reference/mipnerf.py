"""Plain float32 mip-NeRF in PyTorch: the reference that decides `correct`
for the mip-NeRF configuration.

It follows the published model (Barron et al., "Mip-NeRF: A Multiscale
Representation for Anti-Aliasing Neural Radiance Fields", ICCV 2021, as
github.com/google/mipnerf implements it: internal/mip.py's cast_rays,
conical_frustum_to_gaussian, lift_gaussian, integrated_pos_enc,
sample_along_rays, resample_along_rays and volumetric_rendering;
internal/math.py's sorted_piecewise_constant_pdf and learning_rate_decay;
internal/models.py's MipNerfModel and MLP; train.py's loss), written out in
plain torch operations at float32 with TF32 off.  It imports nothing of the
program under test.

It also makes the weights from the seed (`make_weights`): the harness
loads the same tensors into the program, so both sides start from one draw
that neither side made.  Its parameter names are the program's (`nerf.` +
the layer: `xyz.0` .. `xyz.7` the trunk, `xyz_final` the bottleneck,
`static_sigma` the density layer, `dir` the condition layer, `static_rgb`
the rgb layer), each weight (fan_out, fan_in) as torch's Linear holds it.

Departures from the published code, none of which changes the function:
  * `torch.sin` and `torch.cos` where the published code takes
    `safe_sin(x)` (sin of x mod 100 pi) and `safe_sin(x + pi / 2)`: the
    same function, without the roundings of the mod and of the added
    quarter turn;
  * the view direction's encoding lists its columns as [d, sin 2^0 d,
    cos 2^0 d, sin 2^1 d, ...] (the program's order) where `pos_enc`
    lists [d, all sines, all cosines]: a permutation of the condition
    layer's input rows, whose weights are drawn at random here;
  * the random draws come from a torch.Generator, in the program's order:
    level 0's jitter (N, S + 1) uniforms, level 1's (N, S + 1) uniforms
    (density noise is 0 in the Blender recipe and is not drawn);
  * the step count of the lr is held (the configuration's `step`), and
    the batch's rays come from every view, not from one image.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def exact_f32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

def layer_spec(model: dict) -> List[Tuple[str, int, int]]:
    """(name, fan_out, fan_in) of every Dense layer of the MLP, in the
    published order: D layers of W (the input of layer skip_layer + 1 is
    [h, IPE]), the density layer, the bottleneck, the condition layer on
    [bottleneck, PE(view direction)], the rgb layer."""
    W, D, skip = model["W"], model["D"], model["skip_layer"]
    x = 6 * (model["max_deg_point"] - model["min_deg_point"])
    d = 3 + 6 * model["deg_view"]
    out = []
    for i in range(D):
        fan_in = x if i == 0 else (W + x if i - 1 == skip else W)
        out.append((f"xyz.{i}", W, fan_in))
    out += [("static_sigma", 1, W), ("xyz_final", W, W),
            ("dir", model["net_width_condition"], W + d),
            ("static_rgb", 3, model["net_width_condition"])]
    return out


def leaf_shapes(config: dict) -> List[Tuple[str, tuple]]:
    """Every trainable leaf's name and shape in the program's naming."""
    out = []
    for name, fo, fi in layer_spec(config["model"]):
        out += [(f"nerf.{name}.weight", (fo, fi)), (f"nerf.{name}.bias", (fo,))]
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The MLP's weights from `seed`, on `device`: one uniform draw for
    every kernel, each scaled to glorot_uniform's U(-a, a), a = sqrt(6 /
    (fan_in + fan_out)) (flax's Dense under MipNerfModel's MLP), and zero
    biases."""
    gen = torch.Generator(device).manual_seed(seed)
    spec = layer_spec(config["model"])
    u = torch.rand(sum(fo * fi for _, fo, fi in spec), generator=gen,
                   device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, fo, fi in spec:
        a = math.sqrt(6.0 / (fi + fo))
        out[f"nerf.{name}.weight"] = (u[at:at + fo * fi] * a).view(fo, fi) \
            .clone()
        out[f"nerf.{name}.bias"] = torch.zeros(fo, device=device)
        at += fo * fi
    return out


# ----------------------------------------------------------------------
# rays, cones, encodings
# ----------------------------------------------------------------------

def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """The stable form: (mean, diagonal covariance) of the frustums."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                         / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                - 4 / 15 * (hw ** 4) / (3 * mu ** 2 + hw ** 2))
    return lift_gaussian(d, t_mean, t_var, r_var)


def lift_gaussian(d, t_mean, t_var, r_var):
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, -1, keepdim=True), min=1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def cast_rays(t_vals, origins, directions, radii):
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    means, covs = conical_frustum_to_gaussian(directions, t0, t1, radii)
    return means + origins[..., None, :], covs


def integrated_pos_enc(means, covs, min_deg, max_deg):
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          device=means.device)
    shape = list(means.shape[:-1]) + [-1]
    y = torch.reshape(means[..., None, :] * scales[:, None], shape)
    y_var = torch.reshape(covs[..., None, :] * scales[:, None] ** 2, shape)
    w = torch.exp(-0.5 * y_var)
    return torch.cat([torch.sin(y) * w, torch.cos(y) * w], -1)


def pos_enc(x, deg):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(deg-1) x), cos(...)]."""
    parts = [x]
    for k in range(deg):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, -1)


def sample_along_rays(origins, directions, radii, num_samples, near, far,
                      randomized, gen):
    t_vals = torch.linspace(0.0, 1.0, num_samples + 1, device=origins.device)
    t_vals = near * (1.0 - t_vals) + far * t_vals
    if randomized:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], -1)
        lower = torch.cat([t_vals[..., :1], mids], -1)
        t_rand = torch.rand((origins.shape[0], num_samples + 1),
                            generator=gen, device=origins.device)
        t_vals = lower + (upper - lower) * t_rand
    else:
        t_vals = t_vals.expand(origins.shape[0], num_samples + 1)
    return t_vals, cast_rays(t_vals, origins, directions, radii)


def sorted_piecewise_constant_pdf(bins, weights, num_samples, randomized,
                                  gen):
    eps = 1e-5
    weight_sum = torch.sum(weights, -1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], -1)
    if randomized:
        s = 1 / num_samples
        u = torch.arange(num_samples, device=bins.device) * s
        u = u + torch.rand(list(cdf.shape[:-1]) + [num_samples],
                           generator=gen, device=bins.device) * (s - F32_EPS)
        u = torch.clamp(u, max=1.0 - F32_EPS)
    else:
        u = torch.linspace(0.0, 1.0 - F32_EPS, num_samples,
                           device=bins.device)
        u = u.expand(list(cdf.shape[:-1]) + [num_samples])
    # the published search: for each sample, the largest edge whose cdf is
    # at most u and the smallest whose cdf exceeds it
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.max(torch.where(mask, x[..., None], x[..., :1, None]),
                       -2).values
        x1 = torch.min(torch.where(~mask, x[..., None], x[..., -1:, None]),
                       -2).values
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0.0),
                    0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(origins, directions, radii, t_vals, weights,
                        randomized, resample_padding, gen):
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding
    new_t_vals = sorted_piecewise_constant_pdf(
        t_vals, weights, t_vals.shape[-1], randomized, gen).detach()
    return new_t_vals, cast_rays(new_t_vals, origins, directions, radii)


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd):
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], -1)], -1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(-2)
    acc = weights.sum(-1)
    distance = torch.nan_to_num((weights * t_mids).sum(-1) / acc,
                                nan=float("inf"))
    distance = torch.clamp(distance, t_vals[:, 0], t_vals[:, -1])
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc, weights


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) (jax.nn.softplus), without F.softplus's linear
    cut-over above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _dense(p, name, x):
    return x @ p[f"nerf.{name}.weight"].t() + p[f"nerf.{name}.bias"]


def mlp(p, model: dict, x, condition):
    """MLP.__call__: (raw_rgb (N, S, 3), raw_density (N, S, 1)) of x (N, S,
    IPE) and the per-ray condition (N, C)."""
    n, s = x.shape[:2]
    x = x.reshape(n * s, -1)
    inputs = x
    for i in range(model["D"]):
        x = torch.relu(_dense(p, f"xyz.{i}", x))
        if i % model["skip_layer"] == 0 and i > 0:
            x = torch.cat([x, inputs], -1)
    raw_density = _dense(p, "static_sigma", x).reshape(n, s, 1)
    bottleneck = _dense(p, "xyz_final", x)
    cond = condition[:, None, :].expand(n, s, condition.shape[-1]) \
        .reshape(n * s, -1)
    x = torch.relu(_dense(p, "dir", torch.cat([bottleneck, cond], -1)))
    raw_rgb = _dense(p, "static_rgb", x).reshape(n, s, 3)
    return raw_rgb, raw_density


def render(p: Dict[str, torch.Tensor], config: dict, rays: torch.Tensor,
           gen, randomized: bool):
    """MipNerfModel.__call__ over rays (N, 9) [o, d, radius, near, far]:
    [(rgb, distance, acc)] of the two levels, one MLP for both."""
    m, r = config["model"], config["render"]
    origins, directions = rays[:, 0:3], rays[:, 3:6]
    radii, near, far = rays[:, 6:7], rays[:, 7:8], rays[:, 8:9]
    viewdirs = directions / torch.linalg.norm(directions, dim=-1,
                                              keepdim=True)
    ret = []
    t_vals = weights = None
    for i_level in range(m["num_levels"]):
        if i_level == 0:
            t_vals, samples = sample_along_rays(
                origins, directions, radii, r["N_samples"], near, far,
                randomized, gen)
        else:
            t_vals, samples = resample_along_rays(
                origins, directions, radii, t_vals, weights, randomized,
                m["resample_padding"], gen)
        samples_enc = integrated_pos_enc(samples[0], samples[1],
                                         m["min_deg_point"],
                                         m["max_deg_point"])
        viewdirs_enc = pos_enc(viewdirs, m["deg_view"])
        raw_rgb, raw_density = mlp(p, m, samples_enc, viewdirs_enc)
        rgb = torch.sigmoid(raw_rgb)
        rgb = rgb * (1 + 2 * m["rgb_padding"]) - m["rgb_padding"]
        density = softplus(raw_density + m["density_bias"])
        comp_rgb, distance, acc, weights = volumetric_rendering(
            rgb, density, t_vals, directions, r["white_back"])
        ret.append((comp_rgb, distance, acc))
    return ret


def loss(ret, pixels, coarse_loss_mult: float):
    """train_step's loss with lossmult 1: each level's squared error
    summed over rays and channels over the rays' count, the coarse
    levels' times coarse_loss_mult."""
    losses = [((rgb - pixels) ** 2).sum() / pixels.shape[0]
              for rgb, _, _ in ret]
    return coarse_loss_mult * sum(losses[:-1]) + losses[-1]


def learning_rate_decay(step, lr_init, lr_final, max_steps,
                        lr_delay_steps=0, lr_delay_mult=1.0):
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    return delay_rate * log_lerp
