"""The volume-rendering pipeline: coarse pass -> importance sampling -> fine
pass -> compositing.

Counterpart of ``nerf_fl_tpu/render/renderer.py``.  The result dict is keyed
exactly as the JAX one for every ``test_time`` / ``output_transient``
combination.  Every pass goes through the fused PE + MLP kernels
(``ops/fused_mlp.py``; forward, and backward under autograd) whenever the
tensors are on CUDA and ``fused_mlp.layout_for`` gives the pass a kernel's
layout: the test-time coarse ``sigma_only`` pass the sigma-only kernel's,
the others the fused pair's.  Where it gives none, the plain
``models.mlp.apply_nerf`` runs the pass.

``RenderConfig.model`` "mipnerf" renders mip-NeRF instead (Barron et al.
2021, ``google/mipnerf`` internal/models.py:MipNerfModel; no JAX
counterpart): rays of 9 columns [o, d (not normalised), radius, near,
far], two levels of one shared field (``params["nerf"]``) over cone
intervals, the second over as many intervals resampled from the first's
weights with their gradient stopped (``_render_mip``).  Where ``layout_for``
gives the IPE layout, both levels run the fused pair's IPE kernels
(``fused_mlp.fused_apply_mip``), test time included; otherwise the plain
``apply_nerf``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..core import compositing, cones, encoding, sampling
from ..models.embeddings import embedding_lookup
from ..models.mlp import NeRFConfig, apply_nerf, mip_heads
from ..ops.fused_mlp import (fused_apply_mip, fused_apply_nerf, fused_sigma,
                             grad_needed, layout_for, pack_ipe_inputs)
from ..ops.sorting import rank_merge_sorted
from ..utils.spans import mark

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# mip-NeRF's (MipNerfModel's defaults): IPE degrees 0..16, the resampled
# weights' padding
MIP_IPE_FREQS = 16
MIP_RESAMPLE_PADDING = 0.01


@dataclass(frozen=True)
class RenderConfig:
    """Render/model hyperparameters; field names track the JAX RenderConfig.

    ``use_fused`` is the counterpart of ``use_pallas``: None runs the fused
    kernels whenever the tensors are on CUDA and ``fused_mlp.layout_for``
    gives a layout, True runs them (their plain versions on CPU tensors)
    wherever it gives one, False never runs them.

    ``remat_mlp`` recomputes the plain path's field MLP in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations.  It
    changes nothing on the fused path, whose backward kernel already
    recomputes its forward from the inputs alone.
    """
    N_samples: int = 64
    N_importance: int = 0
    use_disp: bool = False
    perturb: float = 1.0
    noise_std: float = 1.0
    white_back: bool = False
    N_emb_xyz: int = 10
    N_emb_dir: int = 4
    encode_a: bool = False
    N_a: int = 48
    encode_t: bool = False
    N_tau: int = 16
    beta_min: float = 0.1
    refine_pose: bool = False
    barf_epoch_start: int = 4
    barf_epoch_end: int = 8
    barf_schedule: str = "fork"
    compute_dtype: str = "float32"
    use_fused: Optional[bool] = None
    fast_trig: Optional[bool] = None
    remat_mlp: bool = False
    mlp_depth: int = 8
    mlp_width: int = 256
    # "nerf" (nerf_pl's NeRF / NeRF-W) or "mipnerf"
    model: str = "nerf"

    def __post_init__(self):
        if self.model not in ("nerf", "mipnerf"):
            raise ValueError(f"model {self.model!r}")
        if self.model == "mipnerf" and (self.encode_a or self.encode_t
                                        or self.refine_pose):
            raise ValueError("mip-NeRF has no appearance or transient "
                             "embedding and no pose refinement")

    @property
    def use_fast_trig(self) -> bool:
        if self.fast_trig is not None:
            return self.fast_trig
        return self.compute_dtype == "bfloat16"

    @property
    def in_channels_xyz(self) -> int:
        return 6 * self.N_emb_xyz + 3

    @property
    def in_channels_dir(self) -> int:
        return 6 * self.N_emb_dir + 3

    def nerf_config(self, typ: str) -> NeRFConfig:
        if self.model == "mipnerf":
            # one field for both levels: [h, IPE] after layer D / 2
            return NeRFConfig(
                typ="coarse", D=self.mlp_depth, W=self.mlp_width,
                skips=(self.mlp_depth // 2 + 1,), skip_order="hidden_first",
                in_channels_xyz=6 * MIP_IPE_FREQS,
                in_channels_dir=self.in_channels_dir)
        return NeRFConfig(
            typ=typ, D=self.mlp_depth, W=self.mlp_width,
            skips=(self.mlp_depth // 2,),
            in_channels_xyz=self.in_channels_xyz,
            in_channels_dir=self.in_channels_dir,
            encode_appearance=self.encode_a, in_channels_a=self.N_a,
            encode_transient=self.encode_t, in_channels_t=self.N_tau,
            beta_min=self.beta_min)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def eval_variant(self) -> "RenderConfig":
        """Deterministic sampling for validation and eval: perturb 0,
        noise 0."""
        return replace(self, perturb=0.0, noise_std=0.0)


def _embed(cfg: RenderConfig, x, n_freqs, epoch):
    return encoding.embed(
        x, n_freqs, barf=cfg.refine_pose, epoch=epoch,
        epoch_start=cfg.barf_epoch_start, epoch_end=cfg.barf_epoch_end,
        fast=cfg.use_fast_trig, schedule=cfg.barf_schedule)


def _fused_layout(model, mcfg: NeRFConfig, cfg: RenderConfig, x, *,
                  sigma_only=False, transient=False):
    """The kernels' layout for a pass of ``model`` over ``x`` here, or None
    for the plain path: ``use_fused`` (None: on CUDA tensors), whole
    weights (a tensor-parallel model holds a shard of each layer: the plain
    path, as the JAX package's default under a model axis), and
    ``fused_mlp.layout_for``."""
    use_fused = cfg.use_fused if cfg.use_fused is not None \
        else x.device.type == "cuda"
    if getattr(model.xyz[0], "tp", None) is not None:
        if cfg.use_fused:
            raise ValueError("use_fused=True cannot run a tensor-parallel "
                             "(--model_parallel > 1) model: the fused "
                             "kernel needs whole weights")
        return None
    if not use_fused:
        return None
    return layout_for(mcfg, cfg.dtype, sigma_only=sigma_only,
                      needs_grad=grad_needed(model, x), transient=transient)


def _run_mlp(model, mcfg: NeRFConfig, cfg: RenderConfig, xyz, dirs=None,
             a_emb=None, t_emb=None, *, epoch=0.0, sigma_only=False,
             output_transient=False) -> Dict[str, torch.Tensor]:
    """Run the field MLP over a (N_rays, S, 3) sample grid of raw positions;
    per-ray conditioning is broadcast to samples.  Returns (N, S, ...)."""
    N, S = xyz.shape[:2]

    def flat(x):
        return x.reshape(N * S, x.shape[-1])

    def per_sample(x):
        return flat(x[:, None, :].expand(N, S, x.shape[-1]))

    layout = _fused_layout(model, mcfg, cfg, xyz, sigma_only=sigma_only,
                           transient=output_transient)
    bw_x = bw_d = None
    if layout is not None and cfg.refine_pose:
        bw_x, bw_d = (encoding.barf_weights(
            epoch, n, cfg.barf_epoch_start, cfg.barf_epoch_end,
            schedule=cfg.barf_schedule, device=xyz.device)
            for n in (cfg.N_emb_xyz, cfg.N_emb_dir))
    if layout is not None and sigma_only:
        out = fused_sigma(model, layout, flat(xyz), barf_w_xyz=bw_x)
    elif layout is not None:
        out = fused_apply_nerf(
            model, layout, flat(xyz), per_sample(dirs),
            per_sample(a_emb) if a_emb is not None else None,
            per_sample(t_emb) if output_transient else None,
            barf_w_xyz=bw_x, barf_w_dir=bw_d)
    else:
        xyz_emb = flat(_embed(cfg, xyz, cfg.N_emb_xyz, epoch))
        dir_a = None
        if not sigma_only:
            # stays per ray: apply_nerf contracts it per ray and
            # broadcast-adds (models/mlp.py:_dense_ray_cond)
            parts = [_embed(cfg, dirs, cfg.N_emb_dir, epoch)]
            if a_emb is not None:
                parts.append(a_emb)
            dir_a = torch.cat(parts, dim=-1)
        def run(xe, da, te):
            return apply_nerf(model, xe, da, te, sigma_only=sigma_only,
                              output_transient=output_transient,
                              compute_dtype=cfg.dtype, samples_per_ray=S)

        args = (xyz_emb, dir_a, t_emb if output_transient else None)
        if cfg.remat_mlp and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(run, *args,
                                                    use_reentrant=False)
        else:
            out = run(*args)
    return {k: v.reshape((N, S) + v.shape[1:]) for k, v in out.items()}


def _render_mip(params: Dict[str, Any], rays: torch.Tensor,
                cfg: RenderConfig, *, generator=None,
                shard: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
    """mip-NeRF's two levels (``MipNerfModel.__call__``) over rays (N, 9)
    [o, d, radius, near, far]: level 0 on ``N_samples`` stratified
    intervals (``N_samples + 1`` edges in [near, far], jittered when
    ``perturb`` > 0), level 1 on as many intervals resampled from level
    0's weights (``sampling.resample_intervals``), their edges detached.
    Each level casts its intervals' Gaussians (``cones.cast``), runs the
    shared field ``params["nerf"]`` on their IPE and the unit view
    direction's PE, applies ``mip_heads`` and composites
    (``compositing.composite_intervals``); ``noise_std`` is not read (the
    Blender recipe's density noise is 0).  Draws: level 0's jitter, level
    1's uniforms.  Marks: ``sample``, then per level ``cast`` (the
    Gaussians and the kernels' operand rows), ``coarse_mlp`` /
    ``fine_mlp``, ``coarse_composite`` / ``fine_composite``, with ``pdf``
    (the resampling) before level 1's ``cast``."""
    dev = rays.device
    model = params["nerf"]
    mcfg = cfg.nerf_config("mip")
    layout = _fused_layout(model, mcfg, cfg, rays)
    randomized = cfg.perturb > 0
    mark("sample", dev)
    rays_o, rays_d, radii = rays[:, 0:3], rays[:, 3:6], rays[:, 6:7]
    near, far = rays[:, 7:8], rays[:, 8:9]
    t_vals = sampling.stratified_z_vals(
        near, far, cfg.N_samples + 1, perturb=cfg.perturb,
        generator=generator, shard=shard)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    n_rays, S = rays.shape[0], cfg.N_samples
    results: Dict[str, torch.Tensor] = {}
    weights = None
    for level in ("coarse", "fine"):
        if level == "fine":
            mark("pdf", dev)
            t_vals = sampling.resample_intervals(
                t_vals, weights, MIP_RESAMPLE_PADDING, randomized,
                generator=generator, shard=shard).detach()
        mark("cast", dev)
        mean, var = cones.cast(t_vals, rays_o, rays_d, radii)
        if layout is not None:
            operand = pack_ipe_inputs(
                mean.reshape(-1, 3),
                viewdirs[:, None, :].expand(n_rays, S, 3).reshape(-1, 3),
                var.reshape(-1, 3)).contiguous()
        else:
            operand = encoding.integrated_pos_enc(
                mean, var, MIP_IPE_FREQS, fast=cfg.use_fast_trig).reshape(
                    n_rays * S, -1)
        mark(f"{level}_mlp", dev)
        if layout is not None:
            raw = fused_apply_mip(model, layout, operand)
        else:
            dir_emb = encoding.embed(viewdirs, cfg.N_emb_dir,
                                     fast=cfg.use_fast_trig)
            raw = apply_nerf(model, operand, dir_emb, compute_dtype=cfg.dtype,
                             samples_per_ray=S, raw=True)
        sigma, rgb = mip_heads(raw["raw_sigma"].reshape(n_rays, S),
                               raw["raw_rgb"].reshape(n_rays, S, 3))
        mark(f"{level}_composite", dev)
        comp = compositing.composite_intervals(
            t_vals, rgb, sigma, rays_d, white_back=cfg.white_back)
        weights = comp.weights
        results[f"rgb_{level}"] = comp.rgb
        results[f"depth_{level}"] = comp.distance
        results[f"opacity_{level}"] = comp.acc
        results[f"weights_{level}"] = comp.weights
    return results


def render_rays(params: Dict[str, Any], rays: torch.Tensor, ts: torch.Tensor,
                cfg: RenderConfig, *, generator: Optional[torch.Generator] = None,
                epoch=0.0, test_time: bool = False,
                output_transient: bool = True,
                a_embedded: Optional[torch.Tensor] = None,
                t_embedded: Optional[torch.Tensor] = None,
                shard: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
    """Render a batch of rays.

    params: {'nerf_coarse', ['nerf_fine'], ['embedding_a'], ['embedding_t']}
    (NeRF modules and (N_vocab, dim) tables); rays (N_rays, 8) = [o, d,
    near, far]; ts (N_rays,) image ids.  ``generator`` drives the stochastic
    draws (perturb > 0, noise_std > 0).  test_time runs the coarse pass
    sigma-only and adds the static/transient decomposition maps;
    output_transient=False disables the transient field; a_embedded /
    t_embedded override the embedding lookups.  ``shard`` = (index, count)
    marks the rays as rows [index * N, (index + 1) * N) of a batch of
    count * N rays that ranks render in parts: every stochastic draw is
    made at that batch's shape and these rows kept
    (``sampling.draw_rows``), so the draws do not depend on the layout.

    On the card each stage starts with a device mark (``utils/spans.py``):
    ``sample``, ``coarse_mlp``, ``coarse_composite``, ``pdf`` (the fine
    samples and their positions), ``fine_mlp`` (with the embedding
    lookups) and ``fine_composite`` (with the solo fields' composites).

    ``cfg.model`` "mipnerf": ``_render_mip`` over (N_rays, 9) rays; ``ts``
    may be None, and ``test_time``, ``output_transient`` and the embedding
    overrides change nothing (both levels render fully).
    """
    if cfg.model == "mipnerf":
        return _render_mip(params, rays, cfg, generator=generator,
                           shard=shard)
    dev = rays.device
    mark("sample", dev)
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]

    z_vals = sampling.stratified_z_vals(
        near, far, cfg.N_samples, use_disp=cfg.use_disp, perturb=cfg.perturb,
        generator=generator, shard=shard)
    xyz_coarse = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]

    results: Dict[str, torch.Tensor] = {}
    ccfg = cfg.nerf_config("coarse")
    # without a fine model the coarse pass renders fully even at test time
    mark("coarse_mlp", dev)
    if test_time and cfg.N_importance > 0:
        out = _run_mlp(params["nerf_coarse"], ccfg, cfg, xyz_coarse,
                       epoch=epoch, sigma_only=True)
        mark("coarse_composite", dev)
        comp = compositing.composite_static(
            z_vals, None, out["static_sigma"], noise_std=0.0,
            white_back=cfg.white_back, weights_only=True)
        results["weights_coarse"] = comp.weights
        results["opacity_coarse"] = comp.opacity
    else:
        out = _run_mlp(params["nerf_coarse"], ccfg, cfg, xyz_coarse, rays_d,
                       epoch=epoch)
        mark("coarse_composite", dev)
        comp = compositing.composite_static(
            z_vals, out["static_rgb"], out["static_sigma"],
            noise_std=cfg.noise_std, generator=generator,
            white_back=cfg.white_back, shard=shard)
        results["weights_coarse"] = comp.weights
        results["opacity_coarse"] = comp.opacity
        results["rgb_coarse"] = comp.rgb
        results["depth_coarse"] = comp.depth

    if cfg.N_importance == 0:
        return results

    mark("pdf", dev)
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    inner_weights = results["weights_coarse"][:, 1:-1].detach()
    z_fine = sampling.sample_pdf(z_mid, inner_weights, cfg.N_importance,
                                 det=(cfg.perturb == 0), generator=generator,
                                 shard=shard)
    z_vals = rank_merge_sorted(z_vals, z_fine)
    xyz_fine = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]

    mark("fine_mlp", dev)
    fcfg = cfg.nerf_config("fine")
    a_emb = None
    if fcfg.encode_appearance:
        a_emb = a_embedded if a_embedded is not None else \
            embedding_lookup(params["embedding_a"], ts)
    do_transient = output_transient and fcfg.encode_transient
    t_emb = None
    if do_transient:
        t_emb = t_embedded if t_embedded is not None else \
            embedding_lookup(params["embedding_t"], ts)

    out = _run_mlp(params["nerf_fine"], fcfg, cfg, xyz_fine, rays_d,
                   a_emb=a_emb, t_emb=t_emb, output_transient=do_transient,
                   epoch=epoch)

    mark("fine_composite", dev)
    if do_transient:
        comp = compositing.composite_transient(
            z_vals, out["static_rgb"], out["static_sigma"],
            out["transient_rgb"], out["transient_sigma"],
            out["transient_beta"], beta_min=cfg.beta_min,
            white_back=cfg.white_back)
        results["weights_fine"] = comp.weights
        results["opacity_fine"] = comp.opacity
        results["transient_sigmas"] = out["transient_sigma"]
        results["beta"] = comp.beta
        results["_rgb_fine_static"] = comp.static_rgb
        results["_rgb_fine_transient"] = comp.transient_rgb
        results["rgb_fine"] = comp.rgb
        results["depth_fine"] = comp.depth
        if test_time:
            rgb_s, depth_s = compositing.composite_solo_field(
                z_vals, out["static_rgb"], out["static_sigma"],
                white_back=cfg.white_back, combined_opacity=comp.opacity)
            results["rgb_fine_static"] = rgb_s
            results["depth_fine_static"] = depth_s
            rgb_t, depth_t = compositing.composite_solo_field(
                z_vals, out["transient_rgb"], out["transient_sigma"],
                white_back=False)
            results["rgb_fine_transient"] = rgb_t
            results["depth_fine_transient"] = depth_t
    else:
        comp = compositing.composite_static(
            z_vals, out["static_rgb"], out["static_sigma"],
            noise_std=cfg.noise_std, generator=generator,
            white_back=cfg.white_back, shard=shard)
        results["weights_fine"] = comp.weights
        results["opacity_fine"] = comp.opacity
        results["rgb_fine"] = comp.rgb
        results["depth_fine"] = comp.depth

    return results
