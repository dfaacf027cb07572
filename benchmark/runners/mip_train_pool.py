"""mip-NeRF training from a ray pool on the card, as `python -m
nerf_fl_torch.train --model mipnerf --device_pool on --steps_per_execution
K` runs it: the program's `make_device_pool_step` over rays [o | d |
radius | near | far] with the mip loss, K sub-steps a call (a CUDA graph
on the card), the lr held at the configuration's step of mip-NeRF's
schedule.  Everything else is `train_pool`'s: the calls, the window, the
traced window, the check's sub-steps and its three numbers, the planted
faults ('frozen', 'half_batch' of the loss "mip").

The program's render configuration is built before anything else, so a
program without mip-NeRF fails within set-up's first seconds.

The pool is the Blender layout of `benchmark/scenes.py` at the recipe's
800 x 800, with mip-NeRF's rays: directions through the pixel centres, not
normalised, and each cone's base radius (`blender_mip_pool`); the targets
are `scenes.texture` of the unit directions.

Traffic parameters (`traffic/<name>.json`): train_pool's.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark import scenes
from benchmark.cell import DRAWS, ORDER, SCENE, norm_gaps, sub_seed
from benchmark.runners import train_pool

BETA1 = 0.9


def pixel_centre_dirs(w: int, h: int, focal: float, device) -> torch.Tensor:
    """(h, w, 3) camera-frame directions [(i + 0.5 - w/2)/f, -(j + 0.5 -
    h/2)/f, -1] through the pixel centres (mip-NeRF's Blender loader)."""
    j, i = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32),
                          indexing="ij")
    return torch.stack([(i + 0.5 - w / 2) / focal, -(j + 0.5 - h / 2) / focal,
                        -torch.ones_like(i)], -1)


def blender_mip_pool(config: dict, seed: int, device) -> Dict[str, object]:
    """Every train ray of the Blender layout as mip-NeRF takes it: 'rays'
    (N, 9) [o, d, radius, near, far] with d the camera direction rotated
    into the world, not normalised, and radius the distance between
    neighbouring rows' directions times 2 / sqrt(12); 'rgbs' (N, 3)."""
    s = config["scene"]
    gen = torch.Generator(device).manual_seed(seed)
    w, h = s["img_wh"]
    c2w = scenes._blender_poses(s, s["n_images"], gen, device)
    cam = pixel_centre_dirs(w, h, scenes.blender_focal(s), device)
    d = torch.einsum("hwc,nrc->nhwr", cam, c2w[:, :3, :3])
    dx = torch.linalg.norm(d[:, :-1] - d[:, 1:], dim=-1)
    radii = torch.cat([dx, dx[:, -2:-1]], 1)[..., None] * 2 / math.sqrt(12)
    del dx
    n = s["n_images"] * w * h
    d = d.reshape(s["n_images"], w * h, 3)
    o = c2w[:, None, :3, 3].expand_as(d)
    rgbs = scenes.texture(o, d / torch.linalg.norm(d, dim=-1, keepdim=True),
                          gen).reshape(n, 3)
    nf = torch.tensor([s["near"], s["far"]], device=device).expand(n, 2)
    rays = torch.cat([o.reshape(n, 3), d.reshape(n, 3), radii.reshape(n, 1),
                      nf], -1)
    return {"pool": {"rays": rays, "rgbs": rgbs}}


class Runner(train_pool.Runner):

    def render_config(self):
        """The program's mip-NeRF at the configuration's sizes; its IPE
        degrees, resampling padding, activations and density noise are the
        program's constants, MipNerfModel's defaults, which the reference
        reads from the configuration."""
        from nerf_fl_torch.render import RenderConfig
        m, r = self.config["model"], self.config["render"]
        return RenderConfig(
            model="mipnerf", N_samples=r["N_samples"], perturb=r["perturb"],
            white_back=r["white_back"], N_emb_dir=m["deg_view"],
            compute_dtype=self.dtype, mlp_depth=m["D"], mlp_width=m["W"])

    def program_params(self, init_poses=None):
        from nerf_fl_torch.training import build_params
        from nerf_fl_torch.training.optimizers import named_leaves
        gen = torch.Generator(self.device).manual_seed(
            sub_seed(self.seed, 0))
        params = build_params(self.render_config(), 1, generator=gen,
                              device=self.device)
        weights = self.weights()
        leaves = dict(named_leaves(params))
        if set(leaves) != set(weights) or any(
                tuple(leaves[n].shape) != tuple(w.shape)
                for n, w in weights.items()):
            raise RuntimeError(
                "the program's parameters are not the configuration's: "
                f"{sorted(set(leaves) ^ set(weights))}")
        with torch.no_grad():
            for n, w in weights.items():
                leaves[n].copy_(w)
        return params

    def lr(self) -> float:
        t = self.config["train"]
        return self.ref.learning_rate_decay(
            t["step"], t["lr_init"], t["lr_final"], t["max_steps"],
            t["lr_delay_steps"], t["lr_delay_mult"])

    def setup(self):
        from nerf_fl_torch.training import make_device_pool_step
        from nerf_fl_torch.training import optimizers as opt
        from nerf_fl_torch.training import system
        c, t, dev = self.config, self.traffic, self.device
        self.mark(None)
        cfg = self.render_config()      # a program without mip-NeRF stops
        self.K = t["steps_per_execution"]
        self.B = c["train"]["batch_size"]
        self.pool = blender_mip_pool(c, sub_seed(self.seed, SCENE),
                                     dev)["pool"]
        self.camdir, self.init_c2w, self.id_to_cam = False, None, None
        self.mark("pool")
        self.params = self.program_params()
        mask = opt.make_trainable_mask(self.params, False)
        hp = type("H", (), {"optimizer": c["train"]["optimizer"],
                            "lr": self.lr(), "weight_decay": 0.0})
        self.optimizer = opt.build_optimizer(
            hp, opt.param_groups(self.params, mask))
        self._plant(system)
        self.step = make_device_pool_step(
            cfg, self.optimizer, batch_size=self.B, loss_name="mip",
            steps_per_execution=self.K)
        self.gen = torch.Generator(dev).manual_seed(sub_seed(self.seed, DRAWS))
        self.order = torch.Generator(dev).manual_seed(
            sub_seed(self.seed, ORDER))
        n_pool = self.pool["rays"].shape[0]
        self.n_steps = n_pool // self.B
        self.perm = torch.randperm(n_pool, generator=self.order, device=dev,
                                   dtype=torch.int32)
        self.epoch, self.lr_now = 0.0, self.lr()
        self.global_step = 0
        self.mark("params_and_step")
        self._first_steps(opt)

    def _first_steps(self, opt):
        """train_pool's first sub-steps through the window's own call and
        feed, what the check keeps of them, and the warm calls."""
        t = self.traffic
        n_check = t["check_steps"]
        m = self.step(self.params, self.pool, self.perm, 0, 1, self.lr_now,
                      self.epoch, self.gen)
        losses = [m["train/loss"][0]]
        self.mark("first_call_and_capture")
        leaves = dict(opt.named_leaves(self.params))
        self.grad_norms = {}
        for n, p in leaves.items():
            st = self.optimizer.state.get(p, {})
            if "exp_avg" in st:
                self.grad_norms[n] = float(st["exp_avg"].norm() / (1 - BETA1))
        m = self.step(self.params, self.pool, self.perm, 1, n_check,
                      self.lr_now, self.epoch, self.gen)
        losses += [m["train/loss"][k] for k in range(n_check - 1)]
        self.losses = [float(v) for v in losses]
        self.after = {n: p.detach().clone() for n, p in leaves.items()}
        rows = self.perm[:n_check * self.B].long()
        self.batches = {k: v.index_select(0, rows).clone()
                        for k, v in self.pool.items()}
        self.i0, self.global_step = n_check, n_check
        self.mark("check_steps")
        for _ in range(t["warm_calls"]):
            self.call()
        self.mark("warm_calls")
        self.attempted = self.failed = 0

    def _plant(self, system):
        """train_pool's faults, the half batch on the mip loss."""
        self._restore = None
        if self.fault == "frozen":
            self.optimizer.step = lambda *a, **k: None
        elif self.fault == "half_batch":
            real = system.loss_dict["mip"]

            def half(results, targets, **kw):
                n = targets.shape[0] // 2
                return real({k: v[:n] for k, v in results.items()},
                            targets[:n], **kw)
            system.loss_dict["mip"] = half
            self._restore = lambda: system.loss_dict.__setitem__("mip", real)
        elif self.fault is not None:
            raise ValueError(f"no fault {self.fault!r} for training")

    def check(self):
        """train_pool's check with mip-NeRF's reference: each sub-step's
        loss (the largest relative gap), the first gradient's norm by leaf
        (the worst leaf's gap) and the norm of the parameters' change after
        the sub-steps by leaf (the median leaf's gap), the reference
        following the same rows and draws.  Leaves whose reference gradient
        is under a thousandth of the median leaf's are left out (the
        biases of glorot's zero start are not among them)."""
        self.ref.exact_f32()
        c, dev, n = self.config, self.device, len(self.losses)
        p0 = self.weights()
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        adam = torch.optim.Adam(list(p.values()), lr=self.lr_now, eps=1e-8)
        gen = torch.Generator(dev).manual_seed(sub_seed(self.seed, DRAWS))
        losses, grads = [], {}
        for s in range(n):
            b = {k: v[s * self.B:(s + 1) * self.B]
                 for k, v in self.batches.items()}
            ret = self.ref.render(p, c, b["rays"], gen,
                                  randomized=c["render"]["perturb"] > 0)
            loss = self.ref.loss(ret, b["rgbs"],
                                 c["train"]["coarse_loss_mult"])
            adam.zero_grad()
            loss.backward()
            if s == 0:
                grads = {k: float(v.grad.norm()) for k, v in p.items()}
            adam.step()
            losses.append(float(loss.detach()))
        med = sorted(grads.values())[len(grads) // 2]
        skip = {k for k, v in grads.items() if v < 1e-3 * med}
        moved_ref = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
        moved_prog = {k: float((self.after[k] - p0[k]).norm()) for k in p0}
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.losses, losses))
        if not all(np.isfinite(self.losses)):
            loss_gap = float("inf")
        grad_gap, grad_at, _ = norm_gaps(self.grad_norms, grads, skip)
        move_worst, move_at, move_gap = norm_gaps(moved_prog, moved_ref, skip)
        self.detail = {"loss_program": self.losses, "loss_reference": losses,
                       "grad_worst_leaf": grad_at,
                       "update_worst_gap": move_worst,
                       "update_worst_leaf": move_at,
                       "leaves_left_out": sorted(skip)}
        return self.judged({"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
                            "update_median_gap": move_gap})
