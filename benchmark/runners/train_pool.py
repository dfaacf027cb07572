"""Training from a ray pool on the card, as `python -m nerf_fl_torch.train
--device_pool on --steps_per_execution K` runs it: the program's
`make_device_pool_step` with K sub-steps a call (a CUDA graph on the card),
one call after another, the lr set each call, the metrics read back to the
host at every `log_every`-th sub-step as `fit` reads them.

Set-up builds the pool, the parameters, the optimizer and the step once,
drives the step through its first `check_steps` sub-steps (the first call
runs one sub-step and captures the graph, the second the rest), keeps what
the check needs (each sub-step's loss, the first gradient as Adam's first
moment holds it, the parameters before the next sub-step), and hands the
same step on to the window.  The reference then follows those sub-steps on
the same rows and draws.

Traffic parameters (`traffic/<name>.json`): steps_per_execution, log_every,
check_steps, warm_calls (full calls after the check, before the window),
trace_calls (calls in the traced window).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import scenes, trace
from benchmark.cell import (DRAWS, ORDER, SCENE, Cell, norm_gaps,
                            sub_seed)

BETA1 = 0.9


class Runner(Cell):

    def setup(self):
        from nerf_fl_torch.training import make_device_pool_step
        from nerf_fl_torch.training import optimizers as opt
        from nerf_fl_torch.training import system
        c, t, dev = self.config, self.traffic, self.device
        self.mark(None)
        self.K = t["steps_per_execution"]
        self.B = c["train"]["batch_size"]
        scene = scenes.POOLS[c["scene"]["kind"]](
            c, sub_seed(self.seed, SCENE), dev)
        self.pool = scene["pool"]
        self.camdir = "init_c2w" in scene
        self.init_c2w = scene.get("init_c2w")
        self.id_to_cam = scene.get("id_to_cam")
        self.mark("pool")
        refine = c.get("refine_pose", False)
        self.params = self.program_params(
            self.init_c2w.cpu().numpy() if self.camdir else None)
        mask = opt.make_trainable_mask(self.params, refine)
        for name, p in opt.named_leaves(self.params):
            p.requires_grad_(mask[name])
        hp = type("H", (), {"optimizer": c["train"]["optimizer"],
                            "lr": c["train"]["lr"], "weight_decay": 0.0})
        self.optimizer = opt.build_optimizer(
            hp, opt.param_groups(self.params, mask))
        self._plant(system)
        b = c.get("barf", {})
        self.step = make_device_pool_step(
            self.render_config(), self.optimizer, batch_size=self.B,
            loss_name="nerfw", steps_per_execution=self.K,
            ray_format="camdir" if self.camdir else "world",
            id_to_cam=self.id_to_cam,
            pose_lr_mult=b.get("pose_lr_mult", 1.0),
            pose_warmup_epochs=b.get("pose_warmup_epochs", 0.0))
        self.gen = torch.Generator(dev).manual_seed(sub_seed(self.seed, DRAWS))
        self.order = torch.Generator(dev).manual_seed(
            sub_seed(self.seed, ORDER))
        n_pool = self.pool["rays"].shape[0]
        self.n_steps = n_pool // self.B
        self.perm = torch.randperm(n_pool, generator=self.order, device=dev,
                                   dtype=torch.int32)
        self.epoch, self.lr_now = float(c["train"]["epoch"]), self.lr()
        self.global_step = 0
        self.mark("params_and_step")

        # the first sub-steps, through the window's own call and feed
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
        self.after = {n: p.detach().clone() for n, p in leaves.items()
                      if n != "learn_poses.init_c2w"}
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
        """A fault under the timed path, for the check's own tests:
        'frozen' (the optimizer's step does nothing), 'half_batch' (the
        loss is the mean over the first half of each batch)."""
        self._restore = None
        if self.fault == "frozen":
            self.optimizer.step = lambda *a, **k: None
        elif self.fault == "half_batch":
            real = system.loss_dict["nerfw"]

            def half(results, targets, **kw):
                n = targets.shape[0] // 2
                return real({k: v[:n] for k, v in results.items()},
                            targets[:n], **kw)
            system.loss_dict["nerfw"] = half
            self._restore = lambda: system.loss_dict.__setitem__("nerfw",
                                                                 real)
        elif self.fault is not None:
            raise ValueError(f"no fault {self.fault!r} for training")

    def call(self) -> Dict[str, torch.Tensor]:
        """One call of K sub-steps; a new epoch's order in the same buffer
        when the epoch's rows run out."""
        if self.i0 + self.K > self.n_steps:
            self.perm.copy_(torch.randperm(
                self.perm.numel(), generator=self.order, device=self.device,
                dtype=torch.int32))
            self.i0 = 0
        m = self.step(self.params, self.pool, self.perm, self.i0,
                      self.n_steps, self.lr_now, self.epoch, self.gen)
        g, every = self.global_step, self.traffic["log_every"]
        if g % every == 0 or g % every + self.K > every:
            loss = float(m["train/loss"][self.K - 1])
            self.failed += not np.isfinite(loss)
        self.i0 += self.K
        self.global_step += self.K
        self.attempted += self.K
        return m

    def window(self, seconds: float) -> Dict[str, float]:
        self.sync()
        t0 = time.perf_counter()
        calls = 0
        while calls == 0 or time.perf_counter() - t0 < seconds:
            self.call()
            calls += 1
        self.sync()
        dt = time.perf_counter() - t0
        return {"train_rays_per_s": calls * self.K * self.B / dt}

    def traced(self) -> trace.Window:
        n = self.traffic["trace_calls"]

        def work():
            for _ in range(n):
                self.call()
            return {"sub_steps": n * self.K}
        return trace.traced(work, self.device)

    def free(self):
        if self._restore:
            self._restore()
        del self.step, self.optimizer, self.params, self.pool, self.perm
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------
    def check(self):
        """The reference's first sub-steps on the same rows and draws:
        each sub-step's loss (the largest relative gap), the first
        gradient's norm by leaf (the worst leaf's gap) and the norm of the
        parameters' change after them by leaf (the median leaf's gap: the
        worst leaf's, a bias of 256 values whose near-zero gradients Adam
        turns into whole steps either way, swings from seed to seed and is
        kept in the detail), against the program's.  Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out of both norms."""
        self.ref.exact_f32()
        c, dev, n = self.config, self.device, len(self.losses)
        p0 = self.weights()
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        adam = torch.optim.Adam(list(p.values()), lr=self.lr_now, eps=1e-8)
        gen = torch.Generator(dev).manual_seed(sub_seed(self.seed, DRAWS))
        idmap = None if self.id_to_cam is None else torch.as_tensor(
            self.id_to_cam, device=dev, dtype=torch.int64)
        r = c["render"]
        losses, grads = [], {}
        for s in range(n):
            b = {k: v[s * self.B:(s + 1) * self.B]
                 for k, v in self.batches.items()}
            rays = b["rays"]
            if self.camdir:
                rays = self.ref.posed_rays(p, self.init_c2w,
                                        idmap[b["ts"].long()], rays)
            res = self.ref.render(p, c, rays, b["ts"], gen, test_time=False,
                               perturb=r["perturb"],
                               noise_std=r["noise_std"], epoch=self.epoch)
            loss = self.ref.nerfw_loss(res, b["rgbs"])
            adam.zero_grad()
            loss.backward()
            if s == 0:
                grads = {k: float(v.grad.norm()) for k, v in p.items()}
            adam.step()
            losses.append(float(loss.detach()))
        med = sorted(grads.values())[len(grads) // 2]
        # leaves whose gradient is nought to rounding in the reference
        skip = {k for k, v in grads.items() if v < 1e-3 * med}
        moved_ref = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
        moved_prog = {k: float((self.after[k] - p0[k]).norm())
                      for k in p0}
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
