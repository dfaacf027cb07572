"""Rendering test views one after another, as `python -m
nerf_fl_torch.eval` renders a Blender test split: each frame's host rays
through the program's `render_chunked_async` at eval settings (perturb 0,
noise 0, test time), then its `finish()`, which reads the frame's wanted
outputs back to the host.  No image is written or scored in the window.

The check draws frames from the seed among those the run rendered and
renders each again through the reference, in blocks of rays.

Traffic parameters (`traffic/<name>.json`): chunk, inflight, keys (the
outputs read back), views (distinct test views made at set-up and rendered
in turn), warm_frames, check_frames, trace_frames.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import scenes, trace
from benchmark.cell import SAMPLE, SCENE, Cell, sub_seed

CHECK_BLOCK = 8192      # rays a block of the reference render


class Runner(Cell):

    def setup(self):
        c, t, dev = self.config, self.traffic, self.device
        self.mark(None)
        self.cfg = self.render_config().eval_variant()
        self.params = self.program_params()
        self.mark("params")
        self.views = scenes.blender_test_views(
            c, sub_seed(self.seed, SCENE), t["views"], dev)
        n = self.views.shape[1]
        self.ts = np.zeros(n, np.int64)
        self.rays_per_frame = n
        self.chunk = t["chunk"]
        self.chunks_per_frame = -(-n // self.chunk)
        self.outputs = []
        self._plant()
        self.mark("views")
        for _ in range(t["warm_frames"]):
            self.frame()
        self.mark("warm_frames")
        self.outputs = []
        self.attempted = self.failed = 0

    def _plant(self):
        """A fault under the timed path, for the check's own tests:
        'alter' (the first ray of every chunk comes back 1/255 brighter,
        as rendered)."""
        self._restore = None
        if self.fault == "alter":
            from nerf_fl_torch.training import system
            real = system.render_rays

            def altered(*a, **k):
                res = real(*a, **k)
                rgb = res["rgb_fine"].clone()
                rgb[0] += 1.0 / 255
                res["rgb_fine"] = rgb
                return res
            system.render_rays = altered
            self._restore = lambda: setattr(system, "render_rays", real)
        elif self.fault is not None:
            raise ValueError(f"no fault {self.fault!r} for rendering")

    def frame(self, dispatch=None):
        from nerf_fl_torch.training import render_chunked_async
        v = len(self.outputs) % len(self.views)
        t0 = time.perf_counter()
        finish = render_chunked_async(
            self.params, self.views[v], self.ts, self.cfg, chunk=self.chunk,
            inflight=self.traffic["inflight"], test_time=True,
            keys=tuple(self.traffic["keys"]), device=self.device)
        if dispatch is not None:
            dispatch.append(time.perf_counter() - t0)
        out = finish()
        self.outputs.append((v, out))
        self.attempted += 1
        self.failed += not all(np.isfinite(x).all() for x in out.values())

    def window(self, seconds: float) -> Dict[str, float]:
        self.sync()
        t0 = time.perf_counter()
        frames = 0
        while frames == 0 or time.perf_counter() - t0 < seconds:
            self.frame()
            frames += 1
        dt = time.perf_counter() - t0
        return {"frame_ms": 1e3 * dt / frames}

    def traced(self) -> trace.Window:
        n = self.traffic["trace_frames"]

        def work():
            dispatch = []
            for _ in range(n):
                self.frame(dispatch)
            return {"frames": n, "dispatch_s": dispatch}
        return trace.traced(work, self.device)

    def free(self):
        if self._restore:
            self._restore()
        del self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The reference's render of frames drawn from the seed among those
        rendered: the widest gap of a pixel's colour."""
        self.ref.exact_f32()
        rng = np.random.default_rng(sub_seed(self.seed, SAMPLE))
        pick = rng.choice(len(self.outputs),
                          min(self.traffic["check_frames"],
                              len(self.outputs)), replace=False)
        p = self.weights()
        gap = 0.0
        key = self.traffic["keys"][0]
        for i in sorted(pick.tolist()):
            v, out = self.outputs[i]
            rays = torch.as_tensor(self.views[v], device=self.device)
            ts = torch.as_tensor(self.ts, device=self.device)
            ref = []
            with torch.no_grad():
                for a in range(0, rays.shape[0], CHECK_BLOCK):
                    ref.append(self.ref.render(
                        p, self.config, rays[a:a + CHECK_BLOCK],
                        ts[a:a + CHECK_BLOCK], None, test_time=True,
                        perturb=0.0, noise_std=0.0, epoch=0.0)[key])
            ref = torch.cat(ref).cpu().numpy()
            g = float(np.max(np.abs(out[key] - ref)))
            gap = g if not g <= gap else gap
        self.detail = {"frames_checked": sorted(pick.tolist())}
        return self.judged({"rgb_gap": gap if gap == gap else float("inf")})
