"""What every runner shares: the cell's settings, the program's render
configuration built from the configuration file, the seeded weights loaded
into the program's parameters, the card's peaks, and the comparison of
numbers with their limits."""
from __future__ import annotations

import importlib
import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import spec

# the seeds a run derives from --seed: the weights, the program's draws,
# the batch order, the scene
WEIGHTS, DRAWS, ORDER, SCENE, SAMPLE = range(5)


def sub_seed(seed: int, which: int) -> int:
    """A seed of its own for each use, any whole --seed allowed."""
    return (int(seed) * 8 + which) % (2 ** 62)


class Cell:
    """One run of one cell: `setup`, then `window` (end-to-end metrics) or
    `traced` (a trace.Window), then `free` and `check`."""

    def __init__(self, sp: SimpleNamespace, seed: int, device,
                 compute_dtype: Optional[str] = None,
                 fault: Optional[str] = None):
        self.spec, self.seed = sp, seed
        self.config, self.traffic = sp.config, sp.traffic
        self.device = torch.device(device)
        self.dtype = compute_dtype or self.config["dtype"]
        self.fault = fault
        # the configuration's plain reference, `reference/<name>.py`
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.config['reference']}")
        self.attempted = self.failed = 0
        self.stages: Dict[str, float] = {}
        self._mark = None
        if self.device.type == "cuda":
            pk = spec.peaks(torch.cuda.get_device_name(self.device),
                            self.config["dtype"])
            self.peak_flops, self.peak_bw = pk["flops"], pk["bytes_per_s"]
        else:
            self.peak_flops = self.peak_bw = None

    # -- the program ---------------------------------------------------
    def render_config(self):
        from nerf_fl_torch.render import RenderConfig
        m, r = self.config["model"], self.config["render"]
        b = self.config.get("barf", {})
        return RenderConfig(
            N_samples=r["N_samples"], N_importance=r["N_importance"],
            use_disp=r["use_disp"], perturb=r["perturb"],
            noise_std=r["noise_std"], white_back=r["white_back"],
            N_emb_xyz=m["N_emb_xyz"], N_emb_dir=m["N_emb_dir"],
            encode_a=m["encode_a"], N_a=m["N_a"], encode_t=m["encode_t"],
            N_tau=m["N_tau"], beta_min=m["beta_min"],
            refine_pose=self.config.get("refine_pose", False),
            barf_schedule=b.get("schedule", "fork"),
            barf_epoch_start=b.get("epoch_start", 4),
            barf_epoch_end=b.get("epoch_end", 8),
            compute_dtype=self.dtype, mlp_depth=m["D"], mlp_width=m["W"])

    def program_params(self, init_poses=None):
        """The program's parameters (`build_params`), holding the seeded
        weights of the reference's `make_weights`; raises if the program's leaves and
        the benchmark's differ in name or shape."""
        from nerf_fl_torch.training import build_params
        from nerf_fl_torch.training.optimizers import named_leaves
        cfg = self.render_config()
        gen = torch.Generator(self.device).manual_seed(
            sub_seed(self.seed, WEIGHTS))
        params = build_params(cfg, self.config["model"]["N_vocab"],
                              generator=gen, device=self.device,
                              init_poses=init_poses)
        weights = self.weights()
        leaves = {n: p for n, p in named_leaves(params)
                  if n != "learn_poses.init_c2w"}
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

    def weights(self) -> Dict[str, torch.Tensor]:
        return self.ref.make_weights(self.config,
                                     sub_seed(self.seed, WEIGHTS), self.device)

    def lr(self) -> float:
        """The cosine schedule's lr at the configuration's epoch (eta_min
        1e-8, stepped a whole epoch)."""
        t = self.config["train"]
        e = math.floor(t["epoch"])
        return 1e-8 + (t["lr"] - 1e-8) * (
            1 + math.cos(math.pi * e / t["num_epochs"])) / 2

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, stage: str):
        """Seconds of set-up since the last mark, kept under `stage`
        (the card synchronized first)."""
        import time
        self.sync()
        now = time.perf_counter()
        if self._mark is not None:
            self.stages[stage] = now - self._mark
        self._mark = now

    # -- the check -----------------------------------------------------
    def judged(self, numbers: Dict[str, float]) -> List[Tuple[str, float,
                                                               float]]:
        """(name, value, limit) of every number, in the limits file's
        order; a number without a limit is held to 0."""
        limits = (self.spec.limits or {}).get("numbers", {})
        out = [(n, numbers[n], limits[n]["limit"]) for n in limits
               if n in numbers]
        out += [(n, v, 0.0) for n, v in numbers.items() if n not in limits]
        return out


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: Optional[set] = None) -> Tuple[float, str, float]:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf: (the worst gap,
    its leaf, the median leaf's gap).  A leaf missing on the program's side
    or reading NaN counts as an infinite gap."""
    keep = [n for n in ref if not skip or n not in skip]
    if not keep:
        return float("inf"), "", float("inf")
    med = sorted(ref[n] for n in keep)[len(keep) // 2]
    gaps = {}
    for n in keep:
        g = abs(prog.get(n, float("nan")) - ref[n]) / max(ref[n], med, 1e-30)
        gaps[n] = g if g == g else float("inf")
    at = max(gaps, key=gaps.get)
    return gaps[at], at, sorted(gaps.values())[len(gaps) // 2]
