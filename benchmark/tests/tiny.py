"""Cells of the benchmark cut to a size a CPU test holds: the same
configuration and traffic with a few small views, 8 + 8 samples, a batch
of 32 and 2 sub-steps a call; every width as published."""
from __future__ import annotations

import argparse
import copy

from benchmark import run, spec


def tiny_cell(name: str):
    sp = spec.cell(name)
    c, t = copy.deepcopy(sp.config), copy.deepcopy(sp.traffic)
    c["render"]["N_samples"] = c["render"]["N_importance"] = 8
    c["train"]["batch_size"] = 32
    s = c["scene"]
    if s["kind"] == "blender":
        s["n_images"], s["img_wh"] = 2, [8, 8]
    else:
        s["n_images"], s["sizes"] = 7, [16, 12, 8, 20]
        c["model"]["N_vocab"] = 10
    if t["kind"] == "train_pool":
        t["steps_per_execution"], t["log_every"] = 2, 2
    else:
        t["chunk"], t["views"], t["check_frames"] = 20, 2, 1
    sp.config, sp.traffic = c, t
    return sp


def run_tiny(name: str, seed: int = 2 ** 31 + 11, fault=None,
             compute_dtype=None, device="cpu"):
    """(result, checks) of one run of the tiny cell on `device`, with the
    run's window 0.2 s."""
    ns = argparse.Namespace(workload=name, seed=seed, seconds=0.2, trace=0)
    return run.run_cell(ns, device=device, cell_spec=tiny_cell(name),
                        fault=fault, compute_dtype=compute_dtype, t0=0.0)
