"""How far the quality gate's test PSNRs, and a head's margin over its
plain control, move with the seed and with the initial weights.

    python -m nerf_fl_torch.experiments.quality_seeds --preset full \\
        --arms color_nerf color_nerfa --seeds 1 2 [--init_dir DIR] \\
        [--compute_dtype float32] --workdir DIR [--jobs 2]

Each (seed, arm) trains through ``python -m nerf_fl_torch.train`` with the
gate's recipe (``tools/quality_gate.py``'s ``train_argv``) and ``--seed
S``, which draws the initial weights, the batch order and the sampling
noise, and scores its test split through ``python -m nerf_fl_torch.eval``
as the gate does.  With ``--init_dir``, each arm starts instead from
``DIR/<arm>.ckpt`` (weights only, loaded non-strictly through
``--ckpt_path``), e.g. the JAX package's initial weights of that arm,
written by ``nerf_fl_tpu.training.system.build_params(PRNGKey(seed), cfg,
N_vocab)`` and ``checkpoints.save_checkpoint``, so that only the sampling
noise and the arithmetic differ from a JAX run at that seed.
``--compute_dtype`` replaces the preset's (bf16 against f32 on the card).
Runs resume as the gate's do.  The last line is one JSON object: the test
PSNR by run and arm, and each run's margins of ``color_nerfa`` over
``color_nerf`` and ``occ_nerfu`` over ``occ_nerf`` where both arms ran.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

from ..tools import quality_gate as qg

MARGINS = (("color_nerfa", "color_nerf"), ("occ_nerfu", "occ_nerf"))


def run_arm(ws, scene, p, arm, seed, init, timeout):
    """Train (unless done) and score one arm; its test PSNR."""
    name, perturb, flags = arm
    logs = os.path.join(ws, "logs")
    os.makedirs(logs, exist_ok=True)
    if not os.path.exists(qg.final_ckpt(ws, p, name)):
        argv = qg.train_argv(ws, scene, p, name, perturb, flags) + [
            "--seed", str(seed)]
        if init:
            argv += ["--ckpt_path", os.path.join(init, f"{name}.ckpt")]
        qg.log(f"train {name} (seed {seed}{', init ' + init if init else ''})")
        qg.run_cmd([sys.executable, "-m", "nerf_fl_torch.train"] + argv,
                   os.path.join(logs, f"{name}_train.log"), timeout,
                   platform=p.get("platform"), cwd=ws)
    return qg.eval_arm(ws, scene, p, name, flags, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(qg.PRESETS), default="full")
    ap.add_argument("--arms", nargs="+", default=["color_nerf",
                                                  "color_nerfa"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--init_dir", default=None)
    ap.add_argument("--compute_dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--arm_timeout", type=float, default=7200)
    args = ap.parse_args(argv)

    p = qg.PRESETS[args.preset]
    if args.compute_dtype:
        p = dict(p, dtype=args.compute_dtype)
    arms = {a[0]: a for a in qg.ARMS}
    root = os.path.abspath(args.workdir)
    scene = qg.ensure_fixture(root, p)
    init = os.path.abspath(args.init_dir) if args.init_dir else None
    runs = {f"seed{s}" + ("_init" if init else "")
            + (f"_{args.compute_dtype}" if args.compute_dtype else ""): s
            for s in args.seeds}
    jobs = [(run, s, name) for run, s in runs.items() for name in args.arms]

    def one(job):
        run, seed, name = job
        return run, name, run_arm(os.path.join(root, run), scene, p,
                                  arms[name], seed, init, args.arm_timeout)

    psnr = {run: {} for run in runs}
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        for run, name, value in pool.map(one, jobs):
            psnr[run][name] = value
    margins = {run: {f"{a}_minus_{b}": round(v[a] - v[b], 2)
                     for a, b in MARGINS if a in v and b in v}
               for run, v in psnr.items()}
    for run in runs:
        print(f"{run}: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     psnr[run].items())
              + "; " + ", ".join(f"{k} {v:+.2f}" for k, v in
                                 margins[run].items()))
    out = {"preset": args.preset, "dtype": p["dtype"], "psnr": psnr,
           "margins": margins, "init_dir": init}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
