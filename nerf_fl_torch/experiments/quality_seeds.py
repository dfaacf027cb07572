"""How far the quality gate's test PSNRs, and a head's margin over its
plain control, move with the seed and with the initial weights.

    python -m nerf_fl_torch.experiments.quality_seeds --preset full \\
        --arms color_nerf color_nerfa --seeds 1 2 [--init_dir DIR] \\
        [--compute_dtype float32] [--round_grads] \\
        [--train_flag "--use_pallas off"] --workdir DIR [--jobs 2]

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
``--round_grads`` trains with the gradients rounded to bf16 where the JAX
package's bf16 XLA path rounds them (``round_like_xla``): each field
layer's weight gradient, the bias gradients of the layers whose output is
bf16 (all but the f32 heads), and each ray's appearance and transient
embedding cotangents before they are summed into the tables.  It is an
experiment only: the children run ``train_rounded``, which patches the
fused path in their own process and then runs ``nerf_fl_torch.train``.
``--train_flag "FLAGS"`` (repeatable) appends FLAGS to every arm's
training command line, and only to it: ``--use_pallas off`` trains on the
plain MLP path while eval scores with the gate's own flags.  Runs resume
as the gate's do.  The last line is one JSON object: the test PSNR by run
and arm, and each run's margins of ``color_nerfa`` over
``color_nerf`` and ``occ_nerfu`` over ``occ_nerf`` where both arms ran.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..tools import quality_gate as qg

MARGINS = (("color_nerfa", "color_nerf"), ("occ_nerfu", "occ_nerf"))

# field_linears order: the layers whose bias is added in f32 to an f32
# output in the JAX package (models/mlp.py's heads with out_dtype f32),
# whose bias gradient XLA therefore leaves in f32
_F32_HEADS = {9, 11, 16, 17, 18}


class _RoundGrad(torch.autograd.Function):
    """Identity whose backward rounds the cotangent to bf16: the transpose
    of the JAX package's ``astype(bfloat16)`` of a per-ray embedding."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def round_like_xla() -> None:
    """Patch the fused path of this process so that its gradients are
    rounded to bf16 where XLA's bf16 dot transposes round them."""
    from ..ops import fused_mlp as fm
    from ..render import renderer
    unpack, run_mlp = fm.unpack_weight_grads, renderer._run_mlp

    def unpack_rounded(*args, **kwargs):
        out = unpack(*args, **kwargs)
        return [g.to(torch.bfloat16).float()
                if i % 2 == 0 or i // 2 not in _F32_HEADS else g
                for i, g in enumerate(out)]

    def run_mlp_rounded(model, mcfg, cfg, xyz, dirs=None, a_emb=None,
                        t_emb=None, **kwargs):
        a_emb, t_emb = (None if e is None else _RoundGrad.apply(e)
                        for e in (a_emb, t_emb))
        return run_mlp(model, mcfg, cfg, xyz, dirs, a_emb, t_emb, **kwargs)

    fm.unpack_weight_grads = unpack_rounded
    renderer._run_mlp = run_mlp_rounded


def train_rounded(argv) -> None:
    """``nerf_fl_torch.train`` with ``round_like_xla`` applied first."""
    from .. import train
    from ..opt import get_opts
    round_like_xla()
    train.main(get_opts(argv))


def run_arm(ws, scene, p, arm, seed, init, timeout, round_grads=False,
            train_flags=()):
    """Train (unless done) and score one arm; its test PSNR."""
    name, perturb, flags = arm
    logs = os.path.join(ws, "logs")
    os.makedirs(logs, exist_ok=True)
    if not os.path.exists(qg.final_ckpt(ws, p, name)):
        argv = qg.train_argv(ws, scene, p, name, perturb, flags) + [
            "--seed", str(seed)] + list(train_flags)
        if init:
            argv += ["--ckpt_path", os.path.join(init, f"{name}.ckpt")]
        qg.log(f"train {name} (seed {seed}{', init ' + init if init else ''}"
               f"{', rounded grads' if round_grads else ''}"
               f"{', ' + ' '.join(train_flags) if train_flags else ''})")
        module = ["nerf_fl_torch.experiments.quality_seeds",
                  "--train_rounded"] if round_grads else \
            ["nerf_fl_torch.train"]
        qg.run_cmd([sys.executable, "-m"] + module + argv,
                   os.path.join(logs, f"{name}_train.log"), timeout,
                   platform=p.get("platform"), cwd=ws)
    return qg.eval_arm(ws, scene, p, name, flags, timeout)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--train_rounded"]:
        return train_rounded(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(qg.PRESETS), default="full")
    ap.add_argument("--arms", nargs="+", default=["color_nerf",
                                                  "color_nerfa"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--init_dir", default=None)
    ap.add_argument("--compute_dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--round_grads", action="store_true")
    ap.add_argument("--train_flag", action="append", default=[],
                    help='flags appended to each training command, e.g. '
                         '"--use_pallas off"')
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
    train_flags = [t for f in args.train_flag for t in shlex.split(f)]
    tag = "".join("_" + t.lstrip("-") for t in train_flags)
    runs = {f"seed{s}" + ("_init" if init else "")
            + (f"_{args.compute_dtype}" if args.compute_dtype else "")
            + ("_rounded" if args.round_grads else "") + tag: s
            for s in args.seeds}
    jobs = [(run, s, name) for run, s in runs.items() for name in args.arms]

    def one(job):
        run, seed, name = job
        return run, name, run_arm(os.path.join(root, run), scene, p,
                                  arms[name], seed, init, args.arm_timeout,
                                  args.round_grads, train_flags)

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
           "margins": margins, "init_dir": init,
           "round_grads": args.round_grads, "train_flags": train_flags}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
