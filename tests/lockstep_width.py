"""The quality gate's NeRF-A arm trained in lockstep, port against JAX, at
the gate's width, on the CPU: an experiment, too slow for tier 1.

    python -m tests.lockstep_width [--steps 200] [--workdir DIR] \\
        [--out FILE.jsonl] [--threads 4]

``tests/test_torch_lockstep.py::test_lockstep_nerfa_arm`` holds the two
packages' steps together for 20 narrow steps.  This runs the same
comparison at the ``full`` preset's shapes: depth 8, width 256, 64 + 64
samples, appearance 48 (no transient head), f32, the plain MLP path of both
packages, on the ``full`` fixture's rays (``tools/quality_gate.py``'s
scene: 100 textured views at 200 x 200 with the ``color`` perturbation,
N_vocab 100), Adam at 5e-4, ``perturb`` 0 and ``noise_std`` 0 so that the
two packages draw nothing.  Both start from the JAX package's initial
weights at PRNGKey(0) and take the same batches (the port's
``RayBatcher``, seed 0).  Each step writes one JSON line: both losses and
PSNRs, the norm of the difference between the two packages' embedding row
0 (appearance code 0, the code the gate scores NeRF-A with) and how far
each moved it from its start; every 50 steps also the largest and mean
difference of every parameter leaf.  The file's limits: metrics rtol 2e-3
/ atol 2e-5, parameters 2e-3 max and 1e-4 mean per leaf (over 20 steps).

What f32 drift alone does over as many steps is measured beside it: a
second port run (the control) takes the same
step from the same weights on the same batches with their rows in another
(fixed) order, which is the same step in exact arithmetic and sums every
reduction over rays in another order in f32; each line also holds its
loss and its code 0's distance from the first port run's.  A port step
that differs from JAX's parts from JAX faster than the control parts from
the port.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tests.conftest  # noqa: E402,F401  (the JAX CPU setup of the tests)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nerf_fl_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from nerf_fl_tpu.training import optimizers as jopt  # noqa: E402
from nerf_fl_tpu.training import system as jsys  # noqa: E402
from nerf_fl_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from nerf_fl_torch.data import RayBatcher  # noqa: E402
from nerf_fl_torch.data.blender import BlenderDataset  # noqa: E402
from nerf_fl_torch.render import RenderConfig  # noqa: E402
from nerf_fl_torch.tools import quality_gate as qg  # noqa: E402
from nerf_fl_torch.training import optimizers, system  # noqa: E402

LR = 5e-4
BATCH = 256


def leaf_diffs(jp, tp):
    """{leaf path: (max, mean) of |JAX - port|}; the trees share their
    structure (the bridge's layout)."""
    got = jax.tree_util.tree_leaves(to_numpy_tree(tp))
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp), got):
        d = np.abs(np.asarray(a) - b)
        out[jax.tree_util.keystr(path)] = (float(d.max()), float(d.mean()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "lockstep_width"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    p = qg.PRESETS["full"]
    scene = qg.ensure_fixture(args.workdir, p)
    ds = BlenderDataset(scene, "train", img_wh=(p["img_wh"], p["img_wh"]),
                        perturbation=["color"])
    kw = dict(N_samples=p["samples"][0], N_importance=p["samples"][1],
              mlp_depth=p["mlp"][0], mlp_width=p["mlp"][1], encode_a=True,
              encode_t=False, white_back=True, perturb=0.0, noise_std=0.0,
              compute_dtype="float32")
    jcfg, tcfg = JRenderConfig(use_pallas=False, **kw), \
        RenderConfig(use_fused=False, **kw)
    n_vocab = 100
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, n_vocab)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    h = types.SimpleNamespace(optimizer="adam", lr=LR, weight_decay=0.0)
    tx = jopt.build_optimizer(h)
    jstep = jax.jit(jsys.make_train_step(
        jcfg, tx, jopt.make_trainable_mask(jp, False), donate=False))
    opt_state = tx.init(jp)
    opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        tp, optimizers.make_trainable_mask(tp, False)))
    tstep = system.make_train_step(tcfg, opt)
    cp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rows = torch.from_numpy(np.random.default_rng(1).permutation(BATCH))
    copt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        cp, optimizers.make_trainable_mask(cp, False)))
    cstep = system.make_train_step(tcfg, copt)
    batcher = RayBatcher(ds.all_rays, ds.all_ts, ds.all_rgbs, BATCH,
                         seed=0)
    batches = itertools.chain.from_iterable(batcher.epoch(e) for e in
                                            itertools.count())
    emb0 = np.asarray(jp["embedding_a"])[0].copy()
    out = open(args.out, "w") if args.out else None
    t0 = time.perf_counter()
    worst = {"loss_rel": 0.0, "emb0": 0.0, "loss_rel_control": 0.0,
             "emb0_control": 0.0}
    for i in range(args.steps):
        b = next(batches)
        jp, opt_state, jm = jstep(jp, opt_state,
                                  {k: jnp.asarray(v) for k, v in b.items()},
                                  jnp.float32(LR), jnp.float32(0.0),
                                  jax.random.PRNGKey(i))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        tm = tstep(tp, tb, LR)
        je0 = np.asarray(jp["embedding_a"])[0]
        te0 = tp["embedding_a"].detach()[0].numpy()
        row = {"step": i + 1,
               "loss_jax": float(jm["train/loss"]),
               "loss_port": float(tm["train/loss"]),
               "psnr_jax": float(jm["train/psnr"]),
               "psnr_port": float(tm["train/psnr"]),
               "emb0_diff": float(np.linalg.norm(je0 - te0)),
               "emb0_moved_jax": float(np.linalg.norm(je0 - emb0)),
               "emb0_moved_port": float(np.linalg.norm(te0 - emb0)),
               "seconds": round(time.perf_counter() - t0, 1)}
        cm = cstep(cp, {k: v[rows] for k, v in tb.items()}, LR)
        row["loss_control"] = float(cm["train/loss"])
        row["emb0_diff_control"] = float(np.linalg.norm(
            cp["embedding_a"].detach()[0].numpy() - te0))
        for key, a, b in (("loss_rel", "loss_port", "loss_jax"),
                          ("loss_rel_control", "loss_control",
                           "loss_port")):
            worst[key] = max(worst[key], abs(row[a] - row[b]) / abs(row[b]))
        worst["emb0"] = max(worst["emb0"], row["emb0_diff"])
        worst["emb0_control"] = max(worst["emb0_control"],
                                    row["emb0_diff_control"])
        if (i + 1) % 50 == 0 or i + 1 == args.steps:
            d = leaf_diffs(jp, tp)
            row["leaf_max"] = max(v[0] for v in d.values())
            row["leaf_mean_max"] = max(v[1] for v in d.values())
            row["leaf_worst"] = max(d, key=lambda k: d[k][0])
            c = leaf_diffs(to_numpy_tree(cp), tp)
            row["leaf_max_control"] = max(v[0] for v in c.values())
            row["leaf_mean_max_control"] = max(v[1] for v in c.values())
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    print(json.dumps({"steps": args.steps, "batch": BATCH,
                      **{f"worst_{k}": v for k, v in worst.items()}}))


if __name__ == "__main__":
    main()
