"""What a NeRF-A checkpoint's appearance codes learned: the per-code
diagnosis of the quality gate's NeRF-A arm, scored with code 0.

    python -m nerf_fl_torch.experiments.appearance_codes --preset full \\
        --root_dir WS/scene --ckpt seed0_plain=PATH [--ckpt NAME=PATH ...] \\
        [--codes 10] [--out FILE.jsonl] [--device cpu]

For each checkpoint of an arm trained with ``--encode_a`` on the gate's
``color`` data (``tools/quality_gate.py``'s recipe and flags), it renders
the test split, whose rays carry appearance id 0, with:

- each of the codes 0 .. ``codes``-1 and the mean of the training views'
  codes in place of the id's (``render_chunked``'s ``a_override``): the
  test PSNR by code;
- code 0 on the plain MLP path as well (``use_fused=False``), where the
  default is the fused kernels on the card;
- code 0's mean RGB shift from the clean ground truth (all pixels, and the
  object's pixels alone);

and renders the training views 0 .. ``codes``-1 (view 0 is the one
unperturbed view, ``data/blender.py``) with their own codes, against the
images they were trained on: training PSNR and the mean RGB shift of each
view's perturbed image from its clean one.  It also prints the codes'
norms and code 0's distance from the mean code.  It tells whether code 0
drifted from view 0's clean look (training sets the margin) or renders it
(eval does).  One JSON line a checkpoint; ``--out`` appends them to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace

import numpy as np


def _render(params, cfg, sample, code, dev, chunk):
    from ..training.system import render_chunked
    out = render_chunked(params, sample["rays"], sample["ts"], cfg,
                         chunk=chunk, test_time=True, keys=["rgb_fine"],
                         a_override=code, device=dev)
    return np.clip(out["rgb_fine"].reshape(-1, 3), 0.0, 1.0)


def _psnr(pred, gt):
    return float(-10.0 * np.log10(np.mean((pred - gt) ** 2)))


def diagnose(args, name, path, dev):
    import torch
    from ..data import dataset_dict
    from ..eval import build_eval_state
    from ..eval import get_opts as eval_opts
    from ..tools import quality_gate as qg
    from ..training.system import val_chunk_cap

    p = qg.PRESETS[args.preset]
    eargs = eval_opts(qg.common_flags(args.root_dir, p) + [
        "--split", "test", "--ckpt_path", path, "--encode_a"])
    wh = (p["img_wh"], p["img_wh"])
    test = dataset_dict["blender"](args.root_dir, "test", img_wh=wh)
    train = dataset_dict["blender"](args.root_dir, "test_train", img_wh=wh,
                                    perturbation=["color"])
    cfg, params = build_eval_state(eargs, dev, test.white_back)
    chunk = val_chunk_cap(eargs.chunk, eargs.N_samples, eargs.N_importance)
    emb = params["embedding_a"].detach().float()
    n_train = len(train)
    codes = {str(k): emb[k] for k in range(args.codes)}
    codes["mean"] = emb[:n_train].mean(0)
    views = [test[i] for i in range(len(test))]
    row = {"name": name, "ckpt": path, "n_test": len(views),
           "n_train": n_train}

    t0 = time.perf_counter()
    by_code, shift = {}, None
    for key, code in codes.items():
        preds = [_render(params, cfg, v, code, dev, chunk) for v in views]
        by_code[key] = round(float(np.mean(
            [_psnr(pr, v["rgbs"]) for pr, v in zip(preds, views)])), 3)
        if key == "0":
            d = np.concatenate([pr - v["rgbs"] for pr, v in zip(preds, views)])
            m = np.concatenate([v["valid_mask"] for v in views])
            shift = {"all": [round(float(x), 5) for x in d.mean(0)],
                     "object": [round(float(x), 5) for x in d[m].mean(0)]}
    row["test_psnr_by_code"] = by_code
    row["code0_rgb_shift"] = shift
    plain = replace(cfg, use_fused=False)
    row["test_psnr_code0_plain"] = round(float(np.mean(
        [_psnr(_render(params, plain, v, codes["0"], dev, chunk), v["rgbs"])
         for v in views])), 3)

    own, gt_shift = [], []
    for k in range(min(args.codes, n_train)):
        s = train[k]
        own.append(round(_psnr(_render(params, cfg, s, emb[k], dev, chunk),
                               s["rgbs"]), 3))
        clean = s.get("original_rgbs", s["rgbs"])
        gt_shift.append([round(float(x), 5)
                         for x in (s["rgbs"] - clean).mean(0)])
    row["train_psnr_own_code"] = own
    row["train_view_rgb_shift"] = gt_shift
    norms = torch.linalg.vector_norm(emb[:n_train], dim=1)
    row["code_norms"] = {
        "code0": round(float(norms[0]), 5),
        "mean_of_norms": round(float(norms.mean()), 5),
        "code0_to_mean": round(float(torch.linalg.vector_norm(
            emb[0] - codes["mean"])), 5),
        "mean_to_mean": round(float(torch.linalg.vector_norm(
            emb[:n_train] - codes["mean"], dim=1).mean()), 5)}
    row["seconds"] = round(time.perf_counter() - t0, 2)
    return row


def main(argv=None):
    from ..device import entry_device
    from ..tools import quality_gate as qg
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(qg.PRESETS), default="full")
    ap.add_argument("--root_dir", required=True)
    ap.add_argument("--ckpt", action="append", required=True,
                    metavar="NAME=PATH")
    ap.add_argument("--codes", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = entry_device(args.device)
    rows = []
    for item in args.ckpt:
        name, path = item.split("=", 1)
        row = diagnose(args, name, path, dev)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
