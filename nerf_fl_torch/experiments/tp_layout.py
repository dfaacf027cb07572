"""How far tensor parallelism parts from one rank, and why.

    python -m nerf_fl_torch.experiments.tp_layout [--steps 7]

Two ranks share the card over gloo on a data 1 x model 2 mesh
(``parallel.launch``), the flagship NeRF-W (64 + 64 samples, appearance 48,
transient 16, f32, batch 1024, Adam 5e-4) on the plain MLP path, from the
same seed-0 weights and synthetic pool as one rank.  At perturb 1 and at
perturb 0 it prints:
  * one step's gradient, leaf by leaf, against one rank's: max |d| over
    the leaf's largest and ||d|| / ||g||, the leaves that part most first;
    at perturb 0 beside one rank with each batch's rows reversed, which
    changes only the order of the batch's sums and keeps every ray's
    forward (at perturb 1 the draws follow the rows, so no control);
  * the parameters' max |d| against one rank after each of ``steps``
    eager Adam steps, and at the last the leaf and the weight that part
    most, with that weight's first gradient (Adam divides each update by
    |g| + 1e-8, so a gradient near 1e-8 amplifies any rounding).
``chip_smoke.py``'s phase 13 (d) sets its limits from these readings.  The
last line is one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
from types import SimpleNamespace

BATCH = 1024
POOL = 1 << 20
N_VOCAB = 1500
FLAGSHIP = dict(N_samples=64, N_importance=64, encode_a=True, N_a=48,
                encode_t=True, N_tau=16, beta_min=0.1, white_back=True,
                noise_std=0.0, compute_dtype="float32", use_fused=False)


def _pool(dev, gen):
    import torch
    o = torch.randn(POOL, 3, generator=gen, device=dev)
    d = torch.randn(POOL, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(POOL, 1, device=dev)
    return {"rays": torch.cat([o, d, 2 * ones, 6 * ones], 1),
            "ts": torch.randint(0, N_VOCAB, (POOL,), generator=gen,
                                device=dev),
            "rgbs": 0.5 + 0.4 * d}


def _steps(dev, cfg, params, pool, perm, n, mesh=None, reverse=False):
    """``n`` eager Adam steps; the whole gradient of the first and the
    whole parameters after each, on the host."""
    import torch
    from ..parallel import place_params
    from ..parallel.mesh import _shard_dim, param_shardings, whole_params
    from ..training import make_train_step, optimizers
    p = copy.deepcopy(params)
    opt = optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.trainable_parameters(
            p, optimizers.make_trainable_mask(p, False)))
    if mesh is not None:
        place_params(mesh, p, True, opt)
    specs = {} if mesh is None else param_shardings(mesh, p, True)
    step = make_train_step(cfg, opt, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    grads, after = None, []
    for i in range(n):
        idx = perm[i * BATCH:(i + 1) * BATCH].long()
        if reverse:
            idx = idx.flip(0)
        step(p, {k: v.index_select(0, idx) for k, v in pool.items()}, 5e-4,
             generator=gen)
        if grads is None:
            grads = []
            for name, q in optimizers.named_leaves(p):
                dim = _shard_dim(specs.get(name, ()))
                g = q.grad.detach()
                grads.append((name, (g if dim is None else
                                     mesh.model.all_gather(g, dim)).cpu()))
        with whole_params(mesh, p, None, mesh is not None):
            after.append([(name, q.detach().cpu().clone())
                          for name, q in optimizers.named_leaves(p)])
    return grads, after


def _rank(device, perturb, n):
    import torch
    from ..parallel import make_mesh, multihost
    from ..render import RenderConfig
    from ..training import build_params, epoch_perm
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, 2, devices=multihost.job_devices(device))
    cfg = RenderConfig(**FLAGSHIP, perturb=perturb)
    gen = torch.Generator(device=device).manual_seed(0)
    params = build_params(cfg, N_VOCAB, generator=gen, device=device)
    pool = _pool(device, gen)
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(device)
    tp = _steps(device, cfg, params, pool, perm, n, mesh)
    if mesh.rank:
        return None
    one = _steps(device, cfg, params, pool, perm, n)
    rev = _steps(device, cfg, params, pool, perm, 1, reverse=True) \
        if perturb == 0.0 else None
    return tp, one, rev


def _grad_rows(a, b):
    """(name, max |d| / leaf max, ||d|| / ||b||) by leaf."""
    return [(n, float((x - y).abs().max() / (y.abs().max() + 1e-30)),
             float((x - y).norm() / (y.norm() + 1e-30)))
            for (n, x), (_, y) in zip(a, b)]


def main(argv=None):
    import torch
    from ..parallel import launch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_layout needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    out = {"card": card}
    for perturb in (1.0, 0.0):
        (tg, ta), (og, oa), rev = launch.spawn(
            _rank, (perturb, args.steps), devices=[dev, dev],
            timeout=900)[0]
        tp = _grad_rows(tg, og)
        ctl = _grad_rows(rev[0], og) if rev is not None else None
        order = sorted(range(len(tp)), key=lambda i: -tp[i][2])
        print(f"[tp_layout] perturb {perturb:g}: one step's gradient, TP "
              f"against one rank (max |d| / leaf max, ||d|| / ||g||)"
              + ("; one rank with its rows reversed" if ctl else ""))
        for i in order[:6]:
            print(f"[tp_layout]   {tp[i][0]}: {tp[i][1]:.3e} {tp[i][2]:.3e}"
                  + (f"; {ctl[i][1]:.3e} {ctl[i][2]:.3e}" if ctl else ""))
        by_step = [max(float((x - y).abs().max()) for (_, x), (_, y)
                       in zip(a, b)) for a, b in zip(ta, oa)]
        last = [(float((x - y).abs().max()), n, x, y)
                for (n, x), (_, y) in zip(ta[-1], oa[-1])]
        d, name, x, y = max(last, key=lambda r: r[0])
        i = int((x - y).abs().argmax())
        g1 = dict(og)[name].flatten()[i]
        rec = {"grad_max_rel": max(r[1] for r in tp),
               "grad_norm_rel": max(r[2] for r in tp),
               "params_by_step": by_step, "worst_leaf": name,
               "worst_first_grad": float(g1)}
        if ctl:
            rec["control_grad_max_rel"] = max(r[1] for r in ctl)
            rec["control_grad_norm_rel"] = max(r[2] for r in ctl)
        print(f"[tp_layout] perturb {perturb:g}: params max |d| after each "
              f"step {[f'{v:.2e}' for v in by_step]}; at the last, "
              f"{name}[{i}] ({float(x.flatten()[i]):.6e} against "
              f"{float(y.flatten()[i]):.6e}), its first gradient "
              f"{float(g1):.3e}")
        out[f"perturb_{perturb:g}"] = rec
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
