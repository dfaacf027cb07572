"""Where the f32 fused kernels and their plain version part: ReLU ties.

    python -m nerf_fl_torch.experiments.relu_ties [--n 20000] [--seed 1]
        [--tol 2e-6] [--device cuda]

The f32 kernels take their products as 3xTF32 (``f32_ties.tf32x3_mm``
models them); the plain version (``fused_mlp_reference`` /
``fused_mlp_bwd_reference``) takes them as f32 matrix products.  This
script runs the plain forward and backward of the flagship fine field
(a_dim 48, transient, random weights and points from ``--seed``, a random
(N, 9) cotangent) with three other arithmetics of the same products: the
3xTF32 model, the f32 products summed in the reverse order, and float64
products rounded to f32.  For each it prints how many hidden units' ReLU
decisions differ from the plain f32 forward's, the largest |pre-activation|
difference over all hidden units, the plain pre-activation of the farthest
flipped unit from zero, and the backward's worst max |d| / max |ref| over
every weight grad, bias grad and d_inp, once against the plain backward and
once against ``f32_ties.matched_backward(tol)``, the plain backward with
each tie unit on the side this arithmetic took.  The last line is one JSON
object.  ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    import torch
    from ..models import NeRFConfig, init_nerf
    from ..ops import f32_ties
    from ..ops import fused_mlp as fm

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tol", type=float, default=2e-6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("relu_ties: no CUDA card (--device cpu runs "
                             "on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False

    n, a_dim = args.n, 48
    gen = torch.Generator().manual_seed(args.seed)
    model = init_nerf(NeRFConfig(typ="fine", encode_appearance=True,
                                 in_channels_a=a_dim, encode_transient=True),
                      generator=gen)
    xyz = torch.rand(n, 3, generator=gen) * 6 - 3
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    a = torch.randn(n, a_dim, generator=gen)
    t = torch.randn(n, 16, generator=gen)
    g = torch.zeros(n, 16)
    g[:, :9] = torch.randn(n, 9, generator=gen)
    inp = fm.pack_inputs(xyz, d, a, t).to(dev)
    g = g.to(dev)
    net = fm.pack_weights(model.to(dev),
                          fm.Layout(torch.float32, 10, 4, a_dim, 16))
    sx, sd = fm.default_scale_rows(10, 4, a_dim, device=dev)

    def worst(got, ref):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                    1e-30)
                   for x, y in zip(got[0] + got[1] + [got[2]],
                                   ref[0] + ref[1] + [ref[2]]))

    models = {
        "tf32x3": f32_ties.tf32x3_mm,
        "f32_reversed": lambda x, y: torch.flip(x, [-1]) @ torch.flip(y, [0]),
        "float64": lambda x, y: (x.double() @ y.double()).float(),
    }
    ref_pre = f32_ties.pre_activations(inp, net, sx, sd)
    plain = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    tie_points = int(torch.stack([m.any(1) for m in f32_ties.tie_units(
        inp, net, sx, sd, tol=args.tol).values()]).any(0).sum())
    out = {"n": n, "seed": args.seed, "tol": args.tol,
           "device": str(dev), "tie_points": tie_points, "models": {}}
    print(f"[relu_ties] {n} points, seed {args.seed}: {tie_points} points "
          f"have a hidden pre-activation within {args.tol:g} of 0")
    for name, mm in models.items():
        pre = f32_ties.pre_activations(inp, net, sx, sd, matmul=mm)
        flips = {i: (pre[i] > 0) != (q > 0) for i, q in ref_pre.items()}
        n_flip = sum(int(f.sum()) for f in flips.values())
        far = max([float(ref_pre[i][f].abs().max())
                   for i, f in flips.items() if f.any()] or [0.0])
        delta = max(float((pre[i] - q).abs().max())
                    for i, q in ref_pre.items())
        got = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g, matmul=mm)
        matched, st = f32_ties.matched_backward(got[2], inp, net, sx, sd, g,
                                                tol=args.tol)
        row = {"flipped_units": n_flip, "max_pre_delta": delta,
               "farthest_flip": far, "bwd_worst_rel": worst(got, plain),
               "bwd_worst_rel_matched": worst(got, matched),
               "moved_points": st["moved_points"]}
        out["models"][name] = row
        print(f"[relu_ties] {name}: {n_flip} hidden units flipped (the "
              f"farthest at |pre| {far:.2e}), max |pre-activation "
              f"difference| {delta:.2e}; backward worst max |d| / max "
              f"|ref| {row['bwd_worst_rel']:.2e}, against the matched "
              f"sides {row['bwd_worst_rel_matched']:.2e} "
              f"({st['moved_points']} points moved)")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
