"""PSNR-regression flow of the reference's golden notebooks, as a script.

Reproduces test_nerfa_color / test_nerfu_occ / test_nerfw_all /
test_phototourism .ipynb: load a trained checkpoint (the port's or the JAX
package's) per submodule, rebuild the perturbed dataset, render chosen
test_train and val views at test time, print per-image PSNR, and save
[GT | pred | depth] grids plus the static / transient decomposition row
([static | transient | beta]) for transient models.  For perturbed
Blender views it also reports the masked static PSNR against the
unperturbed ground truth (the notebooks' decomposition check).

    python -m nerf_fl_torch.notebooks.psnr_regression --root_dir <lego> \\
        --encode_a --encode_t --data_perturb color occ \\
        --ckpt_path ckpts/exp/epoch=19.ckpt

The four family wrappers (``test_nerfa_color`` etc.) preset the flags.
It runs on the card; ``NERF_FL_TORCH_DEVICE=cpu`` or ``main(argv,
device="cpu")`` asks for the CPU.
"""
import argparse
import os

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument('--root_dir', required=True)
    p.add_argument('--dataset_name', default='blender',
                   choices=['blender', 'phototourism'])
    p.add_argument('--data_perturb', nargs='+', default=[],
                   help='blender perturbations used in training '
                        '(color / occ)')
    p.add_argument('--img_wh', nargs='+', type=int, default=[200, 200])
    p.add_argument('--img_downscale', type=int, default=2)
    p.add_argument('--N_emb_xyz', type=int, default=10)
    p.add_argument('--N_emb_dir', type=int, default=4)
    p.add_argument('--N_samples', type=int, default=64)
    p.add_argument('--N_importance', type=int, default=64)
    p.add_argument('--use_disp', action='store_true')
    p.add_argument('--N_vocab', type=int, default=100)
    p.add_argument('--encode_a', action='store_true')
    p.add_argument('--N_a', type=int, default=48)
    p.add_argument('--encode_t', action='store_true')
    p.add_argument('--N_tau', type=int, default=16)
    p.add_argument('--beta_min', type=float, default=0.1)
    p.add_argument('--chunk', type=int, default=32 * 1024)
    p.add_argument('--ckpt_path', required=True)
    p.add_argument('--train_views', nargs='+', type=int, default=[1],
                   help='test_train view indices (0 is never perturbed)')
    p.add_argument('--val_views', nargs='+', type=int, default=[0])
    p.add_argument('--compute_dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--out', default='psnr_regression')
    return p


def grid(imgs):
    """Images side by side, zero-padded to the tallest."""
    h = max(i.shape[0] for i in imgs)
    return np.hstack([np.pad(i, ((0, h - i.shape[0]), (0, 0), (0, 0)))
                      for i in imgs])


def to_u8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def dataset_kwargs(args, split):
    kwargs = {'root_dir': args.root_dir, 'split': split}
    if args.dataset_name == 'blender':
        kwargs['img_wh'] = tuple(args.img_wh)
        kwargs['perturbation'] = args.data_perturb
    else:
        kwargs['img_downscale'] = args.img_downscale
    return kwargs


def sample_wh(args, sample):
    if args.dataset_name == 'blender' or 'img_wh' not in sample:
        return tuple(args.img_wh)
    return tuple(int(x) for x in sample['img_wh'])


def render_view(params, cfg, sample, wh, chunk, transient, device):
    from ..training.system import render_chunked
    keys = ['rgb_fine', 'depth_fine', 'rgb_coarse', 'depth_coarse']
    if transient:
        keys += ['rgb_fine_static', 'rgb_fine_transient', 'beta']
    res = render_chunked(params, sample['rays'], sample['ts'], cfg,
                         chunk=chunk, test_time=True, keys=keys,
                         device=device)
    w, h = wh
    typ = 'fine' if 'rgb_fine' in res else 'coarse'
    return {k: v.reshape((h, w) + v.shape[1:]) for k, v in res.items()}, typ


def evaluate_split(args, params, cfg, split, indices, out_dir, report,
                   device):
    import torch
    from ..data import dataset_dict
    from ..data.image_io import write_png
    from ..training.metrics import psnr as psnr_fn
    from ..utils.visualization import visualize_depth

    dataset = dataset_dict[args.dataset_name](**dataset_kwargs(args, split))
    for idx in indices:
        if idx >= len(dataset):
            print(f'[skip] {split}[{idx}]: split has {len(dataset)} views')
            continue
        sample = dataset[idx]
        wh = sample_wh(args, sample)
        res, typ = render_view(params, cfg, sample, wh, args.chunk,
                               args.encode_t, device)
        w, h = wh
        gt = sample['rgbs'].reshape(h, w, 3)
        pred = np.clip(res[f'rgb_{typ}'], 0, 1)
        p = float(psnr_fn(torch.from_numpy(gt), torch.from_numpy(pred)))
        report.append((f'{split}[{idx}] PSNR', p))
        print(f'{split}[{idx}] PSNR between GT and pred: {p:.2f}')

        depth = visualize_depth(res[f'depth_{typ}']).transpose(1, 2, 0)
        write_png(os.path.join(out_dir, f'{split}_{idx}_gt_pred_depth.png'),
                  to_u8(grid([gt, pred, depth])))

        if args.encode_t and 'rgb_fine_static' in res:
            static = np.clip(res['rgb_fine_static'], 0, 1)
            trans = np.clip(res['rgb_fine_transient'], 0, 1)
            beta = res['beta']
            beta_viz = np.repeat(
                ((beta - beta.min()) / max(np.ptp(beta), 1e-8))[..., None],
                3, -1)
            write_png(
                os.path.join(out_dir, f'{split}_{idx}_decomposition.png'),
                to_u8(grid([static, trans, beta_viz])))
            if 'original_rgbs' in sample:
                # masked static PSNR against the unperturbed ground truth
                ogt = sample['original_rgbs'].reshape(h, w, 3)
                mask = sample['original_valid_mask'].reshape(h, w)
                ps = float(psnr_fn(torch.from_numpy(ogt),
                                   torch.from_numpy(static),
                                   valid_mask=torch.from_numpy(mask)))
                report.append((f'{split}[{idx}] static PSNR (masked)', ps))
                print(f'{split}[{idx}] PSNR between static pred and '
                      f'unperturbed GT (masked): {ps:.2f}')


def main(argv=None, device=None):
    """Returns {name: PSNR} of every view scored."""
    from ..device import entry_device
    from ..eval import build_eval_state
    args = get_parser().parse_args(argv)
    dev = entry_device(device)
    cfg, params = build_eval_state(args, dev,
                                   args.dataset_name == 'blender')
    os.makedirs(args.out, exist_ok=True)
    report = []
    evaluate_split(args, params, cfg, 'test_train', args.train_views,
                   args.out, report, dev)
    evaluate_split(args, params, cfg, 'val', args.val_views, args.out,
                   report, dev)
    print('\n== summary ==')
    for name, v in report:
        print(f'{name}: {v:.2f}')
    return dict(report)


if __name__ == '__main__':
    main()
