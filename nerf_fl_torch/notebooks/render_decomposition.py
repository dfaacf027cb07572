"""Render GT | prediction | depth (and the static / transient
decomposition of NeRF-W checkpoints) for one view: the script of the
reference's test_nerf*_*.ipynb golden notebooks.

    python -m nerf_fl_torch.notebooks.render_decomposition \\
        --root_dir <lego> --dataset_name blender --img_wh 200 200 \\
        --split val --idx 0 --N_importance 64 --encode_a --encode_t \\
        --N_vocab 100 --ckpt_path ckpts/exp/epoch=19.ckpt --out out_decomp

Writes pred.png, depth.png, gt.png (where the view has ground truth, with
its PSNR printed) and, for a transient model, static.png and
transient.png into --out.  It runs on the card;
``NERF_FL_TORCH_DEVICE=cpu`` or ``main(argv, device="cpu")`` asks for the
CPU.
"""
import argparse
import os

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument('--root_dir', required=True)
    p.add_argument('--dataset_name', default='blender',
                   choices=['blender', 'phototourism'])
    p.add_argument('--split', default='val')
    p.add_argument('--idx', type=int, default=0)
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
    p.add_argument('--refine_pose', action='store_true')
    p.add_argument('--chunk', type=int, default=32 * 1024)
    p.add_argument('--ckpt_path', required=True)
    p.add_argument('--compute_dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--out', default='decomposition')
    return p


def main(argv=None, device=None):
    """Returns the view's PSNR (None without ground truth)."""
    import torch
    from ..data import dataset_dict
    from ..data.image_io import write_png
    from ..device import entry_device
    from ..eval import build_eval_state
    from ..training.metrics import psnr as psnr_fn
    from ..training.system import render_chunked
    from ..utils.visualization import visualize_depth
    from .psnr_regression import to_u8

    args = get_parser().parse_args(argv)
    dev = entry_device(device)
    kwargs = {'root_dir': args.root_dir, 'split': args.split}
    if args.dataset_name == 'blender':
        kwargs['img_wh'] = tuple(args.img_wh)
    else:
        kwargs['img_downscale'] = args.img_downscale
    dataset = dataset_dict[args.dataset_name](**kwargs)
    cfg, params = build_eval_state(args, dev, dataset.white_back)

    sample = dataset[args.idx]
    res = render_chunked(params, sample['rays'], sample['ts'], cfg,
                         chunk=args.chunk, test_time=True, device=dev)
    if 'img_wh' in sample:
        w, h = (int(x) for x in sample['img_wh'])
    else:
        w, h = args.img_wh

    os.makedirs(args.out, exist_ok=True)

    def save(name, img):
        write_png(os.path.join(args.out, name), to_u8(img))

    typ = 'fine' if args.N_importance > 0 else 'coarse'
    pred = np.clip(res[f'rgb_{typ}'].reshape(h, w, 3), 0, 1)
    save('pred.png', pred)
    save('depth.png',
         visualize_depth(res[f'depth_{typ}'].reshape(h, w)).transpose(1, 2, 0))
    psnr = None
    if 'rgbs' in sample:
        gt = sample['rgbs'].reshape(h, w, 3)
        save('gt.png', gt)
        psnr = float(psnr_fn(torch.from_numpy(gt), torch.from_numpy(pred)))
        print('PSNR:', psnr)
    for key, name in [('rgb_fine_static', 'static.png'),
                      ('rgb_fine_transient', 'transient.png')]:
        if key in res:
            save(name, res[key].reshape(h, w, 3))
    print('wrote', args.out)
    return psnr


if __name__ == '__main__':
    main()
