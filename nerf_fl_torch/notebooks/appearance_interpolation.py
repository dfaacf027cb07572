"""Appearance-embedding interpolation sweep, the script of the reference's
test_phototourism.ipynb cells 10-12: render one view under a linear
interpolation between two training images' appearance embeddings, through
the renderer's ``a_embedded`` override (``render_chunked(a_override=)``).

    python -m nerf_fl_torch.notebooks.appearance_interpolation \\
        --root_dir <brandenburg> --dataset_name phototourism \\
        --img_downscale 8 --idx 0 --id_a 1123 --id_b 278 --frames 8 \\
        --N_importance 64 --encode_a --encode_t --N_vocab 1500 \\
        --ckpt_path ckpts/brandenburg/epoch=19.ckpt --out interp

Writes interp_NN.png for each frame and interp.gif into --out.  It runs on
the card; ``NERF_FL_TORCH_DEVICE=cpu`` or ``main(argv, device="cpu")``
asks for the CPU.
"""
import argparse
import os

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument('--root_dir', required=True)
    p.add_argument('--dataset_name', default='phototourism',
                   choices=['blender', 'phototourism'])
    p.add_argument('--split', default='test_train')
    p.add_argument('--idx', type=int, default=0)
    p.add_argument('--id_a', type=int, required=True,
                   help='first appearance id (image id / frame index)')
    p.add_argument('--id_b', type=int, required=True,
                   help='second appearance id')
    p.add_argument('--frames', type=int, default=8)
    p.add_argument('--img_wh', nargs='+', type=int, default=[200, 200])
    p.add_argument('--img_downscale', type=int, default=8)
    p.add_argument('--N_emb_xyz', type=int, default=10)
    p.add_argument('--N_emb_dir', type=int, default=4)
    p.add_argument('--N_samples', type=int, default=64)
    p.add_argument('--N_importance', type=int, default=64)
    p.add_argument('--use_disp', action='store_true')
    p.add_argument('--N_vocab', type=int, default=1500)
    p.add_argument('--encode_a', action='store_true', default=True)
    p.add_argument('--N_a', type=int, default=48)
    p.add_argument('--encode_t', action='store_true')
    p.add_argument('--N_tau', type=int, default=16)
    p.add_argument('--beta_min', type=float, default=0.1)
    p.add_argument('--refine_pose', action='store_true')
    p.add_argument('--chunk', type=int, default=32 * 1024)
    p.add_argument('--ckpt_path', required=True)
    p.add_argument('--compute_dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--out', default='interp')
    return p


def main(argv=None, device=None):
    """Returns the rendered frames, (H, W, 3) uint8 each."""
    from ..data import dataset_dict
    from ..data.image_io import write_gif, write_png
    from ..device import entry_device
    from ..eval import build_eval_state
    from ..training.system import render_chunked
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
    if 'img_wh' in sample:
        w, h = (int(x) for x in sample['img_wh'])
    else:
        w, h = args.img_wh
    table = params['embedding_a'].detach().cpu().numpy()
    emb_a, emb_b = table[args.id_a], table[args.id_b]

    os.makedirs(args.out, exist_ok=True)
    imgs = []
    for f in range(args.frames):
        alpha = f / max(args.frames - 1, 1)
        emb = ((1 - alpha) * emb_a + alpha * emb_b).astype(np.float32)
        res = render_chunked(params, sample['rays'], sample['ts'],
                             cfg.eval_variant(), chunk=args.chunk,
                             test_time=True, output_transient=False,
                             keys=('rgb_fine',), a_override=emb, device=dev)
        img8 = to_u8(res['rgb_fine'].reshape(h, w, 3))
        imgs.append(img8)
        write_png(os.path.join(args.out, f'interp_{f:02d}.png'), img8)
    write_gif(os.path.join(args.out, 'interp.gif'), imgs, fps=4)
    print('wrote', args.out)
    return imgs


if __name__ == '__main__':
    main()
