"""Evaluation entry point of the port, the counterpart of the root eval.py:

    python -m nerf_fl_torch.eval --dataset_name blender --root_dir <lego> \
        --img_wh 400 400 --N_importance 64 --split test \
        --ckpt_path ckpts/exp/epoch=19.ckpt --scene_name lego

Renders a split frame by frame through ``render_chunked_async`` (test
time: perturb 0, noise 0), each submodule loaded by name from a checkpoint
of either format (the port's or the JAX package's), writes the frames as
PNGs and a GIF (``data/image_io.py``) under ``results/<dataset>/<scene>``,
and prints ``Mean PSNR`` (and ``Mean SSIM`` with --compute_ssim) as the
JAX CLI does, with each frame's dispatch, drain and host times.  It runs
on the card; ``NERF_FL_TORCH_DEVICE=cpu`` or ``main(args, device="cpu")``
asks for the CPU.  Blender only; --optimize_appearance and --refine_pose
(ROADMAP A.7), --save_depth and mp4 (A.6) and more than one device (A.8)
raise.
"""
import os
import time
from argparse import ArgumentParser

import numpy as np


def get_opts(argv=None):
    from .utils.cli import add_shared_flags
    parser = ArgumentParser()
    add_shared_flags(parser, "eval")
    parser.add_argument('--scene_name', type=str, default='test',
                        help='scene name, used as output folder name')
    parser.add_argument('--split', type=str, default='val',
                        choices=['val', 'test', 'test_train'])
    parser.add_argument('--video_format', type=str, default='gif',
                        choices=['gif', 'mp4'])
    parser.add_argument('--save_depth', default=False, action="store_true",
                        help='also save depth maps as PFM (not ported yet)')
    parser.add_argument('--compute_ssim', default=False, action="store_true",
                        help='also report mean SSIM')
    parser.add_argument('--optimize_appearance', default=False,
                        action="store_true",
                        help='NeRF-W paper eval protocol (not ported yet)')
    parser.add_argument('--opt_a_steps', type=int, default=100,
                        help='Adam steps for --optimize_appearance')
    parser.add_argument('--opt_a_lr', type=float, default=0.1,
                        help='Adam lr for --optimize_appearance')
    parser.add_argument('--opt_a_rays', type=int, default=4096,
                        help='left-half rays sampled for the fit')
    return parser.parse_args(argv)


def max_split_ts(dataset, split: str) -> int:
    """Largest embedding id a blender split emits (val/test render with
    t = 0, test_train with the frame index), without loading images."""
    if split == 'test_train':
        return len(dataset.meta['frames']) - 1
    return 0


def build_eval_state(args, device, white_back: bool):
    """Config (the train flags' config at test time: perturb 0, noise 0)
    and params rebuilt from the flags, each submodule loaded by name from
    ``--ckpt_path``."""
    from dataclasses import replace

    import torch
    from .training import checkpoints
    from .training.system import build_params, config_from_hparams
    cfg = replace(config_from_hparams(args, white_back), perturb=0.0,
                  noise_std=0.0)
    params = build_params(cfg, args.N_vocab,
                          generator=torch.Generator().manual_seed(0),
                          device=device)
    for name in list(params):
        checkpoints.load_ckpt(params[name], args.ckpt_path, name)
    return cfg, params


def main(args, device=None, stats=None):
    """Render the split; returns the mean PSNR (None without ground
    truth).  ``stats``, a dict, receives the per-frame PSNR / SSIM and the
    frame, dispatch, drain and host seconds."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from .data import dataset_dict
    from .data.image_io import write_gif, write_png
    from .device import entry_device
    from .models import validate_vocab
    from .training.metrics import psnr as psnr_fn
    from .training.metrics import ssim as ssim_fn
    from .training.system import (DevicePrefetcher, refuse_unported,
                                  render_chunked_async, val_chunk_cap)

    refuse_unported(args, eval_mode=True)
    dev = entry_device(device)
    dataset = dataset_dict[args.dataset_name](
        root_dir=args.root_dir, split=args.split, img_wh=tuple(args.img_wh))
    cfg, params = build_eval_state(args, dev, dataset.white_back)
    if cfg.encode_a or cfg.encode_t:
        validate_vocab(args.N_vocab, max_split_ts(dataset, args.split))

    imgs, psnrs, ssims = [], [], []
    dir_name = f'results/{args.dataset_name}/{args.scene_name}'
    os.makedirs(dir_name, exist_ok=True)
    typ = 'fine' if args.N_importance > 0 else 'coarse'
    chunk = val_chunk_cap(args.chunk, args.N_samples, args.N_importance)
    if chunk < args.chunk:
        print(f'[eval] clamping chunk {args.chunk} -> {chunk}')
    # the next frame's rays are built on a worker thread while the card
    # renders, and PNG writes run on a small pool joined at the end
    writer = ThreadPoolExecutor(max_workers=2)
    writes = []
    frames = DevicePrefetcher(iter(range(len(dataset))),
                              lambda i: dataset[i], depth=2)
    phase_s = {"dispatch": [], "drain": [], "host": []}
    frame_marks = [time.perf_counter()]

    def process(item):
        """Drain a frame's render, then its host work; runs after the next
        frame's chunks are queued, so it overlaps that render."""
        i, sample, finish = item
        w, h = args.img_wh
        t_p = time.perf_counter()
        results = finish()
        phase_s["drain"].append(time.perf_counter() - t_p)
        t_p = time.perf_counter()
        img_pred = np.clip(results[f'rgb_{typ}'].reshape(h, w, 3), 0, 1)
        img_pred_ = (img_pred * 255).astype(np.uint8)
        imgs.append(img_pred_)
        writes.append(writer.submit(
            write_png, os.path.join(dir_name, f'{i:03d}.png'), img_pred_))
        if 'rgbs' in sample:
            img_gt = sample['rgbs'].reshape(h, w, 3)
            psnrs.append(float(psnr_fn(torch.from_numpy(img_gt),
                                       torch.from_numpy(img_pred))))
            if args.compute_ssim:
                ssims.append(float(ssim_fn(
                    torch.from_numpy(img_pred.transpose(2, 0, 1)[None]
                                     .copy()).to(dev),
                    torch.from_numpy(img_gt.transpose(2, 0, 1)[None]
                                     .copy()).to(dev))))
        phase_s["host"].append(time.perf_counter() - t_p)
        frame_marks.append(time.perf_counter())
        print(f'frame {i + 1}/{len(dataset)}', flush=True)

    prev = None
    try:
        for i, sample in enumerate(frames):
            # queues the frame's chunks; it reads back all but the last
            # ``inflight`` of them on the way, so it waits on the card too
            t_p = time.perf_counter()
            finish = render_chunked_async(
                params, sample['rays'], sample['ts'], cfg, chunk=chunk,
                test_time=True, keys=[f'rgb_{typ}'], device=dev)
            phase_s["dispatch"].append(time.perf_counter() - t_p)
            if prev is not None:
                process(prev)
            prev = (i, sample, finish)
        if prev is not None:
            process(prev)
        for f in writes:
            f.result()
    finally:
        frames.close()
        writer.shutdown(wait=True, cancel_futures=True)

    if len(frame_marks) > 1:
        deltas = np.diff(frame_marks)
        total = frame_marks[-1] - frame_marks[0]
        msg = (f'[eval] {len(deltas)} frames in {total:.1f} s '
               f'({total / len(deltas):.2f} s/frame')
        if len(deltas) > 1:
            # frame 1 also pays the first use of every kernel
            msg += f'; steady {float(np.mean(deltas[1:])):.2f} s/frame'
            msg += (f'; steady per-frame dispatch '
                    f'{float(np.mean(phase_s["dispatch"][1:])):.3f} s, '
                    f'drain {float(np.mean(phase_s["drain"][1:])):.3f} s, '
                    f'epilogue host '
                    f'{float(np.mean(phase_s["host"][1:])):.3f} s')
        else:
            msg += (f'; frame-1 dispatch {phase_s["dispatch"][0]:.3f} s, '
                    f'drain {phase_s["drain"][0]:.3f} s, epilogue host '
                    f'{phase_s["host"][0]:.3f} s')
        print(msg + ')', flush=True)
        if stats is not None:
            stats.update(frame_s=list(deltas), total_s=total,
                         **{f"{k}_s": v for k, v in phase_s.items()})

    write_gif(os.path.join(dir_name, f'{args.scene_name}.gif'), imgs, fps=30)
    if stats is not None:
        stats.update(psnr=psnrs, ssim=ssims)
    if ssims:
        print(f'Mean SSIM : {np.mean(ssims):.4f}')
    if psnrs:
        mean_psnr = np.mean(psnrs)
        print(f'Mean PSNR : {mean_psnr:.2f}')
        return mean_psnr
    return None


if __name__ == "__main__":
    main(get_opts())
