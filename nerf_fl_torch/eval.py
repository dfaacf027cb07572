"""Evaluation entry point of the port, the counterpart of the root eval.py:

    python -m nerf_fl_torch.eval --dataset_name blender --root_dir <lego> \
        --img_wh 400 400 --N_importance 64 --split test \
        --ckpt_path ckpts/exp/epoch=19.ckpt --scene_name lego

Renders a split of a Blender, LLFF or Phototourism scene frame by frame
through ``render_chunked_async`` (test time: perturb 0, noise 0), each
submodule loaded by name from a checkpoint of either format (the port's or
the JAX package's), writes the frames as PNGs under
``results/<dataset>/<scene>`` (and, with --save_depth, each frame's depth
as ``depth_NNN.pfm``, ``data/pfm.py``), and prints ``Mean PSNR`` (and
``Mean SSIM`` with --compute_ssim) as the JAX CLI does, with each frame's
dispatch, drain and host times (the spans ``nerf.eval.dispatch``,
``nerf.eval.drain`` and ``nerf.eval.host`` of ``utils/spans.py``).
Phototourism's ``--split test`` renders the JAX CLI's dolly path for
``brandenburg_gate`` (appearance of image 1123, no transient field) at
--img_wh.  Where the JAX CLI writes a video
(Blender, LLFF, Phototourism's test split) it writes a GIF
(``data/image_io.py``); the port has no mp4 encoder, so --video_format mp4
prints the JAX CLI's fallback line and writes the GIF, as the JAX CLI does
where imageio has no ffmpeg.  --refine_pose renders at the checkpoint's
epoch (BARF's annealing state) and, on Phototourism and on --split
test_train, from the checkpoint's learned poses.  --optimize_appearance is
the NeRF-W paper's protocol: each frame's appearance vector is fit to
--opt_a_rays rays of its left half (``render.appearance``, Adam with the
weights frozen) and the PSNR is taken over its right half.  It runs on the
card; ``NERF_FL_TORCH_DEVICE=cpu`` or ``main(args, device="cpu")`` asks
for the CPU.  ``--num_gpus N`` renders data-parallel, as the JAX CLI's
mesh does: N ranks (``parallel.launch``; one a card, or all on the CPU
over gloo) each render their rows of every chunk and gather the pixels;
rank 0 prints and writes the outputs.  Too few cards raise
``parallel.make_mesh``'s error.
"""
import os
from argparse import ArgumentParser

import numpy as np


def get_opts(argv=None):
    from .utils.cli import add_shared_flags, check_model_flags
    parser = ArgumentParser()
    add_shared_flags(parser, "eval")
    parser.add_argument('--scene_name', type=str, default='test',
                        help='scene name, used as output folder name')
    parser.add_argument('--split', type=str, default='val',
                        choices=['val', 'test', 'test_train'])
    parser.add_argument('--video_format', type=str, default='gif',
                        choices=['gif', 'mp4'])
    parser.add_argument('--save_depth', default=False, action="store_true",
                        help='also save depth maps as PFM')
    parser.add_argument('--compute_ssim', default=False, action="store_true",
                        help='also report mean SSIM')
    parser.add_argument('--optimize_appearance', default=False,
                        action="store_true",
                        help='NeRF-W paper eval protocol: fit each held-out '
                             'image\'s appearance embedding on its LEFT '
                             'half (weights frozen), report PSNR on the '
                             'RIGHT half (needs --encode_a and GT images)')
    parser.add_argument('--opt_a_steps', type=int, default=100,
                        help='Adam steps for --optimize_appearance')
    parser.add_argument('--opt_a_lr', type=float, default=0.1,
                        help='Adam lr for --optimize_appearance')
    parser.add_argument('--opt_a_rays', type=int, default=4096,
                        help='left-half rays sampled for the fit')
    return check_model_flags(parser, parser.parse_args(argv))


def max_split_ts(dataset, split: str) -> int:
    """Largest embedding id a split emits, without loading images:
    Phototourism's sparse COLMAP ids (val's image, the training images,
    the test path's appearance image); Blender's frame index on
    test_train, else 0; LLFF's 0."""
    if hasattr(dataset, 'img_ids'):
        if split == 'val':
            return int(dataset.val_id)
        if split == 'test_train':
            return int(max(dataset.img_ids_train))
        return int(dataset.test_appearance_idx)
    if split == 'test_train' and hasattr(dataset, 'meta'):
        return len(dataset.meta['frames']) - 1
    return 0


# the no-mp4 line's reason: the port writes no mp4 (the card's machine has
# no ffmpeg), so it falls back as the JAX CLI does without imageio-ffmpeg
MP4_UNAVAILABLE = 'nerf_fl_torch has no mp4 encoder'


def set_test_path(dataset, args, scene: str) -> dict:
    """Phototourism's --split test: the camera at --img_wh with a 60 degree
    field of view and the JAX CLI's dolly path, defined for
    brandenburg_gate only; returns the render's extra arguments."""
    dataset.test_img_w, dataset.test_img_h = args.img_wh
    dataset.test_focal = dataset.test_img_w / 2 / np.tan(np.pi / 6)
    dataset.test_K = np.array(
        [[dataset.test_focal, 0, dataset.test_img_w / 2],
         [0, dataset.test_focal, dataset.test_img_h / 2],
         [0, 0, 1]])
    if scene != 'brandenburg_gate':
        raise NotImplementedError(
            'test-path poses are hard-coded per scene; only '
            'brandenburg_gate is defined')
    dataset.test_appearance_idx = 1123  # 85572957_6053497857.jpg
    n_frames = 30 * 4
    dx = np.linspace(0, 0.03, n_frames)
    dy = np.linspace(0, -0.1, n_frames)
    dz = np.linspace(0, 0.5, n_frames)
    poses_test = np.tile(dataset.poses_dict[1123], (n_frames, 1, 1))
    poses_test[:, 0, 3] += dx
    poses_test[:, 1, 3] += dy
    poses_test[:, 2, 3] += dz
    dataset.poses_test = poses_test
    return {'output_transient': False}


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


def apply_refine_pose(args, dataset) -> dict:
    """--refine_pose: the render's epoch from the checkpoint (either
    format), and the checkpoint's learned poses in the dataset where they
    apply (Phototourism: every split; Blender and LLFF: test_train, whose
    frames are the training frames); returns the render's extra
    arguments."""
    from .models.poses import learned_poses
    from .training import checkpoints
    ckpt = checkpoints.load_checkpoint(args.ckpt_path)
    # a BARF model renders at its checkpoint's annealing state, whether or
    # not the learned poses apply to this split
    out = {'epoch': float(ckpt.get('epoch', 0))}
    if args.dataset_name in ('blender', 'llff') \
            and args.split != 'test_train':
        print(f'[eval] --refine_pose on {args.dataset_name} applies '
              'only to --split test_train (learned poses are '
              'per-train-frame); ignoring the pose deltas (PE still '
              'anneals at the checkpoint epoch)')
    elif 'learn_poses' in ckpt.get('state_dict', {}):
        dataset.apply_refined_poses(
            learned_poses(ckpt['state_dict']['learn_poses'])[:, :3])
    return out


def fit_appearance(args, params, cfg, sample, i, w, h, dev):
    """--optimize_appearance on frame ``i``: fit its appearance vector to
    --opt_a_rays rays drawn from its left half (``default_rng(1000 +
    i)``); returns (the vector, the right half's mask, the fit's losses).
    The rays must be in raster order."""
    from .render.appearance import optimize_appearance
    assert len(sample['rays']) == w * h, \
        f"raster-order assumption broken: {len(sample['rays'])} " \
        f"rays != {w}x{h}"
    cols = np.arange(len(sample['rays'])) % w
    left = np.flatnonzero(cols < w // 2)
    sel = np.random.default_rng(1000 + i).choice(
        left, size=min(args.opt_a_rays, len(left)), replace=False)
    a, losses = optimize_appearance(
        params, sample['rays'][sel], sample['ts'][sel], sample['rgbs'][sel],
        cfg, steps=args.opt_a_steps, lr=args.opt_a_lr, device=dev)
    losses = losses.cpu().numpy()
    print(f'[opt_a] frame {i}: fit mse {float(losses[0]):.4f} -> '
          f'{float(losses[-1]):.4f}', flush=True)
    return a, cols >= w // 2, losses


def main(args, device=None, stats=None):
    """Render the split; returns the mean PSNR (None without ground
    truth).  ``stats``, a dict, receives the per-frame PSNR / SSIM, the
    frame, dispatch, drain and host seconds, and with
    --optimize_appearance each frame's fit seconds and loss curve (rank
    0's, with --num_gpus > 1)."""
    from .device import entry_device
    from .parallel import launch
    dev = entry_device(device)
    n = max(1, getattr(args, 'num_gpus', 1))
    if n == 1:
        return evaluate(dev, args, stats)
    psnr, rank_stats = launch.spawn_cli(_rank, args, dev, n)[0]
    if stats is not None:
        stats.update(rank_stats)
    return psnr


def _rank(device, args):
    """One rank of ``--num_gpus``: (mean PSNR, stats); only rank 0
    prints."""
    import contextlib
    import sys
    from .parallel import make_mesh, multihost
    mesh = make_mesh(args.num_gpus, devices=multihost.job_devices(device))
    stats = {}
    with open(os.devnull, 'w') as quiet, contextlib.redirect_stdout(
            sys.stdout if mesh.is_main else quiet):
        return evaluate(device, args, stats, mesh), stats


def evaluate(dev, args, stats=None, mesh=None):
    """``main`` on one device, or as one rank of ``mesh``'s data axis
    (every rank renders; rank 0 writes the frames, depths and video)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from .data import dataset_dict
    from .data.image_io import write_gif, write_png
    from .data.pfm import save_pfm
    from .models import validate_vocab
    from .training.metrics import psnr as psnr_fn
    from .training.metrics import ssim as ssim_fn
    from .training.system import (DevicePrefetcher, render_chunked_async,
                                  val_chunk_cap)
    from .utils.spans import span

    writes_out = mesh is None or mesh.is_main
    kwargs = {'root_dir': args.root_dir, 'split': args.split}
    if args.dataset_name == 'blender':
        kwargs['img_wh'] = tuple(args.img_wh)
        kwargs['mip'] = getattr(args, 'model', 'nerf') == 'mipnerf'
    elif args.dataset_name == 'llff':
        kwargs['img_wh'] = tuple(args.img_wh)
        kwargs['spheric_poses'] = args.spheric_poses
    else:
        kwargs['img_downscale'] = args.img_downscale
        kwargs['use_cache'] = args.use_cache
    dataset = dataset_dict[args.dataset_name](**kwargs)
    scene = os.path.basename(args.root_dir.strip('/'))
    cfg, params = build_eval_state(args, dev, dataset.white_back)
    render_kwargs = {}
    if args.refine_pose:
        render_kwargs.update(apply_refine_pose(args, dataset))
    if args.dataset_name == 'phototourism' and args.split == 'test':
        render_kwargs.update(set_test_path(dataset, args, scene))
    if cfg.encode_a or cfg.encode_t:
        validate_vocab(args.N_vocab, max_split_ts(dataset, args.split))

    imgs, psnrs, ssims = [], [], []
    dir_name = f'results/{args.dataset_name}/{args.scene_name}'
    if writes_out:
        os.makedirs(dir_name, exist_ok=True)
    typ = 'fine' if args.N_importance > 0 else 'coarse'
    wanted = [f'rgb_{typ}'] + ([f'depth_{typ}'] if args.save_depth else [])
    depths = []
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
    fits = {"opt_a_s": [], "opt_a_losses": []}
    frame_marks = []

    def process(item):
        """Drain a frame's render, then its host work; runs after the next
        frame's chunks are queued, so it overlaps that render."""
        i, sample, w, h, finish, right_mask = item
        with span("nerf.eval.drain") as s:
            results = finish()
        phase_s["drain"].append(s.seconds)
        with span("nerf.eval.host") as s:
            host(i, sample, w, h, results, right_mask)
        phase_s["host"].append(s.seconds)
        frame_marks.append(s.end)
        print(f'frame {i + 1}/{len(dataset)}', flush=True)

    def host(i, sample, w, h, results, right_mask):
        """A drained frame's host work: the image, its writes, its
        scores."""
        img_pred = np.clip(results[f'rgb_{typ}'].reshape(h, w, 3), 0, 1)
        img_pred_ = (img_pred * 255).astype(np.uint8)
        imgs.append(img_pred_)
        if writes_out:
            writes.append(writer.submit(
                write_png, os.path.join(dir_name, f'{i:03d}.png'), img_pred_))
        if args.save_depth:
            depth = results[f'depth_{typ}'].reshape(h, w).astype(np.float32)
            if writes_out:
                writes.append(writer.submit(
                    save_pfm, os.path.join(dir_name, f'depth_{i:03d}.pfm'),
                    depth))
            if stats is not None:
                depths.append(depth)
        if 'rgbs' in sample:
            img_gt = sample['rgbs'].reshape(h, w, 3)
            if right_mask is not None:
                # the protocol scores the half the fit never saw
                m = right_mask.reshape(h, w)
                psnrs.append(float(psnr_fn(torch.from_numpy(img_gt[m]),
                                           torch.from_numpy(img_pred[m]))))
            else:
                psnrs.append(float(psnr_fn(torch.from_numpy(img_gt),
                                           torch.from_numpy(img_pred))))
            if args.compute_ssim:
                ssims.append(float(ssim_fn(
                    torch.from_numpy(img_pred.transpose(2, 0, 1)[None]
                                     .copy()).to(dev),
                    torch.from_numpy(img_gt.transpose(2, 0, 1)[None]
                                     .copy()).to(dev))))

    with span("nerf.eval.frames") as loop:
        frame_marks.append(loop.start)
        prev = None
        try:
            for i, sample in enumerate(frames):
                if args.dataset_name == 'blender':
                    w, h = args.img_wh
                else:
                    w, h = (int(x) for x in sample['img_wh'])
                a_override = right_mask = None
                if args.optimize_appearance and args.encode_a \
                        and 'rgbs' in sample:
                    with span("nerf.eval.fit_appearance") as s:
                        a_override, right_mask, losses = fit_appearance(
                            args, params, cfg, sample, i, w, h, dev)
                    fits["opt_a_s"].append(s.seconds)
                    fits["opt_a_losses"].append(losses)
                # queues the frame's chunks; it reads back all but the last
                # ``inflight`` of them on the way, so it waits on the card too
                with span("nerf.eval.dispatch") as s:
                    finish = render_chunked_async(
                        params, sample['rays'], sample['ts'], cfg,
                        chunk=chunk, test_time=True, keys=wanted, device=dev,
                        a_override=a_override, mesh=mesh, **render_kwargs)
                phase_s["dispatch"].append(s.seconds)
                if prev is not None:
                    process(prev)
                prev = (i, sample, w, h, finish, right_mask)
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

    if writes_out and (args.dataset_name in ('blender', 'llff') or (
            args.dataset_name == 'phototourism' and args.split == 'test')):
        gif = os.path.join(dir_name, f'{args.scene_name}.gif')
        if args.video_format != 'gif':
            print(f'[eval] {args.video_format} writer unavailable '
                  f'({MP4_UNAVAILABLE}); writing {gif}')
        write_gif(gif, imgs, fps=30)
    if stats is not None:
        stats.update(psnr=psnrs, ssim=ssims, depth=depths, **fits)
    if ssims:
        print(f'Mean SSIM : {np.mean(ssims):.4f}')
    if psnrs:
        mean_psnr = np.mean(psnrs)
        print(f'Mean PSNR : {mean_psnr:.2f}')
        return mean_psnr
    return None


if __name__ == "__main__":
    main(get_opts())
