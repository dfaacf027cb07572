"""Strip a training checkpoint down to bare weights: drops the optimizer
state, keeping ``state_dict``, ``epoch`` and ``global_step``, the file that
``python -m nerf_fl_torch.eval`` needs.

    python -m nerf_fl_torch.tools.save_weights_only --ckpt_path \\
        ckpts/exp/epoch=19.ckpt [--out ckpts/exp/epoch=19_weights.ckpt]

It reads either format (the port's, or the JAX package's msgpack file,
through ``training/checkpoints.load_checkpoint``, which needs no flax or
msgpack) and writes the port's torch format, in the port's layout.
"""
import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument('--ckpt_path', required=True)
    p.add_argument('--out', default=None,
                   help='default: <ckpt_path> with _weights suffix')
    args = p.parse_args(argv)

    import torch
    from ..training.checkpoints import load_checkpoint
    ckpt = load_checkpoint(args.ckpt_path)
    slim = {'state_dict': ckpt['state_dict'],
            'epoch': int(ckpt.get('epoch', 0)),
            'global_step': int(ckpt.get('global_step', 0))}
    base, ext = os.path.splitext(args.ckpt_path)
    out = args.out or f'{base}_weights{ext}'
    tmp = out + '.tmp'
    torch.save(slim, tmp)
    os.replace(tmp, out)
    old = os.path.getsize(args.ckpt_path)
    new = os.path.getsize(out)
    print(f'wrote {out} ({new/1e6:.1f} MB, was {old/1e6:.1f} MB)')
    return out


if __name__ == '__main__':
    main()
