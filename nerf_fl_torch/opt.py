"""Training CLI flags of the port (``python -m nerf_fl_torch.train``).

The port's copy of the root ``opt.py``: every flag with the JAX CLI's type,
default and choices, so a JAX command line parses here; the flags shared
with eval are declared once in ``utils/cli.py``.  The port adds mip-NeRF:
``--model mipnerf`` (``utils/cli.PORT_ONLY``) and the ``--lr_scheduler``
choice ``mip``.
"""
import argparse

from .utils.cli import add_shared_flags, check_model_flags


def get_parser():
    parser = argparse.ArgumentParser()
    add_shared_flags(parser, "train")

    # blender-family options
    parser.add_argument('--data_perturb', nargs="+", type=str, default=[],
                        help='synthetic-data corruptions to apply: any of "color" '
                             '(per-image color jitter) and "occ" (random '
                             'occluder stripes); empty for clean data')

    # BARF evaluation harness: inject seeded SE(3) noise into the INITIAL
    # camera poses so --refine_pose has a known error to recover (the
    # pose-noise -> recovery protocol of the BARF paper sec. 5; no
    # reference equivalent — its pose refinement ships untested)
    parser.add_argument('--pose_noise', nargs=2, type=float, default=[0, 0],
                        metavar=('ROT_DEG', 'TRANS_FRAC'),
                        help='per-camera init-pose noise: rotation sigma in '
                             'degrees and translation sigma as a fraction '
                             'of the camera distance; the clean poses are '
                             'kept for error reporting '
                             '(models/poses.py pose_errors)')
    parser.add_argument('--pose_noise_seed', type=int, default=0)
    parser.add_argument('--pose_lr_mult', type=float, default=1.0,
                        help='lr multiplier for the learned pose deltas '
                             'relative to the model lr (BARF paper sec. 5 '
                             'uses 2x: 1e-3 vs 5e-4; the reference trains '
                             'poses at the model lr, train.py:135-136)')
    parser.add_argument('--pose_warmup_epochs', type=float, default=0.0,
                        help='hold pose deltas FIXED for the first N '
                             '(fractional) epochs: during the early white-'
                             'background-collapse phase pose gradients are '
                             'noise and Adam random-walks the poses out of '
                             'the registration basin (measured 2.0 -> 5.3 '
                             'deg in 2 epochs; docs/QUALITY.md BARF '
                             'section). 0 = reference-parity behavior')

    # train-time sampling stochasticity (eval always renders perturb=0,
    # noise_std=0, matching reference eval.py test_time semantics)
    parser.add_argument('--perturb', type=float, default=1.0,
                        help='jitter amplitude for stratified depth samples (0 = deterministic)')
    parser.add_argument('--noise_std', type=float, default=1.0,
                        help='sigma-regularizing noise std (pre-activation)')

    parser.add_argument('--batch_size', type=int, default=1024,
                        help='rays per training step')
    parser.add_argument('--num_epochs', type=int, default=16,
                        help='epochs to train')

    parser.add_argument('--prefixes_to_ignore', nargs='+', type=str, default=['loss'],
                        help='parameter-name prefixes skipped when loading a stripped/partial '
                             'checkpoint')

    parser.add_argument('--optimizer', type=str, default='adam',
                        help='optimizer',
                        choices=['sgd', 'adam', 'radam', 'ranger'])
    parser.add_argument('--lr', type=float, default=5e-4,
                        help='base learning rate')
    parser.add_argument('--momentum', type=float, default=0.9,
                        help='momentum (sgd)')
    parser.add_argument('--weight_decay', type=float, default=0,
                        help='L2 weight decay')
    parser.add_argument('--lr_scheduler', type=str, default='steplr',
                        help='learning-rate schedule (mip: mip-NeRF\'s '
                             'delayed log-linear decay by the step, from '
                             '--lr to --lr / 100 over the run, set each '
                             'call of the step)',
                        choices=['steplr', 'cosine', 'poly', 'mip'])
    # LR warmup (active for sgd/adam)
    parser.add_argument('--warmup_multiplier', type=float, default=1.0,
                        help='target multiplier reached at the end of the warmup ramp')
    parser.add_argument('--warmup_epochs', type=int, default=0,
                        help='epochs of linear LR warmup before the schedule takes over')
    # steplr schedule
    parser.add_argument('--decay_step', nargs='+', type=int, default=[20],
                        help='epochs at which steplr multiplies the LR by decay_gamma')
    parser.add_argument('--decay_gamma', type=float, default=0.1,
                        help='steplr decay multiplier')
    # poly schedule
    parser.add_argument('--poly_exp', type=float, default=0.9,
                        help='poly schedule exponent')

    parser.add_argument('--exp_name', type=str, default='exp',
                        help='experiment name (checkpoint/log subfolder)')
    parser.add_argument('--save_path', type=str, default='./ckpts',
                        help='checkpoint output root')
    parser.add_argument('--refresh_every', type=int, default=1,
                        help='console progress-line cadence in steps (0 '
                             'disables; uses the last logged metrics, so '
                             'printing never syncs the device)')

    # ---- extras of this project, not meaningful at eval ----
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='tensor-parallel degree (the model axis of '
                             'the mesh; ranks = num_gpus x model_parallel)')
    parser.add_argument('--num_hosts', type=int, default=1,
                        help='hosts of a multi-host job (each starts '
                             'num_gpus x model_parallel / num_hosts ranks)')
    parser.add_argument('--host_index', type=int, default=0,
                        help='this process\'s index in [0, num_hosts)')
    parser.add_argument('--coordinator_address', type=str,
                        default='localhost:12321',
                        help='host:port of process 0 of a multi-host job')
    parser.add_argument('--microbatch', type=int, default=1,
                        help='accumulate the gradient over this many equal '
                             'batch slices inside the step (one optimizer '
                             'update)')
    parser.add_argument('--device_pool', type=str, default='auto',
                        choices=['auto', 'on', 'off'],
                        help='keep the whole training ray pool in device '
                             'memory and draw batches on the device (no '
                             'host work per step); auto = on when the '
                             'pool is <= 2 GiB')
    parser.add_argument('--steps_per_execution', type=int, default=1,
                        help='optimizer steps a call; on the card a CUDA '
                             'graph of one step, replayed (the same steps '
                             'as one at a time, bit for bit)')
    parser.add_argument('--seed', type=int, default=0,
                        help='PRNG seed for init, shuffling and sampling')
    parser.add_argument('--log_every', type=int, default=50,
                        help='scalar-logging period in steps')
    parser.add_argument('--profile_dir', type=str, default=None,
                        help='write a torch.profiler Chrome trace of '
                             'training steps +100 to +120 of the run into '
                             'this directory')

    return parser


def get_opts(argv=None):
    parser = get_parser()
    return check_model_flags(parser, parser.parse_args(argv))
