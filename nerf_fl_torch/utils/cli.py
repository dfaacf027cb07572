"""Flags shared by the port's train (``nerf_fl_torch/opt.py``) and eval
(``nerf_fl_torch/eval.py``) CLIs.

The port's copy of ``nerf_fl_tpu/utils/cli.py``: the same flags with the
same types, defaults and choices, so a command line of the JAX CLIs parses
here too (``tests/test_torch_entry.py`` holds the parsers to each other).
Per-mode differences are explicit overrides: --chunk's default, whether
--ckpt_path is required, and the help of --refine_pose / --num_gpus.
``--use_pallas`` selects the fused CUDA kernels (``RenderConfig.use_fused``:
auto None, on True, off False).  ``PORT_ONLY`` lists the port's own flags
(``--model``), which ``check_model_flags`` holds to what mip-NeRF has.
"""
from __future__ import annotations

# Each entry: (flag, kwargs, per-mode overrides).  Overrides map mode name
# ('train' | 'eval') -> kwargs replaced for that mode.
_SHARED = [
    ("--root_dir", dict(type=str, required=True,
                        help="dataset root folder"), {}),
    ("--dataset_name", dict(type=str, default="blender",
                            choices=["blender", "phototourism", "llff"],
                            help="dataset family"), {}),
    ("--img_wh", dict(nargs="+", type=int, default=[800, 800],
                      help="image resolution as WIDTH HEIGHT"), {}),
    ("--img_downscale", dict(type=int, default=1,
                             help="phototourism image downscale factor"), {}),
    ("--use_cache", dict(default=False, action="store_true",
                         help="load the prepare_phototourism.py ray cache "
                              "(its img_downscale must match)"), {}),
    ("--spheric_poses", dict(default=False, action="store_true",
                             help="llff only: inward-facing capture — "
                                  "sample in world depth with a spheric "
                                  "test path instead of NDC + spiral"), {}),

    # core NeRF sampling/encoding
    ("--N_emb_xyz", dict(type=int, default=10,
                         help="positional-encoding frequency count for xyz"),
     {}),
    ("--N_emb_dir", dict(type=int, default=4,
                         help="positional-encoding frequency count for view "
                              "directions"), {}),
    ("--N_samples", dict(type=int, default=64,
                         help="stratified samples per ray (coarse pass)"), {}),
    ("--N_importance", dict(type=int, default=128,
                            help="importance samples per ray (fine pass)"),
     {}),
    ("--use_disp", dict(default=False, action="store_true",
                        help="sample linearly in disparity instead of depth"),
     {}),

    # NeRF-W options
    ("--N_vocab", dict(type=int, default=100,
                       help="embedding-table size; must exceed the largest "
                            "image id in the dataset"), {}),
    ("--encode_a", dict(default=False, action="store_true",
                        help="per-image appearance embeddings (NeRF-A)"), {}),
    ("--N_a", dict(type=int, default=48,
                   help="appearance embedding width"), {}),
    ("--encode_t", dict(default=False, action="store_true",
                        help="transient head with uncertainty (NeRF-U)"), {}),
    ("--N_tau", dict(type=int, default=16,
                     help="transient embedding width"), {}),
    ("--beta_min", dict(type=float, default=0.1,
                        help="floor added to the composited uncertainty "
                             "beta"), {}),

    ("--refine_pose", dict(default=False, action="store_true"),
     {"train": dict(help="jointly optimize camera poses (BARF-style "
                         "so(3)+t deltas with annealed positional "
                         "encoding)"),
      "eval": dict(help="apply learned pose deltas from the checkpoint "
                        "and render at the checkpoint's PE-annealing "
                        "epoch")}),
    ("--barf_schedule", dict(type=str, default="fork",
                             choices=["fork", "paper"],
                             help="PE-annealing rule under --refine_pose: "
                                  "'fork' reproduces reference "
                                  "nerf.py:47-59 (alpha=N/epoch vs the "
                                  "frequency VALUE 2^k — permanently "
                                  "low-passes the field, bands 4..9 never "
                                  "activate); 'paper' is BARF eq. 14 "
                                  "(linear alpha vs the frequency index), "
                                  "the rule that actually recovers pose "
                                  "noise"), {}),
    ("--barf_epochs", dict(nargs=2, type=int, default=[4, 8],
                           metavar=("START", "END"),
                           help="PE-annealing window in epochs (the "
                                "reference hardcodes 4 8 at "
                                "train.py:43-44)"), {}),

    ("--chunk", dict(type=int),
     {"train": dict(default=32 * 1024,
                    help="fixed render-chunk size for val/eval (device "
                         "batches are static-shape; training never chunks)"),
      "eval": dict(default=32 * 1024 * 4,
                   help="rays per fixed-shape render program")}),

    ("--num_gpus", dict(type=int, default=1),
     {"train": dict(help="data-parallel device count (ranks, one a "
                         "device; the mesh's data axis)"),
      "eval": dict(help="devices a render chunk is sharded over (ranks, "
                        "one a device)")}),

    ("--ckpt_path", dict(type=str),
     {"train": dict(default=None,
                    help='pretrained checkpoint path to load; "auto" '
                         'resumes from the newest epoch=N.ckpt under '
                         'save_path/exp_name (preemption-safe restarts)'),
      "eval": dict(required=True, help="checkpoint to render")}),

    # ---- extras of this project shared by both CLIs ----
    ("--compute_dtype", dict(type=str, default="float32",
                             choices=["float32", "bfloat16"],
                             help="MLP matmul dtype (accumulation stays "
                                  "float32)"), {}),
    ("--use_pallas", dict(type=str, default="auto",
                          choices=["auto", "on", "off"],
                          help="fused CUDA PE + MLP kernels (auto = on for "
                               "CUDA tensors)"), {}),
    ("--fast_trig", dict(type=str, default="auto",
                         choices=["auto", "on", "off"],
                         help="polynomial PE sin/cos, error ~1e-6 "
                              "(auto = on for bfloat16 compute)"), {}),
    ("--remat_mlp", dict(action="store_true",
                         help="recompute the plain path's field MLP in the "
                              "backward (torch.utils.checkpoint); the "
                              "fused backward recomputes anyway"), {}),
    ("--mlp_depth", dict(type=int, default=8,
                         help="field MLP trunk depth D (reference "
                              "nerf.py:81 constructor arg, hardcoded 8 at "
                              "its call sites; skip connection at D//2)"), {}),
    ("--mlp_width", dict(type=int, default=256,
                         help="field MLP hidden width W (reference "
                              "nerf.py:82, hardcoded 256)"), {}),
    # ---- the port's own, which the JAX CLIs lack ----
    ("--model", dict(type=str, default="nerf", choices=["nerf", "mipnerf"],
                     help="nerf: NeRF / NeRF-W (nerf_pl's); mipnerf: "
                          "mip-NeRF (google/mipnerf): cone-cast "
                          "intervals, integrated positional encoding "
                          "(degrees 0..16), one MLP for --N_samples coarse "
                          "and as many resampled intervals, no density "
                          "noise (blender only; no --encode_a, --encode_t "
                          "or --refine_pose; --N_importance and "
                          "--noise_std are not read)"), {}),
]

# flags of the port that the JAX CLIs lack
PORT_ONLY = ("--model",)

# --steps_per_execution is train-only: K optimizer steps a call (a CUDA
# graph of the step on the card); rendering has no optimizer loop.


def shared_flag_names():
    return [flag for flag, _, _ in _SHARED]


def check_model_flags(parser, args):
    """Refuse, as a parse error, what ``--model mipnerf`` lacks: the
    appearance and transient embeddings, pose refinement, and datasets
    other than blender."""
    if getattr(args, "model", "nerf") != "mipnerf":
        return args
    bad = [f for f, on in (("--encode_a", args.encode_a),
                           ("--encode_t", args.encode_t),
                           ("--refine_pose", args.refine_pose)) if on]
    if bad:
        parser.error(f"--model mipnerf has no {', '.join(bad)}")
    if args.dataset_name != "blender":
        parser.error("--model mipnerf reads the blender dataset only")
    return args


def add_shared_flags(parser, mode):
    """Install the shared train/eval flag surface onto ``parser``."""
    assert mode in ("train", "eval"), mode
    for flag, kwargs, overrides in _SHARED:
        kw = dict(kwargs)
        kw.update(overrides.get(mode, {}))
        parser.add_argument(flag, **kw)
    return parser
