#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render, train and kernel-anatomy paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. print the card's name and power limit, turn TF32 off, build every CUDA
     kernel under nerf_fl_torch/csrc/ (one nvcc each, in parallel: the
     fused forward and backward and the three anatomy sources);
  2. hold the fused PE + MLP forward kernel against its plain PyTorch
     version on the card: transient on/off x appearance 48/0 x bf16/f32, a
     ragged 70,001 points, plain and BARF-annealed scale rows;
  3. render a 400 x 400 Blender-style frame of the flagship NeRF-W 64+64
     model (random weights from seed 0) through render_chunked in bf16,
     count the kernel's launches, and hold the first chunk against the
     plain MLP path, with and without the transient field; then the same
     frame at f32 (the CLIs' default dtype): the f32 kernel's launches and
     runs on the card a chunk, the sigma-only kernel's a chunk (the
     sigma-only coarse pass), and its time;
  4. time the whole frame and split one frame's device time by kernel
     (torch.profiler); hold the kernel against its plain version at the
     render chunk's 4,194,304 points and time both against its bound, bf16
     and f32 (the f32 bound: the work as three TF32 passes, beside the same
     work on the CUDA cores); the [fused] line adds what the block moves
     and takes (rows a tile, weight bytes from L2 reckoned from the plan,
     registers and shared memory); then the sigma-only kernel at the size
     of its launches in the f32 frame (a chunk's coarse samples), bit for
     bit the f32 kernel's sigma column, timed beside its bound, its plain
     version and the plain MLP path it replaced, and at the same 4,194,304
     points, bit for bit and timed;
  5. hold the fused backward kernel against its plain version in the same
     16 variants (every unpacked weight / bias grad and d_inp; f32 with
     the kernel's side of each ReLU tie, TIE_F32), and require two
     launches to agree bit for bit;
  6. train the flagship (bf16, batch 1024, Adam 5e-4, perturb 1) from a
     device-resident pool of 2^20 rays: one f32 step's gradients through
     the fused kernels against the plain MLP path, the kernel launches and
     runs of one f32 device-pool step (the default dtype) and the
     launches of one bf16 step, TRAIN_STEPS steps whose loss must fall; the step as a
     CUDA graph (steps_per_execution GRAPH_K, a call with a masked tail)
     bit for bit the eager step from cloned state, 2 + 2 fused launches a
     sub-step at capture; the step time of the eager step, the graph step
     and the same step through the plain MLP path in windows of TIME_K
     steps; one step of each by kernel, and a profiled graph call (its
     fused kernels by name, held to their runs as the kernels count them
     on the card, and its device busy share);
  7. hold the forward and the backward kernel (bf16, then f32) against
     their plain versions at the fine pass's 131,072 points and the coarse
     pass's 65,536, time both against their bounds and the backward
     against its plain version, with a [fused] line each (the backward's
     also counts the operand tiles it saves and its wgrad reads); then the
     `full` quality-gate arms' graph sub-step in experiments/arm_step.py's
     four cases (bf16 and f32, fused and plain; NeRF and NeRF-A);
  8. the entry points: write a Blender scene (8 train, 1 val, 2 test
     views of 800 x 800 PNGs, nerf_fl_torch.data.synthetic), train it
     through nerf_fl_torch.train.main (400 x 400, color + occ perturbed,
     the flagship at bf16, Adam, 2 epochs from the device pool as a CUDA
     graph of 20 sub-steps a call, a --profile_dir window), then score
     the test and the training views through nerf_fl_torch.eval.main for
     the trained and an untrained checkpoint: 2 + 2 fused kernel runs a
     sub-step over fit as the kernels count them on the card, one capture
     and a replay for every later sub-step, the profiled window's trace
     holding every fused run in it, no plain MLP call in fit and one a
     chunk (the coarse pass) in eval, one fused forward launch a chunk in
     eval, the last checkpoint reloaded bit for bit, the logged loss
     falling, the trained PSNR above the untrained (on the training views
     by 5 dB); print each epoch's seconds and rays/s beside phase 6's graph
     step, the window's device busy share and eval's frame times;
  9. hold each of the eleven kernel-anatomy probes against its plain version
     at the probes' own 524,288 points (operands from seed 0; the
     consolidated net bit for bit against the static one), time each beside
     its plain version and its bound, both per call and queued behind a
     device sleep (device time: the host out of the window), with the block
     it runs on (the chain, net and PE-matmul probes on the Hopper block,
     with ring depth or resident image, slab and shared bytes, registers
     and spills from ptxas); time the fused forward kernel at the same
     point count, as it is and without its encoders (experiments/
     fused_ablation.py's no_encoders variant, built here), split at
     concat's ring depth (experiments/chain_ablation.py, built here; bit
     for bit split as it ships), and pe_vpu as the parent designed it
     (experiments/pe_ablation.py's column_a_thread variant, built here; bit
     for bit pe_vpu as it ships); print the split of the fused kernel's
     time that the net probes measure, of the chain probes' times by skip
     and of the PE family (matmul PE against multiply-add PE, the five
     extra passes, the product over the bare stream); then run both
     anatomy entry points and require every result;
 10. the in-the-wild entry points: write a Phototourism scene (40 JPEGs
     of 384 / 320 / 256 px from the port's encoder, three COLMAP cameras,
     sparse ids, 2,000 points), decode every image, build the ray cache
     at img_downscale 2 (nerf_fl_torch.prepare_phototourism.main) and
     hold a dataset built from it to one built from the images bit for
     bit, train 2 epochs from the cache through nerf_fl_torch.train.main
     (camera-frame rays posed on the card from the frozen pose table, the
     flagship at bf16, the device pool as a graph of 20 sub-steps), and
     evaluate val and test_train with --save_depth and --video_format mp4
     for the trained and an untrained checkpoint; then write an LLFF
     capture (8 PNGs at 504 x 378), train it 1 epoch in NDC, and evaluate
     val and the spiral test path (at 168 x 126): over each fit 2 + 2
     fused kernel runs a sub-step as the kernels count them, one capture,
     no plain MLP call; the pose table after fit bit for bit as it
     began; the last checkpoint reloaded bit for bit, the pose table
     included; the loss falling; in eval one fused forward launch and one
     plain (coarse) MLP call a chunk, each PFM read back equal to the
     depth eval rendered, the mp4 fallback line and the GIF where the JAX
     CLI writes a video (LLFF) and nowhere else; trained above untrained
     on the training views by TOUR_SEEN_MARGIN; print each epoch's rays/s
     beside phase 6's graph step and the data layer's host seconds;
 11. BARF pose refinement and test-time appearance optimization through
     the entry points: write a textured Blender scene (8 train views of
     800 x 800 PNGs; an untextured ball leaves the poses unobservable),
     hold the gradients of the pose deltas and of the appearance table
     through the fused pair (bf16 and f32) against the plain f32 MLP path
     on one flagship batch of camera-frame rays with BARF's scale rows at
     epoch 1 of 0-2, train it 2 epochs at 400 x 400 from noisy poses (2
     deg, 2%) with --refine_pose, BARF's paper schedule, a pose warmup of
     1 epoch and a pose lr x 0.25, the device pool as a graph of 20
     sub-steps: the gates of phase 10's fits, every call's BARF weights
     (computed inside the replayed graph from the call's epoch tensor)
     equal to barf_weights of that epoch, the deltas exactly 0 through the
     warmup and moved after it, the aligned pose errors under 1.35 x the
     injected ones (the JAX package's contract); a frozen control arm
     (noise, no refinement, 1 epoch) whose deltas stay exactly 0; eval
     with --refine_pose on the training views and with
     --optimize_appearance on the test views (each frame's fit loss
     falling, the right half's PSNR finite, 2 fused forward and 1 fused
     backward launches and runs an Adam step beside one forward a render
     chunk); and a Phototourism collection (12 JPEGs) trained 1 epoch with
     --refine_pose; print the rays/s beside phase 6's graph step and the
     seconds an appearance fit takes;
 12. the tools through the entry points in child processes:
     nerf_fl_torch.tools.quality_gate --preset card (the 7-arm matrix at
     the flagship width, bf16, 10 views at 100 x 100 for 2 epochs, 4 arms
     at a time on the card; 7 arms trained and 8 evaluations, every test
     PSNR finite and above 5 dB, each arm's fused kernels 2 + 2 runs a
     sub-step as its train log counts them, a second run that trains and
     evaluates nothing), profile_trace over the co_nerfw arm's
     --profile_dir window (2 + 2 fused kernels a sub-step, no GEMM kernel,
     its busy share agreeing with experiments/trace_records' reading),
     save_weights_only on that arm's checkpoint (eval of the slim file
     gives the full one's Mean PSNR bit for bit), gen_nerf_tsv on phase
     10's Phototourism scene (its tsv byte for byte), and beside the gate
     scale_stress --preset card (24 JPEGs of 4 sizes, the ray cache, 1
     epoch at bf16, the val PSNR finite): print each stage's seconds, the
     peak RSS and the train rays/s beside phase 6's graph step;
 13. data parallelism (nerf_fl_torch/parallel/): (a) a one-rank NCCL
     mesh: the flagship graph step (bf16, perturb 1) over TIME_K sub-steps,
     each captured as two graphs around its all-reduce, bit for bit the
     meshless graph step from the same weights, pool and generator
     (params, Adam state, losses), the fused kernels 2 + 2 runs a sub-step
     by their own count, and both steps timed in alternating windows; (b)
     two ranks sharing the card over gloo (make_mesh(devices=[cuda:0] *
     2), spawned by parallel.launch): DP_K f32 sub-steps of the flagship
     DP step (each rank its half of every batch, drawing at the global
     shape) against one rank's graph step over the same global batches:
     each sub-step's loss within DP_LOSS_RTOL, the reduced gradient of an
     eager step from the same weights within DP_GRAD_REL, the parameters
     after the graph step within DP_ATOL, each rank's fused
     kernels 2 + 2 runs a sub-step, and the two-rank step timed; (c) python -m
     nerf_fl_torch.train --num_gpus <cards + 1> exits non-zero with
     make_mesh's message; (d) tensor parallelism: two ranks sharing the
     card over gloo on a data 1 x model 2 mesh, the flagship (perturb 1)
     on the plain MLP path (a sharded field runs no fused kernel: 0 runs),
     TP_STEPS sub-steps from the device pool: at f32 with Adam the graph
     K-step (K = TP_K, a second call with its tail masked; each sub-step
     cut at its collectives, one graph a piece) bit for bit the same
     ranks' eager single steps (params, Adam state, metrics), one capture
     and TP_K - 1 replays in the first call, the cut count equal across
     ranks; against one rank's plain-path steps each sub-step's loss
     within DP_LOSS_RTOL, one eager step's gradient within TP_GRAD_NORM
     and the parameters within the TP_BF16_* limits; with SGD TP_SGD_K
     graph sub-steps within DP_ATOL of one rank's; rank 1 bit for bit rank
     0; at bf16 the graph K-step within the TP_BF16_* limits of one
     rank's; a TP_TILE x TP_TILE tile of phase 3's frame rendered under
     model 2 within TP_RENDER_TOL of one rank's render; the eager and
     graph sub-steps timed;
 14. the native COLMAP points decoder (nerf_fl_torch/csrc/colmap_fast.c,
     host C, built with the C compiler): phase 10's scene with a
     points3D.bin of 1,000,000 points, each with a track of 8 images,
     decoded natively and by the pure-Python reader (every array bit for
     bit the same, both times printed), and PhototourismDataset(
     use_cache=False) over it (the points read natively, no fallback
     line; the near / far stage's seconds printed);
 15. mip-NeRF's field on the f32 pair's IPE instances: the forward and
     the backward held against their plain versions at one level of the
     mip cell's sub-step (IPE_POINTS; the backward with a zero cotangent
     at each point that has a unit within IPE_TIE of a ReLU's tie), the
     forward also at the render
     chunk's 4,194,304 points, two backward launches bit for bit; both
     timed beside their plain versions and their bounds
     (benchmark/flops_mip.py's operations and bytes, the f32 bounds of
     phases 4 and 7); then one eager mip-NeRF device-pool sub-step at the
     cell's batch and intervals: 2 + 2 fused launches, all of them runs
     of the IPE kernels on the card, and a finite loss.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Needs the nerf_fl_torch
package beside this file, a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(N_samples=64, N_importance=64, encode_a=True, N_a=48,
                encode_t=True, N_tau=16, beta_min=0.1, white_back=True,
                perturb=0.0, noise_std=0.0, compute_dtype="bfloat16")
IMG = 400                      # the reference README's lego size
N_KERNEL_CHECK = 70_001        # ragged: no multiple of the 128- or 64-point tiles
F32_ATOL = 2e-4                # as tests/test_fused_mlp.py
# bf16: kernel and plain version sum the same exact products in another
# order, so a hidden value near a bf16 rounding boundary can land one ulp
# (2^-8 relative) apart and ~10 rounded layers carry that to the heads.
BF16_ATOL, BF16_RTOL = 3e-2, 2e-2
BF16_MEAN = 1e-3               # a layout fault moves the mean, not just a few
# the plain MLP path rounds at other places (xyz_final, per-ray
# conditioning), so the rendered colours agree less closely
RENDER_MAX, RENDER_MEAN = 5e-2, 5e-3
# backward kernel vs plain, per unpacked tensor: f32 max |d| <= 1e-4 of the
# tensor's largest magnitude (the same products summed in another order);
# bf16 ||d|| <= 2e-2 ||ref|| (a sum near a rounding boundary flips one bf16
# ulp of a cotangent on one side only, and every later product carries it)
BWD_F32_REL, BWD_BF16_NORM = 1e-4, 2e-2
# The f32 kernels take their products as 3xTF32 on the tensor cores, the
# plain version as f32 matrix products.  Where the plain forward has a
# hidden pre-activation within f32 rounding of zero (a tie unit) the two can
# decide that ReLU differently (so do the same products summed in another
# order or in float64), and the unit's whole cotangent with it: one such
# unit moves its point's d_inp and its share of each dW by up to 4.8e-2 of
# the tensor's largest at 70,001 points.  So the f32 backward gates feed
# the kernel the real cotangent and hold every tensor, over every point,
# to BWD_F32_REL against the plain backward with each tie unit on the side
# of its ReLU that the kernel's d_inp shows (f32_ties.matched_backward; a
# point's tie units past its third keep the plain side).  TIE_F32: the
# plain |pre-activation| under which a unit counts as a tie.  At 1e-6
# every gate passed on an H100 with the farthest unit taken to the other
# side at 8.61e-7; 2e-6 is also above the largest pre-activation
# difference of a CPU model of the kernels' products from the plain
# version, 1.19e-6 at 8,000 points (1.67e-6 with the f32 products
# reversed; experiments/relu_ties.py).  Phases 5 and 7 print the farthest
# unit taken: a unit whose side barely moves d_inp may be taken either way.
# TIE_SHARE_MAX: the most points that may have a tie unit (5.8% of them at
# 2e-6 on the H100), so a change that crowds pre-activations onto zero fails
TIE_F32, TIE_SHARE_MAX = 2e-6, 0.08
# one f32 train step, fused vs plain MLP path: max |x - y| / (|y| + 1e-3)
# per leaf, the metric and limit of tests/test_fused_mlp.py:81-86
GRAD_REL = 2e-3
TRAIN_STEPS = 200
# anatomy probes in f32 (sin, pe_mm, pe_vpu, pe_mm_bf16): kernel and plain
# version take the sin of the same exact arguments.  The first run on an
# H100 showed a difference of 0 (torch.sin on the card is the same sinf),
# so the gate is one decade under the 1e-5 that two sin implementations get
PROBE_F32_ATOL = 1e-6
# pe_mm on a dense N(0, 1) P (P's mid and lo terms not zero, so all six
# passes count): max |E - x @ P (float64)| in units of 2^-24 sum_k |x_k P_kc|,
# the bound of tests/test_torch_pe_image.py (its plain model of the passes
# reads ~1.7, a missing or doubled pass over 100)
PE_DENSE_UNITS = 16.0
# the six bf16 probes (chain and net families) against plain: |d| <=
# PROBE_BF16_ATOL + PROBE_BF16_RTOL |ref| and mean |d| <= PROBE_BF16_MEAN,
# the limits of tests/test_torch_anatomy.py.  Read on an H100 at 524,288
# points: max |d| 9.8e-4 (chain8) to 3.9e-3 (one bf16 ulp of a hidden value
# near 1, carried to an output), mean at most 6.7e-6
PROBE_BF16_ATOL, PROBE_BF16_RTOL, PROBE_BF16_MEAN = 4e-3, 1e-2, 5e-5
N_ANATOMY = 524_288            # the probes' own size
ANATOMY_REPS = 5               # timed launches per probe in the entry points
SIN_OPS = 20                   # f32 operations counted for one sin
POOL = 1 << 20                 # bench.py's synthetic ray pool
BATCH = 1024
TIME_K = 20                    # steps a timing window; the graph step's K
GRAPH_K, GRAPH_MASKED = 8, 3   # the graph parity check's K and masked tail
N_VOCAB = 1500
# phase 13 (b): f32 sub-steps of the two-rank step against one rank's over
# the same global batches.  The DP gradient is the same sum in another
# order: each sub-step's loss within DP_LOSS_RTOL, the reduced gradient of
# an eager step from the same weights within DP_GRAD_REL of each leaf's
# largest (after 8 sub-steps the weights differ, and with them the
# gradients: 4.4e-4 of a leaf's largest in the first reading).  Adam divides
# each update by |g|, so a weight whose gradient sits near Adam's eps moves
# by far more than the sum order's 1e-7 relative: the parameters are held
# to DP_ATOL, the limit tests/test_train_system.py sets for a change of
# layout alone (tensor parallel against one device) and the CPU tests
# (tests/test_torch_parallel.py) set for data 2 against one rank.  The
# first reading against 1e-5, on an H100 80GB HBM3, was 1.040e-05 after
# 8 sub-steps.
DP_K, DP_ATOL, DP_LOSS_RTOL, DP_GRAD_REL = 8, 2e-5, 1e-5, 1e-4
# phase 13 (d): the tensor-parallel K-step, K = TP_K over TP_STEPS sub-steps
# (two calls, the second's last three sub-steps masked).  Each TP sub-step
# stages its 24 collectives (up to 134 MB each at batch 1024) through host
# memory over gloo, 2.4-5 s a sub-step, so K and the sub-steps are cut to
# keep the phase under 2 minutes (7 sub-steps took 102-122 s).  Against one rank (the same weights, batches and draws on the
# plain MLP path): each f32 Adam sub-step's loss within DP_LOSS_RTOL, and
# the parameters after TP_SGD_K graph sub-steps of SGD (lr TP_LR, no
# momentum), whose update is linear in the gradient, within DP_ATOL, (b)'s
# limits for a change of layout.  A row-parallel layer rounds its partial
# sums apart from one rank's whole sum, so every activation moves by f32
# rounding, which the coarse field's first layers, ill-conditioned in this
# step (ROADMAP: JAX's f32 gradients of nerf_coarse.xyz.0-2 sit 2-3e-3
# norm-relative off a float64 run), carry into their gradients: one eager
# step's gradient is held to TP_GRAD_NORM of each leaf's norm, not to (b)'s
# DP_GRAD_REL (first reading on an H100: 2.6e-4 norm-relative and 7.1e-4
# of a leaf's largest, at nerf_coarse.xyz.0 and .5; one rank with its batch
# rows reversed, which keeps each ray's forward, 3.4e-7).  Adam divides each
# update by |g| + 1e-8, so a weight whose gradient sits near 1e-8 moves by
# a fraction of lr that this rounding sets: Adam's parameters are held to
# the bf16 limits below, not DP_ATOL (first reading: 1.1e-5 after one step,
# 9.0e-5 after seven, the largest at a weight whose first gradient was
# -2.1e-8).  bf16 against one rank: the limits of tests/test_torch_tp_graph.py
# (the losses rel 1e-4; each leaf within TP_STEPS lr at most and lr / 2 on
# average: Adam moves a weight whose gradient sits near its eps by up to lr
# a step either way where a rounding flips the gradient's sign).  The tile
# against one rank's render: the limit of that file's render test (f32, the
# row-parallel sums in another order)
TP_GRAD_NORM = 1e-3
TP_K, TP_STEPS, TP_SGD_K, TP_LR = 4, 5, 4, 5e-4
TP_BF16_LOSS_RTOL, TP_BF16_MEAN, TP_BF16_MAX = 1e-4, TP_LR / 2, \
    TP_STEPS * TP_LR
TP_TILE, TP_RENDER_TOL = 32, 1e-5
ARM_WINDOWS = 3                # phase 7's arm sub-steps: timing windows
# phase 15: one level of the mip cell's sub-step (4,096 rays x 128
# intervals) and phase 4's render chunk
IPE_POINTS, IPE_CHUNK = 524_288, 4_194_304
# The IPE backward's tie band: it writes no d_inp from which to read the
# kernel's side of a tie (f32_ties.matched_backward), so every point with
# a hidden unit whose plain |pre-activation| is under IPE_TIE gets a zero
# cotangent on both sides.  TIE_F32's 2e-6 holds at the 70,001 points of
# tests/test_torch_mipnerf_cuda.py, not at 524,288: there the plain
# forward and f32_ties.tf32x3_mm's model of the kernel's products put a
# hidden pre-activation up to 2.86e-6 apart (2.62e-6 on a second seed;
# 2.38e-6 at 70,001), and on an H100 every weight tensor read 2.3e-4 to
# 9.6e-4 of its largest at 2e-6 (the units left on the other side within
# 2.0-2.5e-6 of zero), at most 2.0e-5 at 1e-5 (8.3% of the points).
# 8e-6: 2.8x the largest gap, about 6.6% of the points (TIE_SHARE_MAX 8%)
IPE_TIE = 8e-6

# published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM B/s
PEAKS = {"H100 SXM": (989e12, 3.35e12), "H100 PCIe": (756e12, 2.0e12),
         "H100 NVL": (835e12, 3.9e12), "H200": (989e12, 4.8e12)}
# f32 FLOP/s outside the tensor cores, same data sheets
F32_PEAKS = {"H100 SXM": 67e12, "H100 PCIe": 51e12, "H100 NVL": 60e12,
             "H200": 67e12}
# the f32 fused kernels' products: three TF32 passes, TF32 at half the bf16
# rate, so their rate is the bf16 peak over 6
F32_PASS_COST = 6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def peak_for(name: str):
    if "H200" in name:
        return "H200", PEAKS["H200"]
    if "PCIe" in name:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    if "NVL" in name:
        return "H100 NVL", PEAKS["H100 NVL"]
    if "H100" in name:
        return "H100 SXM", PEAKS["H100 SXM"]
    fail(f"no published peak for {name!r}")


def f32_bounds(flops, n_bytes, part, peak_flops, peak_bw):
    """The f32 fused kernels' bounds (ms): the work as three TF32 passes
    (the larger of that and its bytes: the kernel's bound, and by which),
    and the same work on the CUDA cores."""
    t_ops = F32_PASS_COST * flops / peak_flops * 1e3
    t_bytes = n_bytes / peak_bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops / F32_PEAKS[part] * 1e3)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def fine_macs(cfg, a_dim=None, transient=None) -> int:
    """Multiply-adds per point of the fine MLP, unpadded (the coarse one
    with a_dim 0 and no transient)."""
    a_dim = cfg.N_a * cfg.encode_a if a_dim is None else a_dim
    transient = cfg.encode_t if transient is None else transient
    W, H = cfg.mlp_width, cfg.mlp_width // 2
    x, d = cfg.in_channels_xyz, cfg.in_channels_dir + a_dim
    m = x * W + 6 * W * W + (x + W) * W          # trunk
    m += W * W + W                               # xyz_final, sigma
    m += (W + d) * H + H * 3                     # dir, rgb
    if transient:
        m += (W + cfg.N_tau) * H + 3 * H * H + H * 5
    return m


def cuda_ms(fn, reps: int):
    """Median and all times (ms) of ``reps`` single calls, CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], times


def ptxas_info(src: str, kernel: str):
    """(registers, spill store bytes, spill load bytes, stack frame bytes)
    that ptxas reported for the entry function of ``src`` whose mangled
    name holds ``kernel``."""
    import re
    from nerf_fl_torch.ops import _build
    lines = _build.build_log(src).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            text = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", text)
            if regs and spill:
                return int(regs.group(1)), int(spill.group(2)), \
                    int(spill.group(3)), int(spill.group(1))
    fail(f"no ptxas report for {kernel} in csrc/{src}.cu's build log")


def fused_line(which, n, ms, flops, bound_ms, net):
    """The [fused] line of one kernel of ``net``'s layout at one shape: rate
    on the unpadded work, share of the bound, and what the block moves and
    takes.  Bytes are reckoned from the plans, not measured."""
    import torch
    from nerf_fl_torch.ops import fused_mlp as fm
    f32 = net.layout.dtype == torch.float32
    dtype = str(net.layout.dtype).split(".")[-1]
    info = fm.kernel_block_info(net.layout.dtype)
    tiles = fm.fwd_tiles(n, info["rows"])
    image = fm.image_plan(net.layout, which == "bwd")[1]
    kernel = f"fused_mlp_{which}_{'f32' if f32 else 'bf16'}_kernel"
    side = "" if which == "fwd" else "bwd_"
    block = (f"{info[side + 'threads']} threads ({info[side + 'consumers']} "
             f"consumer warpgroups)")
    head = (f"[fused] fused_mlp_{which} {dtype} at {n} points: {ms:.3f} ms, "
            f"{flops / ms / 1e9:.1f} TFLOP/s on the unpadded work, "
            f"{100 * bound_ms / ms:.1f}% of bound; {info['rows']} rows a tile,"
            f" {tiles} tiles x {image} B = {tiles * image / 1e9:.3f} GB of "
            f"weight slabs from L2 to shared memory; block {block}, ")
    if which == "fwd":
        r = ptxas_info("fused_mlp_fwd", kernel)
        print(head + f"{r[0]} registers a thread at launch (spill {r[1]} / "
              f"{r[2]} B), {info['fwd_smem']} B shared memory, ring of "
              f"{info['stages']} slabs")
        return
    r = ptxas_info("fused_mlp_bwd", kernel)
    w = ptxas_info("fused_mlp_bwd", "wgrad_f32_kernel" if f32
                   else "wgrad_kernel")
    saved, read = fm.bwd_tile_counts(net.layout)
    blocks = -(-n // 64)                     # 64-point row blocks
    tile_kb = 16 if f32 else 8
    slabs = -(-blocks // info["split_rows"]) if f32 \
        else min(info["splits"], blocks)
    grad_floats = sum(x.numel() + x.shape[1] for x in net.ws)
    print(head + f"{r[0]} registers (spill {r[1]} / {r[2]} B), "
          f"{info['bwd_smem']} B shared memory; wgrad {w[0]} registers (spill "
          f"{w[1]} / {w[2]} B), {info['wgrad_smem']} B; operand tiles "
          f"(activations and cotangents, {tile_kb} KB each): {saved} saved "
          f"per 64 points = {saved * blocks * tile_kb * 1024 / 1e9:.3f} GB "
          f"written, {read} read by the wgrad = "
          f"{read * blocks * tile_kb * 1024 / 1e9:.3f} GB; dW partial slabs "
          f"{slabs} x {grad_floats * 4} B")


def make_points(n, a_dim, t_dim, gen, dev):
    import torch
    xyz = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
    d = torch.randn(n, 3, generator=gen)
    dirs = (d / d.norm(dim=-1, keepdim=True)).to(dev)
    a = torch.randn(n, a_dim, generator=gen).to(dev) if a_dim else None
    t = torch.randn(n, t_dim, generator=gen).to(dev) if t_dim else None
    return xyz, dirs, a, t


def fwd_errors(got, ref, transient, dtype):
    """Forward kernel vs plain, per head: ({head: max |d|}, [faults])."""
    import torch
    from nerf_fl_torch.ops import fused_mlp as fm
    got, ref = fm.heads(got, transient), fm.heads(ref, transient)
    errs, faults = {}, []
    for k in ref:
        diff = (got[k] - ref[k]).abs()
        errs[k] = float(diff.max())
        if not torch.isfinite(got[k]).all():
            faults.append(f"non-finite kernel output {k}")
        if dtype == torch.float32:
            bad = errs[k] > F32_ATOL
        else:
            bad = bool((diff > BF16_ATOL + BF16_RTOL * ref[k].abs()).any()) \
                or float(diff.mean()) > BF16_MEAN
        if bad:
            faults.append(f"{k}: max {errs[k]:.3e} mean "
                          f"{float(diff.mean()):.3e}")
    return errs, faults


def phase_kernels(dev):
    """Kernel vs plain version in every variant."""
    import torch
    from nerf_fl_torch.core.encoding import barf_weights
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(1)
    failures = []
    for a_dim in (48, 0):
        mcfg = NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                          in_channels_a=a_dim or 48, encode_transient=True)
        model = init_nerf(mcfg, generator=gen).to(dev)
        xyz, dirs, a, t = make_points(N_KERNEL_CHECK, a_dim, 16, gen, dev)
        for barf in (False, True):
            bw = (barf_weights(6.0, 10, 4, 8, device=dev),
                  barf_weights(6.0, 4, 4, 8, device=dev)) if barf \
                else (None, None)
            sx, sd = fm.default_scale_rows(10, 4, a_dim, *bw, device=dev)
            for transient in (True, False):
                inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
                for dtype in (torch.bfloat16, torch.float32):
                    net = fm.pack_weights(model, fm.Layout(
                        dtype, 10, 4, a_dim, 16 if transient else 0))
                    errs, faults = fwd_errors(
                        fm.fused_mlp_fwd_cuda(inp, net, sx, sd),
                        fm.fused_mlp_reference(inp, net, sx, sd),
                        transient, dtype)
                    failures += [f"kernel != plain: a_dim={a_dim} barf={barf} "
                                 f"transient={transient} {dtype}: {f}"
                                 for f in faults]
                    name = str(dtype).split(".")[-1]
                    print(f"[kernel] a_dim={a_dim:2d} barf={barf!s:5} "
                          f"transient={transient!s:5} {name:8s} max_abs_err "
                          + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    if failures:
        fail("\n".join(failures))


def frame_rays(dev):
    """400 x 400 rays of a camera on a radius-4 sphere looking at the
    origin, Blender focal, near 2, far 6."""
    import numpy as np
    import torch
    from nerf_fl_torch.core.rays import get_ray_directions, get_rays

    focal = 0.5 * IMG / math.tan(0.5 * 0.6911112)
    K = np.array([[focal, 0, IMG / 2], [0, focal, IMG / 2], [0, 0, 1]],
                 np.float32)
    eye = 4.0 * np.array([1.0, -1.0, 0.8]) / np.linalg.norm([1.0, -1.0, 0.8])
    z = eye / np.linalg.norm(eye)                 # camera looks down -z
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = torch.tensor(np.stack([x, y, z, eye], 1), dtype=torch.float32,
                       device=dev)
    o, d = get_rays(get_ray_directions(IMG, IMG, K, device=dev), c2w)
    n = o.shape[0]
    near = torch.full((n, 1), 2.0, device=dev)
    far = torch.full((n, 1), 6.0, device=dev)
    return torch.cat([o, d, near, far], 1), torch.zeros(n, dtype=torch.int64,
                                                         device=dev)


def phase_render(dev):
    import numpy as np
    import torch
    from dataclasses import replace
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.render import RenderConfig, render_rays
    from nerf_fl_torch.training import build_params, metrics
    from nerf_fl_torch.training.system import render_chunked

    cfg = RenderConfig(**FLAGSHIP)
    params = build_params(cfg, 100, generator=torch.Generator().manual_seed(0),
                          device=dev)
    rays, ts = frame_rays(dev)
    n = rays.shape[0]
    chunk = render_chunk(cfg)
    keys = ["rgb_fine", "depth_fine"]

    def frame():
        return render_chunked(params, rays, ts, cfg, chunk=chunk,
                              test_time=True, keys=keys)

    # the main path: counts at 0 just before, read just after
    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    out = frame()
    launches = fm.fused_mlp_fwd_cuda.launches
    bwd_launches = fm.fused_mlp_bwd_cuda.launches
    expect = -(-n // chunk)
    print(f"[render] {IMG}x{IMG} frame, chunk {chunk}: fused kernel "
          f"launches {launches} (expected {expect})")
    rgb = out["rgb_fine"]
    if rgb.shape != (n, 3) or out["depth_fine"].shape != (n,):
        fail(f"bad output shapes {rgb.shape} {out['depth_fine'].shape}")
    if not (np.isfinite(rgb).all() and np.isfinite(out["depth_fine"]).all()):
        fail("non-finite frame")
    if launches != expect or bwd_launches != 0:
        fail(f"a frame launched the fused forward {launches} times and the "
             f"backward {bwd_launches}, expected {expect} and 0")

    # first chunk again through the plain MLP path, with and without the
    # transient field (phototourism test renders disable it)
    r0, t0 = rays[:chunk], ts[:chunk]
    with torch.no_grad():
        for transient in (True, False):
            fused = render_rays(params, r0, t0, cfg, test_time=True,
                                output_transient=transient)["rgb_fine"]
            plain = render_rays(params, r0, t0,
                                replace(cfg, use_fused=False),
                                test_time=True,
                                output_transient=transient)["rgb_fine"]
            diff = (fused - plain).abs()
            p = float(metrics.psnr(fused, plain))
            print(f"[render] first chunk, transient={transient}: fused vs "
                  f"plain rgb_fine max {float(diff.max()):.3e} mean "
                  f"{float(diff.mean()):.3e} psnr {p:.2f} dB")
            if transient:
                if float(diff.max()) > RENDER_MAX \
                        or float(diff.mean()) > RENDER_MEAN:
                    fail("fused render disagrees with the plain path")
                if np.abs(fused.cpu().numpy() - rgb[:chunk]).max() > 1e-5:
                    fail("chunk re-render differs from the frame")
            elif float(diff.max()) > RENDER_MAX \
                    or float(diff.mean()) > RENDER_MEAN:
                fail("fused render (no transient) disagrees with the plain "
                     "path")

    # frame time, host clock around a render that ends in a readback
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        s = time.perf_counter()
        frame()
        times.append((time.perf_counter() - s) * 1e3)
    frame_ms = sorted(times)[1]
    print(f"[render] frame ms {frame_ms:.1f} (runs {[round(t, 1) for t in times]}), "
          f"rays/s {n / frame_ms * 1e3:.0f}")
    profile_frame(frame)

    # the frame at f32, the CLIs' default dtype: the f32 kernel a chunk
    cfg32 = replace(cfg, compute_dtype="float32")

    def frame32():
        return render_chunked(params, rays, ts, cfg32, chunk=chunk,
                              test_time=True, keys=keys)

    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    fm.fused_sigma_cuda.launches = 0
    runs0, sig0 = fm.kernel_runs(dev), fm.sigma_runs(dev)
    out32 = frame32()
    launches32 = fm.fused_mlp_fwd_cuda.launches
    runs32 = fm.kernel_runs(dev)[0] - runs0[0]
    sig32 = (fm.fused_sigma_cuda.launches, fm.sigma_runs(dev) - sig0)
    if launches32 != expect or runs32 != expect \
            or fm.fused_mlp_bwd_cuda.launches != 0 \
            or sig32 != (expect, expect) \
            or not np.isfinite(out32["rgb_fine"]).all():
        fail(f"the f32 frame: {launches32} forward launches, {runs32} runs "
             f"on the card, {fm.fused_mlp_bwd_cuda.launches} backward, "
             f"sigma-only launches and runs {sig32}; expected {expect}, "
             f"{expect}, 0, ({expect}, {expect}), and a finite frame")
    times32 = []
    for _ in range(3):
        torch.cuda.synchronize()
        s = time.perf_counter()
        frame32()
        times32.append((time.perf_counter() - s) * 1e3)
    frame32_ms = sorted(times32)[1]
    print(f"[render] f32 frame: {launches32} forward launches ({runs32} runs "
          f"on the card), sigma-only launches / runs {sig32[0]} / "
          f"{sig32[1]}, frame ms {frame32_ms:.1f} (runs "
          f"{[round(t, 1) for t in times32]}), rays/s "
          f"{n / frame32_ms * 1e3:.0f}; max |rgb f32 - bf16| "
          f"{float(np.abs(out32['rgb_fine'] - rgb).max()):.2e}")
    return (launches, bwd_launches, launches32, sig32[0]), cfg


def profile_frame(frame, what="frame"):
    """Device time of one call by kernel (torch.profiler), and the share
    of its wall time in which the device was busy.  Returns (busy ms, wall
    ms, [(ms, launches, kernel name)]), or None if the profiler saw no
    device time.  The call sits between quiet margins inside the profiler,
    as fit's profiled window does (``system.PROFILE_MARGIN_S``), so that no
    kernel record falls outside the profiler's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nerf_fl_torch.training.system import PROFILE_MARGIN_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        s = time.perf_counter()
        frame()
        wall_ms = (time.perf_counter() - s) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    # device-side events only: an aten op also carries its kernels' time,
    # and a user annotation's device range (Optimizer.step#Adam.step)
    # spans kernels that are counted on their own
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print("[profile] the profiler saw no device time: not measured")
        return None
    print(f"[profile] one {what}: device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%; "
          f"{sum(r[1] for r in rows)} device kernels")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile] {ms:9.2f} ms {100 * ms / busy_ms:5.1f}% "
              f"x{count:<4d} {key[:90]}")
    return busy_ms, wall_ms, rows


def fused_case(dev, cfg, n, seed):
    """The flagship fine pass's forward operands at ``n`` random points:
    (inp, net, sx, sd) of fused_mlp_fwd_cuda / fused_mlp_reference."""
    import torch
    from nerf_fl_torch.models import init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(seed)
    model = init_nerf(cfg.nerf_config("fine"), generator=gen).to(dev)
    xyz, dirs, a, t = make_points(n, cfg.N_a, cfg.N_tau, gen, dev)
    inp = fm.pack_inputs(xyz, dirs, a, t)
    net = fm.pack_weights(model, fm.layout_for(cfg.nerf_config("fine"),
                                               cfg.dtype, transient=True))
    sx, sd = fm.default_scale_rows(cfg.N_emb_xyz, cfg.N_emb_dir, cfg.N_a,
                                   device=dev)
    return inp, net, sx, sd


def phase_timing(dev, cfg, smi_name):
    import torch
    from dataclasses import replace
    from nerf_fl_torch.ops import fused_mlp as fm

    n = 32 * 1024 * (cfg.N_samples + cfg.N_importance)     # 4,194,304
    inp, net, sx, sd = fused_case(dev, cfg, n, 2)
    dtype = cfg.dtype
    with torch.no_grad():
        errs, faults = fwd_errors(fm.fused_mlp_fwd_cuda(inp, net, sx, sd),
                                  fm.fused_mlp_reference(inp, net, sx, sd),
                                  True, dtype)
        print(f"[timing] fused_mlp_fwd vs plain at {n} points: max_abs_err "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
        if faults:
            fail(f"forward kernel != plain at {n} points: " + "; ".join(faults))
        for _ in range(2):                                   # warm up
            fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
        k_ms, k_all = cuda_ms(lambda: fm.fused_mlp_fwd_cuda(
            inp, net, sx, sd), 7)
        p_ms, p_all = cuda_ms(lambda: fm.fused_mlp_reference(
            inp, net, sx, sd), 5)
    flops = 2.0 * fine_macs(cfg) * n
    w_bytes = sum(w.numel() * w.element_size() for w in net.ws) \
        + sum(b.numel() * 4 for b in net.bs)
    n_bytes = inp.numel() * 4 + n * fm.OUT_W * 4 + w_bytes + 2 * 128 * 4
    part, (peak_flops, peak_bw) = peak_for(smi_name)
    t_ops, t_bytes = flops / peak_flops * 1e3, n_bytes / peak_bw * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[timing] fused_mlp_fwd bf16 at {n} points: {k_ms:.3f} ms/launch "
          f"(runs {[round(x, 3) for x in k_all]}); plain {p_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in p_all]})")
    print(f"[timing] work {flops / 1e12:.3f} TFLOP, {n_bytes / 1e9:.3f} GB; "
          f"bound {bound_ms:.3f} ms by {bound_by} at {part} peaks "
          f"({peak_flops / 1e12:.0f} TFLOP/s bf16, {peak_bw / 1e12:.2f} TB/s);"
          f" {flops / k_ms / 1e9:.1f} TFLOP/s achieved = "
          f"{100 * bound_ms / k_ms:.1f}% of bound")
    fused_line("fwd", n, k_ms, flops, bound_ms, net)

    # the f32 kernel at the same shape (the CLIs' default dtype)
    inp, net, sx, sd = fused_case(dev, replace(cfg, compute_dtype=
                                                   "float32"), n, 2)
    with torch.no_grad():
        errs32, faults = fwd_errors(
            fm.fused_mlp_fwd_cuda(inp, net, sx, sd),
            fm.fused_mlp_reference(inp, net, sx, sd), True,
            torch.float32)
        if faults:
            fail(f"f32 forward kernel != plain at {n} points: "
                 + "; ".join(faults))
        for _ in range(2):
            fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
        f_ms, f_all = cuda_ms(lambda: fm.fused_mlp_fwd_cuda(
            inp, net, sx, sd), 7)
        fp_ms, fp_all = cuda_ms(lambda: fm.fused_mlp_reference(
            inp, net, sx, sd), 5)
    w32 = sum(w.numel() * 4 for w in net.ws) + sum(b.numel() * 4
                                                   for b in net.bs)
    b32, by32, core32 = f32_bounds(flops, n_bytes - w_bytes + w32, part,
                                   peak_flops, peak_bw)
    print(f"[timing] fused_mlp_fwd float32 at {n} points: {f_ms:.3f} "
          f"ms/launch (runs {[round(x, 3) for x in f_all]}); plain "
          f"{fp_ms:.3f} ms; max_abs_err {max(errs32.values()):.2e}; bound "
          f"{b32:.3f} ms by {by32} as three TF32 passes "
          f"({100 * b32 / f_ms:.1f}% of it), {core32:.3f} ms on the CUDA "
          f"cores ({peak_for(smi_name)[0]} f32 peak)")
    fused_line("fwd", n, f_ms, flops, b32, net)
    sigma = sigma_timing(inp, net, sx, sd, cfg, part, peak_flops, peak_bw)
    return (k_ms, p_ms, bound_ms, bound_by, max(errs.values()),
            dict(ms=f_ms, plain_ms=fp_ms, bound_ms=b32, bound_by=by32,
                 core_ms=core32, err=max(errs32.values())), sigma)


def render_chunk(cfg) -> int:
    """The rays of a render chunk of phase 3's frames (one launch of each
    kernel a chunk)."""
    from nerf_fl_torch.training.system import val_chunk_cap
    return val_chunk_cap(32 * 1024, cfg.N_samples, cfg.N_importance)


def sigma_timing(inp, net, sx, sd, cfg, part, peak_flops, peak_bw):
    """The sigma-only kernel at the size of its launches in the f32 frame
    (a render chunk's rays x N_samples coarse samples): its pre-activation
    bit for bit the f32 kernel's sigma column and within F32_ATOL of its
    plain version; its time against its bound (three TF32 passes), its
    plain version's, and that of the plain MLP path (CUDA-core GEMMs) that
    the coarse pass ran before it.  Then at all of the f32 kernel's points,
    bit for bit and timed against its bound there too."""
    import torch
    from nerf_fl_torch.core import encoding
    from nerf_fl_torch.models import init_nerf
    from nerf_fl_torch.models.mlp import apply_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    n, nfx = inp.shape[0], net.layout.n_freq_xyz
    m = render_chunk(cfg) * cfg.N_samples
    x, W = cfg.in_channels_xyz, cfg.mlp_width
    macs = x * W + 6 * W * W + (x + W) * W + W
    model = init_nerf(cfg.nerf_config("coarse"),
                      generator=torch.Generator().manual_seed(2)).to(
                          inp.device)

    def sigma(xyz):
        return fm.fused_sigma_cuda(xyz, net, sx)

    def bounds(points):
        return f32_bounds(2.0 * macs * points, points * (3 + 1) * 4, part,
                          peak_flops, peak_bw)

    with torch.no_grad():
        xyz_all = inp[:, :3].contiguous()
        for k in (m, n):
            xyz = xyz_all[:k]
            if not torch.equal(sigma(xyz), fm.fused_mlp_fwd_cuda(
                    inp[:k], net, sx, sd)[:, fm.COL_S_SIGMA]):
                fail(f"sigma-only kernel at {k} points: not bit for bit the "
                     f"f32 kernel's sigma column")
        xyz = xyz_all[:m]
        err = float((sigma(xyz) - fm.fused_sigma_reference(
            xyz, net, sx)).abs().max())
        if not err <= F32_ATOL:
            fail(f"sigma-only kernel at {m} points: {err:.2e} from its plain "
                 f"version (limit {F32_ATOL})")
        for _ in range(2):
            sigma(xyz)
        ms, runs = cuda_ms(lambda: sigma(xyz), 7)
        plain_ms, _ = cuda_ms(lambda: fm.fused_sigma_reference(
            xyz, net, sx), 5)
        mlp_ms, mlp_runs = cuda_ms(lambda: apply_nerf(
            model, encoding.embed(xyz, nfx), sigma_only=True), 5)
        ms_all, runs_all = cuda_ms(lambda: sigma(xyz_all), 5)
    bound, by, core = bounds(m)
    bound_all, by_all, _ = bounds(n)
    print(f"[timing] fused_sigma float32 at {m} points (a chunk of the f32 "
          f"frame's coarse pass; {macs} MACs a point): {ms:.3f} ms/launch "
          f"(runs {[round(t, 3) for t in runs]}); bit for bit the f32 "
          f"kernel's sigma column; plain version {plain_ms:.3f} ms (max |d| "
          f"{err:.2e}); the plain MLP path it replaced (PE, cuBLAS f32 GEMMs, "
          f"bias and ReLU kernels) {mlp_ms:.3f} ms (runs "
          f"{[round(t, 3) for t in mlp_runs]}); bound {bound:.3f} ms by {by} "
          f"as three TF32 passes ({100 * bound / ms:.1f}% of it), "
          f"{core:.3f} ms on the CUDA cores")
    print(f"[timing] fused_sigma float32 at {n} points: {ms_all:.3f} "
          f"ms/launch (runs {[round(t, 3) for t in runs_all]}); bit for bit "
          f"the f32 kernel's sigma column; bound {bound_all:.3f} ms by "
          f"{by_all} ({100 * bound_all / ms_all:.1f}% of it)")
    return dict(points=m, ms=ms, plain_ms=plain_ms, mlp_ms=mlp_ms,
                bound_ms=bound, bound_by=by, core_ms=core, err=err,
                all_points=dict(points=n, ms=ms_all, bound_ms=bound_all))


def bwd_errors(got, ref, layout):
    """Per unpacked tensor of a net of ``layout`` (every weight and bias
    grad, then d_inp): (max |d|, max |ref|, ||d||, ||ref||)."""
    from nerf_fl_torch.ops import fused_mlp as fm
    pairs = list(zip(fm.unpack_weight_grads(got[0], got[1], layout),
                     fm.unpack_weight_grads(ref[0], ref[1], layout)))
    pairs.append((got[2], ref[2]))
    out = []
    for x, y in pairs:
        d = (x - y).float()
        out.append((float(d.abs().max()), float(y.abs().max()),
                    float(d.norm()), float(y.norm())))
    return out


def bwd_faults(errs, dtype):
    """The backward gate: f32 max |d| <= BWD_F32_REL max |ref| per tensor,
    bf16 ||d|| <= BWD_BF16_NORM ||ref||; one line per tensor outside it."""
    import torch
    return [f"tensor {j}: max {mx:.3e} of {ref_mx:.3e}, norm {nd:.3e} of "
            f"{nref:.3e}" for j, (mx, ref_mx, nd, nref) in enumerate(errs)
            if (mx > BWD_F32_REL * ref_mx if dtype == torch.float32
                else nd > BWD_BF16_NORM * nref)]


def norm_rel(errs) -> float:
    """Worst ||d|| / ||ref|| over the tensors of bwd_errors."""
    return max(e[2] / max(e[3], 1e-30) for e in errs)


def f32_bwd_reference(got, inp, net, sx, sd, g):
    """The f32 backward gates' reference for the kernel's output ``got``:
    the plain backward with the kernel's side of each ReLU tie
    (f32_ties.matched_backward, TIE_F32), its stats, a fault if more than
    TIE_SHARE_MAX of the points have a tie unit, and a note for the line."""
    from nerf_fl_torch.ops import f32_ties
    ref, st = f32_ties.matched_backward(got[2], inp, net, sx, sd, g,
                                        tol=TIE_F32)
    faults = [f"{st['tie_points']} of {st['points']} points have a tie "
              f"unit, over {TIE_SHARE_MAX:g} of them"] \
        if st["tie_points"] > TIE_SHARE_MAX * st["points"] else []
    note = (f"{st['tie_points']} tie points ({st['most_ties']} tie units "
            f"at most, {st['past_max_ties']} past {f32_ties.MAX_TIES}), "
            f"{st['moved_points']} "
            f"on the kernel's other side (farthest |pre| "
            f"{st['farthest_moved']:.2e})")
    return ref, st, faults, note


def worst_rel(got, ref) -> float:
    """Worst max |d| / max |ref| over the (dws, dbs, d_inp) tensors."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(got[0] + got[1] + [got[2]],
                               ref[0] + ref[1] + [ref[2]]))


def phase_bwd_kernels(dev):
    """Backward kernel vs plain version in every variant, and two launches
    bitwise equal.  f32 against the plain backward with the kernel's side
    of each ReLU tie (f32_bwd_reference); the reading against the plain
    sides is printed beside."""
    import torch
    from nerf_fl_torch.core.encoding import barf_weights
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(3)
    failures = []
    for a_dim in (48, 0):
        mcfg = NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                          in_channels_a=a_dim or 48, encode_transient=True)
        model = init_nerf(mcfg, generator=gen).to(dev)
        xyz, dirs, a, t = make_points(N_KERNEL_CHECK, a_dim, 16, gen, dev)
        g = torch.zeros(N_KERNEL_CHECK, fm.OUT_W)
        g[:, :9] = torch.randn(N_KERNEL_CHECK, 9, generator=gen)
        g = g.to(dev)
        for barf in (False, True):
            bw = (barf_weights(6.0, 10, 4, 8, device=dev),
                  barf_weights(6.0, 4, 4, 8, device=dev)) if barf \
                else (None, None)
            sx, sd = fm.default_scale_rows(10, 4, a_dim, *bw, device=dev)
            for transient in (True, False):
                inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
                for dtype in (torch.bfloat16, torch.float32):
                    net = fm.pack_weights(model, fm.Layout(
                        dtype, 10, 4, a_dim, 16 if transient else 0))
                    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
                    again = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
                    ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
                    torch.cuda.synchronize()
                    name = str(dtype).split(".")[-1]
                    tag = (f"a_dim={a_dim} barf={barf} transient={transient}"
                           f" {name}")
                    every = ""
                    if dtype == torch.float32:
                        plain = ref
                        ref, _, faults, note = f32_bwd_reference(
                            got, inp, net, sx, sd, g)
                        failures += [f"{tag}: {f}" for f in faults]
                        every = (f"; {note}; against the plain sides "
                                 f"{worst_rel(got, plain):.1e} (not gated)")
                    outs = got[0] + got[1] + [got[2]]
                    if not all(torch.isfinite(x).all() for x in outs):
                        failures.append(f"non-finite backward output {tag}")
                    if not all(torch.equal(x, y) for x, y in zip(
                            outs, again[0] + again[1] + [again[2]])):
                        failures.append(f"two launches differ: {tag}")
                    errs = bwd_errors(got, ref, net.layout)
                    failures += [f"backward kernel != plain {tag}: {f}"
                                 for f in bwd_faults(errs, dtype)]
                    rel = [e[0] / max(e[1], 1e-30) for e in errs]
                    print(f"[bwd kernel] {tag:42s} deterministic: max |d| "
                          f"/ max |ref| per leaf "
                          + " ".join(f"{r:.1e}" for r in rel[:-1])
                          + f"; d_inp {rel[-1]:.1e}; worst norm-rel "
                          f"{norm_rel(errs):.1e}" + every)
    if failures:
        fail("\n".join(failures))


def train_pool(dev, gen):
    """bench.py's synthetic pool on the card: o ~ N(0, 1), unit d, near 2,
    far 6, ts in [0, 1500), and the learnable target rgb = 0.5 + 0.4 d."""
    import torch
    o = torch.randn(POOL, 3, generator=gen, device=dev)
    d = torch.randn(POOL, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(POOL, 1, device=dev)
    return {"rays": torch.cat([o, d, 2 * ones, 6 * ones], 1),
            "ts": torch.randint(0, N_VOCAB, (POOL,), generator=gen,
                                device=dev),
            "rgbs": 0.5 + 0.4 * d}


def phase_train(dev):
    """Train the flagship from the device pool.  Returns the fused forward
    and backward launch counts of one bf16 step, and the graph step's time
    and fused launches a sub-step (at capture, and read back from a
    profiled replay)."""
    import numpy as np
    import torch
    from dataclasses import replace
    from types import SimpleNamespace
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.render import RenderConfig, render_rays
    from nerf_fl_torch.training import (build_params, epoch_perm, losses,
                                        make_device_pool_step, optimizers)

    cfg = RenderConfig(**{**FLAGSHIP, "perturb": 1.0})
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_params(cfg, N_VOCAB, generator=gen, device=dev)
    pool = train_pool(dev, gen)
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(dev)
    leaves = optimizers.named_leaves(params)

    # (a) one f32 step's gradients: fused kernels vs the plain MLP path
    f32 = replace(cfg, compute_dtype="float32", perturb=0.0)
    idx = perm[:BATCH].long()
    batch = {k: v.index_select(0, idx) for k, v in pool.items()}
    grads = []
    for use_fused in (None, False):
        for _, leaf in leaves:
            leaf.grad = None
        res = render_rays(params, batch["rays"], batch["ts"],
                          replace(f32, use_fused=use_fused))
        sum(losses.nerfw_loss(res, batch["rgbs"]).values()).backward()
        grads.append({k: leaf.grad.clone() for k, leaf in leaves})
    rel = {k: float(((grads[0][k] - grads[1][k]).abs()
                     / (grads[1][k].abs() + 1e-3)).max()) for k in grads[0]}
    worst = max(rel, key=rel.get)
    print(f"[train] f32 step, fused vs plain MLP path: {len(rel)} leaves, "
          f"max rel err {rel[worst]:.2e} ({worst})")
    if rel[worst] > GRAD_REL or not all(
            torch.isfinite(g).all() for g in grads[0].values()):
        fail(f"fused and plain gradients disagree: {rel}")
    for _, leaf in leaves:
        leaf.grad = None

    # (a') the main path at the CLIs' default dtype: counts at 0 just
    # before one f32 device-pool step (its own Adam, a copy of the weights),
    # read after, and the kernels' own count of their runs on the card
    import copy
    p32 = copy.deepcopy(params)
    opt32 = optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.trainable_parameters(
            p32, optimizers.make_trainable_mask(p32, False)))
    run32 = make_device_pool_step(replace(cfg, compute_dtype="float32"),
                                  opt32, batch_size=BATCH)
    runs0 = fm.kernel_runs(dev)
    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    m32 = run32(p32, pool, perm, 0, 5e-4, generator=gen)
    torch.cuda.synchronize()
    launches32 = (fm.fused_mlp_fwd_cuda.launches,
                  fm.fused_mlp_bwd_cuda.launches)
    runs32 = tuple(b - a for a, b in zip(runs0, fm.kernel_runs(dev)))
    print(f"[train] one f32 step (the default --compute_dtype): fused "
          f"forward / backward launches {launches32}, runs on the card "
          f"{runs32} (expected 2 and 2); loss "
          f"{float(m32['train/loss']):.4f}")
    if launches32 != (2, 2) or runs32 != (2, 2) \
            or not math.isfinite(float(m32["train/loss"])):
        fail(f"an f32 train step made {launches32} fused launches and "
             f"{runs32} runs, expected (2, 2), and a finite loss")
    del p32, opt32, run32

    # (b) the main path: counts at 0 just before one bf16 step, read after
    opt = optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))
    run = make_device_pool_step(cfg, opt, batch_size=BATCH)
    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    first = run(params, pool, perm, 0, 5e-4, generator=gen)
    torch.cuda.synchronize()
    launches = (fm.fused_mlp_fwd_cuda.launches,
                fm.fused_mlp_bwd_cuda.launches)
    print(f"[train] one bf16 step: fused forward launches {launches[0]}, "
          f"backward launches {launches[1]} (expected 2 and 2); metrics "
          + " ".join(f"{k}={float(v):.4f}" for k, v in first.items()))
    if launches != (2, 2):
        fail(f"a train step made {launches} fused launches, expected (2, 2)")

    # (c) train: the loss must stay finite and fall
    curve = [float(first["train/loss"])]
    for i in range(1, TRAIN_STEPS):
        curve.append(run(params, pool, perm, i, 5e-4,
                         generator=gen)["train/loss"])
    curve = np.array([float(v) for v in curve])
    head, tail = curve[:10].mean(), curve[-10:].mean()
    print(f"[train] {TRAIN_STEPS} steps: loss mean of the first 10 "
          f"{head:.4f}, of the last 10 {tail:.4f} (min {curve.min():.4f}, "
          f"max {curve.max():.4f})")
    if not np.isfinite(curve).all() or not tail < head:
        fail("the training loss did not fall")

    # (d) steps_per_execution: the step as a CUDA graph, replayed, against
    # the eager step from cloned state (same weights, fresh Adam, the same
    # generator seed, the same batches)
    graph_parity(cfg, params, pool, perm, dev)

    # (e) step time: host clock over windows that end in a synchronize;
    # the eager step, the graph step (one call of TIME_K sub-steps a
    # window) and the same step through the plain MLP path (cuBLAS GEMMs
    # under autograd) as the yardstick, each twice but the plain path
    i0 = TRAIN_STEPS
    plain = make_device_pool_step(replace(cfg, use_fused=False), opt,
                                  batch_size=BATCH)
    graphed = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                    steps_per_execution=TIME_K)
    graphed(params, pool, perm, i0, i0 + TIME_K, 5e-4, generator=gen)
    i0 += TIME_K                                 # capture and a warm call

    def window(name, i):
        if name == "graph":
            graphed(params, pool, perm, i, i + TIME_K, 5e-4, generator=gen)
            return
        fn = run if name == "fused" else plain
        for j in range(i, i + TIME_K):
            fn(params, pool, perm, j, 5e-4, generator=gen)

    results = {}
    for name in ("fused", "graph", "plain MLP path", "graph", "fused"):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            s = time.perf_counter()
            window(name, i0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - s) * 1e3 / TIME_K)
            i0 += TIME_K
        results.setdefault(name, []).append(sorted(times)[1])
        print(f"[train] {name} step ms {sorted(times)[1]:.2f} (windows of "
              f"{TIME_K}: {[round(x, 2) for x in times]}), train rays/s "
              f"{BATCH / sorted(times)[1] * 1e3:.0f}")
    step_ms, graph_ms = results["fused"][0], results["graph"][0]
    print(f"[train] graph step / eager step = {graph_ms / step_ms:.3f} "
          f"({results['graph']} against {results['fused']} ms)")

    # (f) one step's device time by kernel, up to its last kernel's end
    def one_step():
        run(params, pool, perm, i0, 5e-4, generator=gen)
        torch.cuda.synchronize()

    share = profile_frame(one_step, what="train step")
    if share is not None:
        # the profiler slows the host; the unprofiled step is the yardstick
        print(f"[train] device busy {share[0]:.1f} ms of the {step_ms:.2f} "
              f"ms timed step: {100 * share[0] / step_ms:.1f}% busy, "
              f"{100 * (1 - share[0] / step_ms):.1f}% idle")

    def one_plain_step():
        plain(params, pool, perm, i0 + 1, 5e-4, generator=gen)
        torch.cuda.synchronize()

    profile_frame(one_plain_step, what="plain MLP path train step")

    # (g) one graph call (TIME_K replayed sub-steps): its kernels by name,
    # and the device busy share of a sub-step
    def one_graph_call():
        graphed(params, pool, perm, i0 + 2, i0 + 2 + TIME_K, 5e-4,
                generator=gen)
        torch.cuda.synchronize()

    runs0 = fm.kernel_runs(dev)
    share = profile_frame(one_graph_call, what=f"graph call of {TIME_K} "
                          f"sub-steps")
    runs = tuple(b - a for a, b in zip(runs0, fm.kernel_runs(dev)))
    if share is None:
        fail("the profiler saw no device time in a graph replay")
    fwd = sum(c for _, c, key in share[2] if "fused_mlp_fwd_" in key)
    bwd = sum(c for _, c, key in share[2] if "fused_mlp_bwd_" in key)
    per_sub = share[0] / TIME_K
    print(f"[train] graph replay: fused forward kernels {fwd}, backward "
          f"kernels {bwd} in {TIME_K} sub-steps by name in the trace, "
          f"{runs[0]} and {runs[1]} run as the kernels count them "
          f"({fwd / TIME_K:g}, {bwd / TIME_K:g} a sub-step; expected 2 and "
          f"2); captured "
          f"{graphed.graph.captures} time(s), {graphed.graph.fused_launches} "
          f"fused launches a sub-step at capture; device busy "
          f"{per_sub:.2f} ms a sub-step of the {graph_ms:.2f} ms timed: "
          f"{100 * per_sub / graph_ms:.1f}% busy, "
          f"{100 * (1 - per_sub / graph_ms):.1f}% idle")
    if (fwd, bwd) != (2 * TIME_K, 2 * TIME_K) or runs != (fwd, bwd) \
            or graphed.graph.fused_launches != (2, 2) \
            or graphed.graph.captures != 1:
        fail(f"graph step: {(fwd, bwd)} fused kernels in the trace and "
             f"{runs} run in {TIME_K} replayed "
             f"sub-steps, {graphed.graph.fused_launches} at capture, "
             f"{graphed.graph.captures} captures; expected 2 + 2 a "
             f"sub-step, one capture")
    return launches, dict(ms=graph_ms, eager_ms=step_ms,
                          launches=graphed.graph.fused_launches,
                          replayed=(fwd // TIME_K, bwd // TIME_K),
                          f32_launches=launches32)


def graph_parity(cfg, params, pool, perm, dev):
    """GRAPH_K sub-steps replayed from a CUDA graph, then a call whose last
    GRAPH_MASKED sub-steps are masked, against as many eager steps, each
    side from a copy of ``params`` with a fresh Adam and a CUDA generator
    of seed 7: parameters, Adam state and losses bit for bit (the limit of
    tests/test_torch_cuda.py)."""
    import copy
    from types import SimpleNamespace
    import torch
    from nerf_fl_torch.training import make_device_pool_step, optimizers

    n = 2 * GRAPH_K - GRAPH_MASKED
    sides = []
    for k in (1, GRAPH_K):
        p = copy.deepcopy(params)
        opt = optimizers.build_optimizer(
            SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
            optimizers.trainable_parameters(
                p, optimizers.make_trainable_mask(p, False)))
        run = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                    steps_per_execution=k)
        gen = torch.Generator(device=dev).manual_seed(7)
        if k == 1:
            loss = [run(p, pool, perm, i, 5e-4, generator=gen)["train/loss"]
                    for i in range(n)]
        else:
            loss = []
            for i0 in (0, GRAPH_K):
                m = run(p, pool, perm, i0, n, 5e-4, generator=gen)
                loss += list(m["train/loss"][:n - i0])
                if not bool(m["train/loss"][n - i0:].isnan().all()):
                    fail("a masked sub-step of the graph step reported a "
                         "loss")
        torch.cuda.synchronize()
        state = [opt.state[q] for g in opt.param_groups for q in g["params"]]
        sides.append((optimizers.named_leaves(p), state,
                      torch.stack(loss), run))
    (p1, s1, l1, _), (pk, sk, lk, run) = sides
    worst = max(float((a - b).detach().abs().max())
                for (_, a), (_, b) in zip(p1, pk))
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(p1, pk)) and all(
        int(a["step"]) == int(b["step"]) == n
        and torch.equal(a["exp_avg"], b["exp_avg"])
        and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        for a, b in zip(s1, sk)) and torch.equal(l1, lk)
    print(f"[train] graph step (K = {GRAPH_K}, perturb 1): {n} sub-steps in "
          f"two calls, the last {GRAPH_MASKED} masked, against {n} eager "
          f"steps: params, Adam state and losses bit for bit: {same} (max "
          f"|d| params {worst:.3e}, losses {float((l1 - lk).abs().max()):.3e}"
          f"); captured {run.graph.captures} time(s), "
          f"{run.graph.fused_launches} fused launches a sub-step at capture")
    if not same or run.graph.captures != 1:
        fail("the graph step and the eager step disagree")
    if run.graph.fused_launches != (2, 2):
        fail(f"a captured sub-step made {run.graph.fused_launches} fused "
             f"launches, expected (2, 2)")


def phase_bwd_timing(cfg, smi_name):
    """The forward and backward kernels at the train step's shapes, fine
    (131,072 points, a_dim 48, transient) and coarse (65,536 points, a_dim
    0), held against their plain versions; then the backward timed."""
    import torch
    from nerf_fl_torch.models import NeRFConfig, init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm

    dev = torch.device("cuda", 0)
    part, (peak_flops, peak_bw) = peak_for(smi_name)
    out = {}
    gen = torch.Generator().manual_seed(4)
    for name, n, a_dim, transient, dtype in (
            (nm, nn, ad, tr, dt) for dt in (cfg.dtype, torch.float32)
            for nm, nn, ad, tr in (
                ("fine", BATCH * (cfg.N_samples + cfg.N_importance),
                 cfg.N_a, True),
                ("coarse", BATCH * cfg.N_samples, 0, False))):
        f32 = dtype == torch.float32
        dname = "float32" if f32 else cfg.compute_dtype
        model = init_nerf(NeRFConfig(typ="fine", encode_appearance=a_dim > 0,
                                     encode_transient=True),
                          generator=gen).to(dev)
        xyz, dirs, a, t = make_points(n, a_dim, cfg.N_tau, gen, dev)
        inp = fm.pack_inputs(xyz, dirs, a, t if transient else None)
        g = torch.zeros(n, fm.OUT_W)
        g[:, :9] = torch.randn(n, 9, generator=gen)
        g = g.to(dev)
        net = fm.pack_weights(model, fm.Layout(
            dtype, cfg.N_emb_xyz, cfg.N_emb_dir, a_dim,
            cfg.N_tau if transient else 0))
        sx, sd = fm.default_scale_rows(cfg.N_emb_xyz, cfg.N_emb_dir, a_dim,
                                       device=dev)
        with torch.no_grad():
            f_errs, faults = fwd_errors(
                fm.fused_mlp_fwd_cuda(inp, net, sx, sd),
                fm.fused_mlp_reference(inp, net, sx, sd), transient,
                dtype)
        got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
        ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
        st, limit = None, f"limit {BWD_BF16_NORM:g} norm-rel"
        if f32:
            plain_rel = worst_rel(got, ref)
            ref, st, tie_faults, note = f32_bwd_reference(got, inp, net, sx,
                                                          sd, g)
            faults += tie_faults
            limit = (f"limit {BWD_F32_REL:g} of each tensor's largest, "
                     f"every point, the kernel's side of each ReLU tie: "
                     f"{note}; against the plain sides {plain_rel:.1e}")
        errs = bwd_errors(got, ref, net.layout)
        faults += bwd_faults(errs, dtype)
        print(f"[bwd timing] {name} {dname}: at {n} points, fused_mlp_fwd "
              f"vs plain max_abs_err {max(f_errs.values()):.2e}; "
              f"fused_mlp_bwd vs plain max_abs_err "
              f"{max(e[0] for e in errs):.2e}, worst max-rel "
              f"{max(e[0] / max(e[1], 1e-30) for e in errs):.2e}, worst "
              f"norm-rel {norm_rel(errs):.2e} ({limit})")
        if faults:
            fail(f"kernel != plain at the {name} pass's {n} points: "
                 + "; ".join(faults))
        with torch.no_grad():
            for _ in range(2):                               # warm up
                fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
            f_ms, _ = cuda_ms(lambda: fm.fused_mlp_fwd_cuda(
                inp, net, sx, sd), 7)
        for _ in range(2):
            fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
        k_ms, k_all = cuda_ms(lambda: fm.fused_mlp_bwd_cuda(
            inp, net, sx, sd, g), 7)
        p_ms, p_all = cuda_ms(lambda: fm.fused_mlp_bwd_reference(
            inp, net, sx, sd, g), 5)
        # forward recompute + dgrad + wgrad: 3x the forward's operations
        flops = 3 * 2.0 * fine_macs(cfg, a_dim, transient) * n
        w_bytes = sum(w.numel() * w.element_size() for w in net.ws) \
            + sum(b.numel() * 4 for b in net.bs)
        # inp, g and d_inp once, weights read once, f32 grads written once
        n_bytes = n * (128 + fm.OUT_W + 128) * 4 + w_bytes \
            + sum(w.numel() * 4 for w in net.ws) + 2 * 128 * 4
        t_ops, t_bytes = flops / peak_flops * 1e3, n_bytes / peak_bw * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        f_bound = flops / 3 / peak_flops * 1e3
        core_ms = None
        if f32:
            bound_ms, bound_by, core_ms = f32_bounds(flops, n_bytes, part,
                                                     peak_flops, peak_bw)
            f_bound = F32_PASS_COST * f_bound
        print(f"[bwd timing] {name}: fused_mlp_bwd {dname} at {n} "
              f"points: {k_ms:.3f} ms/launch (runs "
              f"{[round(x, 3) for x in k_all]}); plain {p_ms:.3f} ms (runs "
              f"{[round(x, 3) for x in p_all]}); fused_mlp_fwd {f_ms:.3f} ms")
        print(f"[bwd timing] {name} {dname}: work {flops / 1e12:.3f} TFLOP, "
              f"{n_bytes / 1e9:.3f} GB; bound {bound_ms:.3f} ms by {bound_by} "
              f"at {part} peaks"
              + (" as three TF32 passes" if f32 else "")
              + f"; {flops / k_ms / 1e9:.1f} TFLOP/s achieved "
              f"= {100 * bound_ms / k_ms:.1f}% of bound"
              + (f"; {core_ms:.3f} ms on the CUDA cores" if f32 else ""))
        # the forward at this shape: a third of the operations; its bytes
        # are inp, out and the weights, far under its operations' time
        fused_line("fwd", n, f_ms, flops / 3, f_bound, net)
        fused_line("bwd", n, k_ms, flops, bound_ms, net)
        key = f"{name}_f32" if f32 else name
        out[key] = dict(ms=k_ms, fwd_ms=f_ms, plain_ms=p_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        fwd_bound_ms=f_bound, core_ms=core_ms,
                        fwd_err=max(f_errs.values()),
                        bwd_err=max(e[0] for e in errs),
                        bwd_rel=max(e[0] / max(e[1], 1e-30) for e in errs),
                        bwd_norm_rel=norm_rel(errs), ties=st)
    return out


def ipe_case(dev, n, seed):
    """A mip-NeRF field (glorot weights, every parameter nudged off its
    initial value so that no bias sits at 0) and n packed rows of Gaussians
    along cone intervals at the Blender recipe's scale: (inp, net, sx, sd)
    of fused_mlp_fwd_cuda / fused_mlp_reference in the IPE layout."""
    import torch
    from nerf_fl_torch.models import init_nerf
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.render import RenderConfig

    gen = torch.Generator().manual_seed(seed)
    mcfg = RenderConfig(model="mipnerf").nerf_config("mip")
    model = init_nerf(mcfg, generator=gen, init="glorot")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    model = model.to(dev)
    mean = torch.rand(n, 3, generator=gen) * 3 - 1.5
    var = 10.0 ** (torch.rand(n, 3, generator=gen) * 4 - 7)
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    inp = fm.pack_ipe_inputs(mean.to(dev), d.to(dev), var.to(dev))
    net = fm.pack_weights(model, fm.layout_for(mcfg, torch.float32))
    sx, sd = fm.default_scale_rows(0, 4, 0, device=dev)
    return inp.contiguous(), net, sx, sd


def phase_ipe(smi_name):
    """Phase 15: the IPE kernels against their plain versions and timed,
    then one mip-NeRF sub-step's launches and runs.  Returns the kernels'
    rows of the JSON line."""
    import torch
    from benchmark import flops_mip
    from nerf_fl_torch.ops import f32_ties
    from nerf_fl_torch.ops import fused_mlp as fm

    dev = torch.device("cuda", 0)
    part, (peak_flops, peak_bw) = peak_for(smi_name)
    with open(os.path.join(HERE, "benchmark", "configs",
                           "mipnerf_lego.json")) as f:
        conf = json.load(f)
    out = {}
    for n in (IPE_POINTS, IPE_CHUNK):
        inp, net, sx, sd = ipe_case(dev, n, 5)
        with torch.no_grad():
            got = fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
            ref = fm.fused_mlp_reference(inp, net, sx, sd)
            err = float((got - ref).abs().max())
            pad = float(got[:, 4:].abs().max())
            if not torch.isfinite(got).all() or err > F32_ATOL or pad != 0:
                fail(f"IPE forward kernel != plain at {n} points: max |d| "
                     f"{err:.3e} (limit {F32_ATOL:g}), padding {pad:g}")
            del got, ref
            for _ in range(2):                               # warm up
                fm.fused_mlp_fwd_cuda(inp, net, sx, sd)
            k_ms, k_all = cuda_ms(lambda: fm.fused_mlp_fwd_cuda(
                inp, net, sx, sd), 7)
            p_ms, _ = cuda_ms(lambda: fm.fused_mlp_reference(
                inp, net, sx, sd), 3)
        flops, n_bytes = flops_mip.fused_fwd(conf, n)
        bound, by, core = f32_bounds(flops, n_bytes, part, peak_flops,
                                     peak_bw)
        print(f"[ipe] fused_mlp_fwd_ipe float32 at {n} points: max_abs_err "
              f"{err:.2e}; {k_ms:.3f} ms/launch (runs "
              f"{[round(x, 3) for x in k_all]}); plain {p_ms:.3f} ms; work "
              f"{flops / 1e12:.3f} TFLOP, {n_bytes / 1e9:.3f} GB; bound "
              f"{bound:.3f} ms by {by} as three TF32 passes "
              f"({100 * bound / k_ms:.1f}% of it), {core:.3f} ms on the CUDA "
              f"cores")
        out[n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                      core_ms=core, err=err)
        del inp
        torch.cuda.empty_cache()
    fwd = out[IPE_CHUNK]

    # the backward at one level: each point with a tie unit (IPE_TIE)
    # gets a zero cotangent
    n = IPE_POINTS
    inp, net, sx, sd = ipe_case(dev, n, 6)
    g = torch.zeros(n, fm.OUT_W)
    g[:, :4] = torch.randn(n, 4, generator=torch.Generator().manual_seed(7))
    g = g.to(dev)
    pre = f32_ties.pre_activations(inp, net, sx, sd)
    model = f32_ties.pre_activations(inp, net, sx, sd,
                                     matmul=f32_ties.tf32x3_mm)
    gap = max(float((pre[i] - model[i]).abs().max()) for i in pre)
    tied = torch.stack([p.abs().lt(IPE_TIE).any(1)
                        for p in pre.values()]).any(0)
    n_tied = int(tied.sum())
    del pre, model
    if n_tied > TIE_SHARE_MAX * n:
        fail(f"IPE backward: {n_tied} of {n} points have a tie unit, over "
             f"{TIE_SHARE_MAX:g} of them")
    g[tied] = 0.0
    got = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    again = fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    ref = fm.fused_mlp_bwd_reference(inp, net, sx, sd, g)
    torch.cuda.synchronize()
    rel = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
           for x, y in zip(got[0] + got[1], ref[0] + ref[1])]
    faults = [f"tensor {j}: {r:.3e} of its largest" for j, r in
              enumerate(rel) if r > BWD_F32_REL]
    if got[2] is not None:
        faults.append("an input cotangent came back")
    if not all(torch.isfinite(x).all() for x in got[0] + got[1]):
        faults.append("non-finite gradients")
    if not all(torch.equal(x, y) for x, y in zip(got[0] + got[1],
                                                 again[0] + again[1])):
        faults.append("two launches differ")
    if faults:
        fail(f"IPE backward kernel != plain at {n} points: "
             + "; ".join(faults))
    del got, again, ref
    for _ in range(2):
        fm.fused_mlp_bwd_cuda(inp, net, sx, sd, g)
    b_ms, b_all = cuda_ms(lambda: fm.fused_mlp_bwd_cuda(
        inp, net, sx, sd, g), 7)
    bp_ms, _ = cuda_ms(lambda: fm.fused_mlp_bwd_reference(
        inp, net, sx, sd, g), 3)
    flops, n_bytes = flops_mip.fused_bwd(conf, n)
    bound, by, core = f32_bounds(flops, n_bytes, part, peak_flops, peak_bw)
    print(f"[ipe] fused_mlp_bwd_ipe float32 at {n} points: worst max-rel "
          f"{max(rel):.2e} (limit {BWD_F32_REL:g} of each tensor's largest; "
          f"{n_tied} points with a tie unit under {IPE_TIE:g} at a zero "
          f"cotangent; plain and modelled products {gap:.2e} apart at "
          f"most), "
          f"deterministic; {b_ms:.3f} ms/launch (runs "
          f"{[round(x, 3) for x in b_all]}); plain {bp_ms:.3f} ms; work "
          f"{flops / 1e12:.3f} TFLOP, {n_bytes / 1e9:.3f} GB; bound "
          f"{bound:.3f} ms by {by} as three TF32 passes "
          f"({100 * bound / b_ms:.1f}% of it), {core:.3f} ms on the CUDA "
          f"cores")
    bwd = dict(ms=b_ms, plain_ms=bp_ms, bound_ms=bound, bound_by=by,
               core_ms=core, rel=max(rel), tie_points=n_tied)
    for src, kernel in (("fused_mlp_fwd", "fused_mlp_fwd_ipe_f32_kernel"),
                        ("fused_mlp_bwd", "fused_mlp_bwd_ipe_f32_kernel")):
        r = ptxas_info(src, kernel)
        print(f"[ipe] {kernel}: {r[0]} registers (spill {r[1]} / {r[2]} B, "
              f"stack frame {r[3]} B)")
    del inp, g
    torch.cuda.empty_cache()
    launches, runs = mip_sub_step(dev, conf)
    return [{
        "name": "fused_mlp_fwd_ipe_f32", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_fwd.cu", "replaces": None,
        "launches": launches[0],
        "launches_by_path": {"mip_train_step_f32": launches[0]},
        "runs_on_card": runs[0], "max_abs_err": max(
            v["err"] for v in out.values()),
        "points": IPE_CHUNK, "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "bound_cuda_core_ms": fwd["core_ms"],
        "level": {"points": IPE_POINTS, **out[IPE_POINTS]},
        "library_ms": None}, {
        "name": "fused_mlp_bwd_ipe_f32", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_bwd.cu", "replaces": None,
        "launches": launches[1],
        "launches_by_path": {"mip_train_step_f32": launches[1]},
        "runs_on_card": runs[1], "max_rel_err": bwd["rel"],
        "rel_limit": BWD_F32_REL, "tie_points": bwd["tie_points"],
        "tie_band": IPE_TIE,
        "points": IPE_POINTS, "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "bound_cuda_core_ms": bwd["core_ms"], "library_ms": None}]


def mip_sub_step(dev, conf):
    """One eager mip-NeRF device-pool sub-step at the configuration's batch
    and intervals (f32, Adam) over random cone rays: its fused launches
    (forward, backward) as the wrappers count them, and the IPE kernels'
    runs on the card; fails unless both are 2 + 2 and the loss is finite."""
    import torch
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import build_params, make_device_pool_step
    from nerf_fl_torch.training import optimizers as opt

    r, t = conf["render"], conf["train"]
    cfg = RenderConfig(model="mipnerf", N_samples=r["N_samples"],
                       perturb=r["perturb"], white_back=r["white_back"],
                       compute_dtype="float32")
    B = t["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(8)
    n = 4 * B
    o = torch.randn(n, 3, device=dev, generator=gen)
    o = 4 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4 + 0.1 * torch.randn(n, 3, device=dev, generator=gen)
    rays = torch.cat([o, d, torch.full((n, 1), 5.2e-4, device=dev),
                      torch.full((n, 1), conf["scene"]["near"], device=dev),
                      torch.full((n, 1), conf["scene"]["far"], device=dev)],
                     -1)
    pool = {"rays": rays, "rgbs": torch.rand(n, 3, device=dev,
                                             generator=gen)}
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    params = build_params(cfg, 1, generator=gen, device=dev)
    hp = type("H", (), {"optimizer": "adam", "lr": t["lr_init"],
                        "weight_decay": 0.0})
    optim = opt.build_optimizer(hp, opt.param_groups(
        params, opt.make_trainable_mask(params, False)))
    step = make_device_pool_step(cfg, optim, batch_size=B, loss_name="mip")
    fwd, bwd = fm.fused_mlp_fwd_cuda, fm.fused_mlp_bwd_cuda
    l0, runs0 = (fwd.launches, bwd.launches), fm.ipe_runs(dev)
    loss = float(step(params, pool, perm, 0, t["lr_init"], 0.0, gen)
                 ["train/loss"])
    runs1 = fm.ipe_runs(dev)
    launches = (fwd.launches - l0[0], bwd.launches - l0[1])
    runs = tuple(b - a for a, b in zip(runs0, runs1))
    print(f"[ipe] one mip-NeRF sub-step ({B} rays x {r['N_samples']} + "
          f"{r['N_samples']} intervals): fused launches {launches}, IPE runs "
          f"on the card {runs}, loss {loss:.4f}")
    if launches != (2, 2) or runs != (2, 2) or not math.isfinite(loss):
        fail(f"mip-NeRF sub-step: fused launches {launches}, IPE runs "
             f"{runs} (2 + 2 each), loss {loss}")
    return launches, runs


def phase_arm_step():
    """The `full` quality-gate arms' graph sub-step in the four cases of
    nerf_fl_torch/experiments/arm_step.py (bf16 and f32, fused kernels and
    plain MLP path; NeRF and NeRF-A), ARM_WINDOWS windows of 8 sub-steps
    each after a capture, the median.  Timed, not gated."""
    from nerf_fl_torch.experiments import arm_step
    dev = __import__("torch").device("cuda", 0)
    out = {}
    for encode_a, arm in ((False, "color_nerf"), (True, "color_nerfa")):
        for dtype, fused in arm_step.CASES:
            name = f"{arm} {dtype} {'fused' if fused else 'plain'}"
            out[name] = arm_step.sub_step_ms(dev, dtype, fused, encode_a,
                                             ARM_WINDOWS)
            print(f"[arm_step] {name}: {out[name]:.3f} ms a sub-step")
    for arm in ("color_nerf", "color_nerfa"):
        f, pl = out[f"{arm} float32 fused"], out[f"{arm} float32 plain"]
        print(f"[arm_step] {arm}: f32 fused / f32 plain = {f / pl:.3f}")
    return out


# the entry-points phase: a Blender scene at the file size of the real
# dataset, trained and evaluated through python -m nerf_fl_torch.train /
# .eval's main functions
ENTRY_SCENE = dict(n_train=8, n_val=1, n_test=2, size=800, texture=True)
ENTRY_MODEL = ["--img_wh", "400", "400", "--encode_a", "--encode_t",
               "--N_vocab", "1500", "--N_samples", "64", "--N_importance",
               "64", "--compute_dtype", "bfloat16"]
# on its own training views the trained checkpoint must beat the untrained
# one by this many dB (held-out views say little on 8 views: +0.9 dB there)
ENTRY_SEEN_MARGIN = 5.0
ENTRY_TRAIN = ["--dataset_name", "blender", "--data_perturb", "color", "occ",
               "--batch_size", "1024", "--optimizer", "adam", "--lr", "5e-4",
               "--lr_scheduler", "cosine", "--num_epochs", "2",
               "--steps_per_execution", "20", "--device_pool", "on",
               "--refresh_every", "500"]


def _count_plain():
    """Wrap the renderer's plain MLP path in a call counter; returns
    (counter dict, restore())."""
    import nerf_fl_torch.render.renderer as renderer
    plain = {"calls": 0}
    apply_nerf = renderer.apply_nerf

    def counted(*a, **k):
        plain["calls"] += 1
        return apply_nerf(*a, **k)

    renderer.apply_nerf = counted

    def restore():
        renderer.apply_nerf = apply_nerf
    return plain, restore


def _trace_busy(window):
    """(busy seconds, fused forward kernels, fused backward kernels) in the
    Chrome trace of fit's --profile_dir window: the union of the kernels'
    intervals (``profile_trace.busy_union``), which no overlap of kernels
    counts twice."""
    from nerf_fl_torch.tools.profile_trace import busy_union
    with open(window["trace"]) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = busy_union(kernels)[0] / 1e6
    fwd = sum("fused_mlp_fwd_" in e.get("name", "") for e in kernels)
    bwd = sum("fused_mlp_bwd_" in e.get("name", "") for e in kernels)
    return busy, fwd, bwd


def phase_entry_points(graph_ms):
    """Train and evaluate a Blender scene through the port's entry points
    (``nerf_fl_torch.train.main``, ``nerf_fl_torch.eval.main``) in a
    temporary directory: the fused kernels' runs over fit as they count
    them on the card (2 + 2 a sub-step, the validation renders' forward
    runs beside them), the wrappers' launches (the eager first sub-step and
    the capture) and the graph's one capture and replays, the profiled
    window's trace holding every fused run in it, eval's launches (one
    forward a chunk), the plain MLP path never called in fit and only in
    eval's coarse pass, the last checkpoint reloaded bit for bit, the
    logged loss falling, and the trained checkpoint's PSNR above the
    untrained one's on the test split and by ENTRY_SEEN_MARGIN on the
    training views.  Returns the wrappers' launches of each kernel on both
    paths and fit's graph counts."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from nerf_fl_torch import eval as ev
    from nerf_fl_torch import opt, train
    from nerf_fl_torch.data.synthetic import make_blender_scene
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.training import build_params, checkpoints
    from nerf_fl_torch.training.optimizers import named_leaves
    from nerf_fl_torch.training.system import config_from_hparams, \
        val_chunk_cap

    plain, restore = _count_plain()
    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        os.chdir(tmp)
        t0 = time.perf_counter()
        make_blender_scene("scene", **ENTRY_SCENE)
        print(f"[entry] scene of {ENTRY_SCENE} written in "
              f"{time.perf_counter() - t0:.1f} s")
        hp = opt.get_opts(["--root_dir", "scene", *ENTRY_MODEL, *ENTRY_TRAIN,
                           "--exp_name", "smoke", "--save_path", "ckpts",
                           "--profile_dir", "prof"])

        # the main path: counts at 0 just before fit, read just after.  The
        # wrappers count their host calls: the eager first sub-step's and
        # the capture's (a replay makes none); the kernels count their runs
        # on the card, replays included
        fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
        runs0 = fm.kernel_runs()
        t0 = time.perf_counter()
        system = train.main(hp)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fwd, bwd = (fm.fused_mlp_fwd_cuda.launches,
                    fm.fused_mlp_bwd_cuda.launches)
        rf, rb = (b - a for a, b in zip(runs0, fm.kernel_runs()))
        calls = plain["calls"]
        steps = system.global_step
        chunk = val_chunk_cap(hp.chunk, hp.N_samples, hp.N_importance)
        val_chunks = (1 + hp.num_epochs) * -(-400 * 400 // chunk)
        graph = system.train_step.graph
        print(f"[entry] fit: {steps} sub-steps in {fit_s:.1f} s (setup, "
              f"configure, sanity val, 2 epochs, vals, checkpoints); fused "
              f"kernels run on the card (their own count): forward {rf} = "
              f"2 x {steps} sub-steps + 2 x {val_chunks} validation chunks: "
              f"{rf - 2 * val_chunks} in the steps "
              f"({(rf - 2 * val_chunks) / steps:g} a sub-step), backward "
              f"{rb} ({rb / steps:g} a sub-step); "
              f"the wrappers' launches {fwd} / {bwd} (the eager first "
              f"sub-step's and the capture's, + 2 a validation chunk); graph "
              f"captured {graph.captures} time(s), {graph.fused_launches} "
              f"fused launches recorded, replayed {graph.replays} times; "
              f"plain MLP path calls {calls}")
        if (rf, rb) != (2 * steps + 2 * val_chunks, 2 * steps) \
                or (fwd, bwd) != (4 + 2 * val_chunks, 4) \
                or graph.fused_launches != (2, 2) or graph.captures != 1 \
                or graph.replays != steps - 1 or calls != 0 \
                or steps != 2500:
            fail(f"fit: {steps} sub-steps, fused kernel runs {(rf, rb)}, "
                 f"wrapper launches {(fwd, bwd)}, {graph.captures} captures "
                 f"recording {graph.fused_launches}, {graph.replays} "
                 f"replays, plain MLP path calls {calls}; expected 2500, 2 + "
                 f"2 a sub-step (+ 2 a validation chunk), 2 + 2 for the "
                 f"eager sub-step and 2 + 2 for the capture (+ the chunks), "
                 f"1 capture of (2, 2), 2499 replays, 0")
        train_launches = (fwd, bwd)
        train_graph = {"captures": graph.captures,
                       "captured_launches": graph.fused_launches,
                       "replays": graph.replays, "runs": (rf, rb)}
        for st in system.epoch_stats:
            print(f"[entry] fit epoch {st['epoch']}: {st['steps']} steps "
                  f"in {st['seconds']:.2f} s, {st['rays_per_sec']:.0f} "
                  f"rays/s ({1e3 * st['seconds'] / st['steps']:.2f} ms a "
                  f"step; the bare graph step of phase 6 {graph_ms:.2f} ms, "
                  f"{BATCH / graph_ms * 1e3:.0f} rays/s); val PSNR "
                  f"{st['val_psnr']:.2f}; val + checkpoint "
                  f"{st['val_and_ckpt_seconds']:.2f} s")
        rows = [json.loads(line) for line in
                open(os.path.join("logs", "smoke", "metrics.jsonl"))]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        rps = [r["train/rays_per_sec"] for r in rows
               if "train/rays_per_sec" in r]
        print(f"[entry] logged train/loss: first {losses[0]:.4f}, last "
              f"{losses[-1]:.4f} ({len(losses)} rows); last logged "
              f"train/rays_per_sec {rps[-1]:.0f}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail("the logged training loss did not fall")
        win = system.profile_window
        if win is None:
            fail("fit wrote no --profile_dir trace")
        busy, kf, kb = _trace_busy(win)
        ms = win["seconds"] * 1e3
        wf, wb = win["fused_runs"]
        print(f"[entry] --profile_dir window: {win['steps']} sub-steps in "
              f"{ms:.1f} ms ({ms / win['steps']:.2f} ms a sub-step, "
              f"profiled); device busy {busy * 1e3:.1f} ms: "
              f"busy {100 * busy / win['seconds']:.1f}%, idle "
              f"{100 * (1 - busy / win['seconds']):.1f}%; fused forward / "
              f"backward kernels by name in the trace {kf} / {kb}, run as "
              f"the kernels count them {wf} / {wb} ({kf / win['steps']:g} / "
              f"{kb / win['steps']:g} a sub-step)")
        if not (kf, kb) == (wf, wb) == (2 * win["steps"], 2 * win["steps"]):
            fail(f"the profiled window of fit: {win['steps']} sub-steps, "
                 f"{kf} / {kb} fused kernels in the trace, {wf} / {wb} run; "
                 f"expected 2 + 2 a sub-step in both")

        # the last checkpoint reloads bit for bit
        path = os.path.join("ckpts", "smoke", "epoch=1.ckpt")
        ck = checkpoints.load_checkpoint(path)
        cfg = config_from_hparams(hp, True)
        fresh = build_params(cfg, hp.N_vocab, device=torch.device("cuda"))
        checkpoints.load_into(fresh, ck)
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(named_leaves(system.params), named_leaves(fresh)))
        print(f"[entry] {path}: epoch {ck['epoch']}, step "
              f"{ck['global_step']}, reloads bit for bit: {same}")
        if not same or ck["global_step"] != steps:
            fail("the checkpoint does not reload into the trained params")
        untrained = os.path.join("ckpts", "untrained.ckpt")
        checkpoints.save_checkpoint(untrained, build_params(
            cfg, hp.N_vocab, generator=torch.Generator().manual_seed(0),
            device=torch.device("cuda")))
        del system, fresh

        # eval: the untrained checkpoint, then the main path (the trained
        # one) with counts at 0 just before and read just after
        results = {}
        for name, ckpt in (("untrained", untrained), ("trained", path)):
            args = ev.get_opts(["--root_dir", "scene", *ENTRY_MODEL,
                                "--split", "test", "--compute_ssim",
                                "--video_format", "gif", "--ckpt_path", ckpt,
                                "--scene_name", name])
            fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
            plain["calls"] = 0
            stats = {}
            psnr = ev.main(args, stats=stats)
            results[name] = (psnr, float(np.mean(stats["ssim"])), stats,
                             fm.fused_mlp_fwd_cuda.launches,
                             fm.fused_mlp_bwd_cuda.launches, plain["calls"])
        psnr, ssim, stats, efwd, ebwd, ecalls = results["trained"]
        n_chunks = ENTRY_SCENE["n_test"] * -(-400 * 400 // val_chunk_cap(
            args.chunk, args.N_samples, args.N_importance))
        margin = psnr - results["untrained"][0]
        print(f"[entry] eval, test split: trained PSNR {psnr:.3f} SSIM "
              f"{ssim:.4f}; untrained PSNR {results['untrained'][0]:.3f} "
              f"SSIM {results['untrained'][1]:.4f}; margin {margin:+.3f} dB")
        n_frames = len(stats["frame_s"])
        print(f"[entry] eval: {n_frames} frames in "
              f"{1e3 * stats['total_s']:.1f} ms, "
              f"{1e3 * stats['total_s'] / n_frames:.1f} ms a frame (the "
              f"first frame's kernels used first here: the untrained "
              f"checkpoint's eval ran before)")
        for i, (p_s, d_s, h_s) in enumerate(zip(
                stats["dispatch_s"], stats["drain_s"], stats["host_s"])):
            print(f"[entry] eval frame {i + 1}: dispatch {1e3 * p_s:.1f} ms "
                  f"(queues the chunks, reads back all but the last 4), "
                  f"drain {1e3 * d_s:.1f} ms, host {1e3 * h_s:.1f} ms")
        print(f"[entry] eval: fused forward launches {efwd} for {n_chunks} "
              f"chunks, backward {ebwd}; the sigma-only coarse pass's plain "
              f"MLP calls {ecalls}")
        # both checkpoints on the training views (frame 0 as trained, the
        # others unperturbed but with their own embeddings): what training
        # learnt where the 8-view scene cannot generalise
        seen = {name: ev.main(ev.get_opts([
            "--root_dir", "scene", *ENTRY_MODEL, "--split", "test_train",
            "--ckpt_path", ckpt, "--scene_name", f"seen_{name}"]), stats={})
            for name, ckpt in (("untrained", untrained), ("trained", path))}
        seen_margin = seen["trained"] - seen["untrained"]
        print(f"[entry] eval, test_train split (the {ENTRY_SCENE['n_train']} "
              f"training views): trained PSNR {seen['trained']:.3f}, "
              f"untrained {seen['untrained']:.3f}; margin "
              f"{seen_margin:+.3f} dB (gate {ENTRY_SEEN_MARGIN:g})")
        if not margin > 0:
            fail("the trained checkpoint does not beat the untrained one")
        if not seen_margin >= ENTRY_SEEN_MARGIN:
            fail(f"on its training views the trained checkpoint beats the "
                 f"untrained one by {seen_margin:.3f} dB, under "
                 f"{ENTRY_SEEN_MARGIN:g}")
        # the plain MLP runs only in the sigma-only coarse pass, once a
        # chunk, as in the JAX package's eval; the fine pass is fused
        if (efwd, ebwd, ecalls) != (n_chunks, 0, n_chunks) or \
                not os.path.exists(os.path.join(
                    "results", "blender", "trained", "trained.gif")):
            fail(f"eval: fused launches {(efwd, ebwd)}, plain MLP calls "
                 f"{ecalls}, expected ({n_chunks}, 0) and {n_chunks}, or no "
                 f"gif")
        return {"train_cli": train_launches, "eval_cli": (efwd, ebwd),
                "train_graph": train_graph}
    finally:
        restore()
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)


# the in-the-wild entry-points phase: a Phototourism photo collection
# (three COLMAP cameras, sparse brandenburg-style ids, JPEG images) from
# its ray cache, and an LLFF capture at fern's 504 x 378, each trained and
# evaluated through the entry points at the flagship width
TOUR_SCENE = dict(n_images=40, sizes=[384, 320, 256], n_points=2000)
TOUR_DOWNSCALE = 2
LLFF_SCENE = dict(n_images=8, width=504, height=378,
                  focal=407.5)       # fern's focal (3260 px at 4032) at 504
WILD_MODEL = ENTRY_MODEL[3:]         # the flagship flags without --img_wh
WILD_TRAIN = ["--batch_size", "1024", "--optimizer", "adam", "--lr", "5e-4",
              "--lr_scheduler", "cosine", "--steps_per_execution", "20",
              "--device_pool", "on", "--refresh_every", "500"]
# LLFF's spiral test path: 120 frames, rendered at a third of the training
# size (the same NDC scene: the focal scales with img_wh) to keep the
# phase inside its time
LLFF_TEST_WH = ["168", "126"]
# on its own training views the trained checkpoint must beat the untrained
# one by this many dB: 2 epochs fit the 39 views of a plain ball on black
# (phase 8 saw +12.6 dB on its 8 textured views), where the untrained net
# renders a grey haze
TOUR_SEEN_MARGIN = 5.0
WILD_PATHS = ("tour_train_cli", "tour_eval_cli", "llff_train_cli",
              "llff_eval_cli")


def _wild_fit(hp, plain, val_rays, label, graph_ms):
    """Train through ``nerf_fl_torch.train.main`` with the counts at 0 just
    before and read just after, and hold fit to its gates: 2 + 2 fused
    kernel runs a sub-step on the card (+ 2 forward runs a validation
    chunk), the wrappers' launches of the eager first sub-step and the
    capture, one capture replayed for every later sub-step, no plain MLP
    call, a falling logged loss.  Returns (system, wrapper launches, graph
    counts, fit seconds)."""
    import numpy as np
    import torch
    from nerf_fl_torch import train
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.training.system import val_chunk_cap

    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    plain["calls"] = 0
    runs0 = fm.kernel_runs()
    t0 = time.perf_counter()
    system = train.main(hp)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = fm.fused_mlp_fwd_cuda.launches, fm.fused_mlp_bwd_cuda.launches
    rf, rb = (b - a for a, b in zip(runs0, fm.kernel_runs()))
    calls = plain["calls"]
    steps = system.global_step
    want_steps = system.batcher.steps_per_epoch() * hp.num_epochs
    chunk = val_chunk_cap(hp.chunk, hp.N_samples, hp.N_importance)
    val_chunks = (1 + hp.num_epochs) * -(-val_rays // chunk)
    graph = system.train_step.graph
    print(f"[{label}] fit: {steps} sub-steps in {fit_s:.1f} s (setup, "
          f"configure, sanity val, {hp.num_epochs} epoch(s), vals, "
          f"checkpoints); fused kernels run on the card (their own count): "
          f"forward {rf} = 2 x {steps} sub-steps + 2 x {val_chunks} "
          f"validation chunks, backward {rb} ({rb / steps:g} a sub-step); "
          f"the wrappers' launches {fwd} / {bwd}; graph captured "
          f"{graph.captures} time(s), {graph.fused_launches} fused launches "
          f"recorded, replayed {graph.replays} times; plain MLP path calls "
          f"{calls}")
    if (rf, rb) != (2 * steps + 2 * val_chunks, 2 * steps) \
            or (fwd, bwd) != (4 + 2 * val_chunks, 4) \
            or graph.fused_launches != (2, 2) or graph.captures != 1 \
            or graph.replays != steps - 1 or calls != 0 \
            or steps != want_steps:
        fail(f"{label} fit: {steps} sub-steps (expected {want_steps}), "
             f"fused kernel runs {(rf, rb)}, wrapper launches {(fwd, bwd)}, "
             f"{graph.captures} captures recording {graph.fused_launches}, "
             f"{graph.replays} replays, plain MLP path calls {calls}")
    for st in system.epoch_stats:
        print(f"[{label}] fit epoch {st['epoch']}: {st['steps']} steps in "
              f"{st['seconds']:.2f} s, {st['rays_per_sec']:.0f} rays/s "
              f"({1e3 * st['seconds'] / st['steps']:.2f} ms a step; the bare "
              f"graph step of phase 6 {graph_ms:.2f} ms, "
              f"{BATCH / graph_ms * 1e3:.0f} rays/s); val PSNR "
              f"{st['val_psnr']:.2f}; val + checkpoint "
              f"{st['val_and_ckpt_seconds']:.2f} s")
    rows = [json.loads(line) for line in
            open(os.path.join("logs", hp.exp_name, "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    print(f"[{label}] logged train/loss: first {losses[0]:.4f}, last "
          f"{losses[-1]:.4f} ({len(losses)} rows)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{label}: the logged training loss did not fall")
    return system, (fwd, bwd), {"captures": graph.captures,
                                "captured_launches": graph.fused_launches,
                                "replays": graph.replays,
                                "runs": (rf, rb)}, fit_s


def _wild_reload(system, hp, path, label, init_poses=None):
    """The last checkpoint reloads bit for bit, the pose table (its
    buffer too) included; returns the loaded checkpoint."""
    import torch
    from nerf_fl_torch.training import build_params, checkpoints
    from nerf_fl_torch.training.optimizers import named_leaves
    from nerf_fl_torch.training.system import config_from_hparams
    ck = checkpoints.load_checkpoint(path)
    cfg = config_from_hparams(hp, system.train_dataset.white_back)
    blank = None if init_poses is None else 0 * init_poses
    fresh = build_params(cfg, hp.N_vocab, device=torch.device("cuda"),
                         init_poses=blank)
    checkpoints.load_into(fresh, ck)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(named_leaves(system.params), named_leaves(fresh)))
    if init_poses is not None:
        same = same and torch.equal(system.params["learn_poses"].init_c2w,
                                    fresh["learn_poses"].init_c2w)
    print(f"[{label}] {path}: epoch {ck['epoch']}, step {ck['global_step']}, "
          f"reloads bit for bit (pose table included): {same}")
    if not same or ck["global_step"] != system.global_step:
        fail(f"{label}: the checkpoint does not reload into the trained "
             f"params")
    return cfg


def _wild_eval(argv, plain, frame_rays, label, video):
    """One eval through ``nerf_fl_torch.eval.main`` with --save_depth and
    --video_format mp4, counts at 0 just before and read just after: one
    fused forward launch and one plain (coarse, sigma-only) MLP call a
    chunk (``frame_rays``: each frame's rays), every PFM reading back to
    the depth eval rendered, and the mp4 fallback line and the GIF exactly
    where the JAX CLI writes a video.  Returns (PSNR, stats, fused
    launches)."""
    import contextlib
    import io
    import numpy as np
    from nerf_fl_torch import eval as ev
    from nerf_fl_torch.data.pfm import read_pfm
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.training.system import val_chunk_cap

    args = ev.get_opts(argv + ["--save_depth", "--video_format", "mp4"])
    chunk = val_chunk_cap(args.chunk, args.N_samples, args.N_importance)
    n_chunks = sum(-(-r // chunk) for r in frame_rays)
    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    plain["calls"] = 0
    stats, out = {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        psnr = ev.main(args, stats=stats)
    text = out.getvalue()
    efwd, ebwd = fm.fused_mlp_fwd_cuda.launches, fm.fused_mlp_bwd_cuda.launches
    calls = plain["calls"]
    res = os.path.join("results", args.dataset_name, args.scene_name)
    n_frames = len(stats["frame_s"])
    pfm_ok = len(stats["depth"]) == n_frames and all(
        np.array_equal(read_pfm(os.path.join(res, f"depth_{i:03d}.pfm"))[0],
                       d) for i, d in enumerate(stats["depth"]))
    line = "[eval] mp4 writer unavailable" in text
    gif = os.path.exists(os.path.join(res, f"{args.scene_name}.gif"))
    print(f"[{label}] eval {args.split} ({args.scene_name}): {n_frames} "
          f"frames in {1e3 * stats['total_s']:.1f} ms, "
          f"{1e3 * stats['total_s'] / n_frames:.1f} ms a frame; PSNR "
          f"{psnr if psnr is None else round(float(psnr), 3)}; fused forward "
          f"launches {efwd} for {n_chunks} chunks, backward {ebwd}, plain "
          f"MLP calls {calls}; PFM depth read back equal: {pfm_ok}; mp4 "
          f"fallback line {line}, GIF {gif} (a video expected: {video})")
    if (efwd, ebwd, calls) != (n_chunks, 0, n_chunks) or not pfm_ok \
            or line != video or gif != video:
        fail(f"{label} eval {args.split}: fused launches {(efwd, ebwd)}, "
             f"plain MLP calls {calls}, expected ({n_chunks}, 0) and "
             f"{n_chunks}; PFM equal {pfm_ok}; fallback line {line} and GIF "
             f"{gif}, expected {video}")
    return psnr, stats, efwd


def phase_wild_entry_points(graph_ms):
    """Phototourism and LLFF through the port's entry points, in a
    temporary directory.  Phototourism: write TOUR_SCENE with the port's
    generator (JPEGs from its encoder), decode every image, build the ray
    cache with ``nerf_fl_torch.prepare_phototourism.main``, hold a dataset
    built from the cache to the one built from the images bit for bit,
    train 2 epochs from the cache (camera-frame rays posed on the card from
    the frozen pose table), and evaluate val and test_train for the
    trained and an untrained checkpoint.  LLFF: write LLFF_SCENE, train 1
    epoch in NDC and evaluate val and the spiral test path.  Gates: those
    of ``_wild_fit``, ``_wild_reload`` and ``_wild_eval``, the pose table
    after fit bit for bit its initial values, and the trained checkpoint
    above the untrained one on the training views by TOUR_SEEN_MARGIN.
    Prints the data layer's host seconds.  Returns the wrappers' launches
    of each kernel on the four paths and fit's graph counts."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from nerf_fl_torch import opt
    from nerf_fl_torch import prepare_phototourism as prep
    from nerf_fl_torch.data.jpeg import read_jpeg
    from nerf_fl_torch.data.phototourism import PhototourismDataset
    from nerf_fl_torch.data.synthetic import (make_llff_scene,
                                              make_phototourism_scene)
    from nerf_fl_torch.training import build_params, checkpoints

    plain, restore = _count_plain()
    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_wild_")
    out = {}
    try:
        os.chdir(tmp)
        # ---- the data layer's host seconds
        host = {}
        t0 = time.perf_counter()
        make_phototourism_scene("tour", **TOUR_SCENE)
        host["scene write"] = time.perf_counter() - t0
        names = sorted(os.listdir(os.path.join("tour", "dense", "images")))
        t0 = time.perf_counter()
        for n in names:
            read_jpeg(os.path.join("tour", "dense", "images", n))
        host["JPEG decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        images = prep.main(prep.get_opts(["--root_dir", "tour",
                                          "--img_downscale",
                                          str(TOUR_DOWNSCALE)]))
        host["prepare_phototourism"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cached = PhototourismDataset("tour", "train", TOUR_DOWNSCALE,
                                     use_cache=True)
        host["dataset from the cache"] = time.perf_counter() - t0
        same = all(np.array_equal(np.asarray(getattr(cached, k)),
                                  getattr(images, k))
                   for k in ("all_rays", "all_ts", "all_rgbs"))
        print(f"[tour] data layer, host seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in host.items()) + f" ({len(names)} "
            f"JPEGs of {TOUR_SCENE['sizes']} px, {len(images.all_rays):,} "
            f"train rays at img_downscale {TOUR_DOWNSCALE}); the dataset "
            f"from the cache equals the one from the images: {same}")
        if not same:
            fail("a dataset built from the ray cache differs from one "
                 "built from the images")
        del images, cached

        # ---- Phototourism: train from the cache, then eval
        tour = ["--dataset_name", "phototourism", "--root_dir", "tour",
                "--img_downscale", str(TOUR_DOWNSCALE), "--use_cache"]
        hp = opt.get_opts(tour + WILD_MODEL + WILD_TRAIN + [
            "--num_epochs", "2", "--exp_name", "tour", "--save_path",
            "ckpts"])
        val_side = TOUR_SCENE["sizes"][0] // TOUR_DOWNSCALE
        system, train_l, graph, _ = _wild_fit(hp, plain, val_side ** 2,
                                              "tour", graph_ms)
        poses = system.params["learn_poses"]
        frozen = (not poses.r.requires_grad and not poses.t.requires_grad
                  and float(poses.r.abs().max()) == 0.0
                  and float(poses.t.abs().max()) == 0.0
                  and torch.equal(poses.init_c2w.cpu(),
                                  torch.from_numpy(system.init_poses)))
        print(f"[tour] pose table of {len(system.init_poses)} cameras (ids "
              f"mapped by id_to_cam of {len(system.id_to_cam)} rows) after "
              f"fit bit for bit its initial values: {frozen}")
        if not frozen:
            fail("the frozen pose table moved during fit")
        path = os.path.join("ckpts", "tour", "epoch=1.ckpt")
        cfg = _wild_reload(system, hp, path, "tour", system.init_poses)
        untrained = os.path.join("ckpts", "tour_untrained.ckpt")
        checkpoints.save_checkpoint(untrained, build_params(
            cfg, hp.N_vocab, generator=torch.Generator().manual_seed(0),
            device=torch.device("cuda")))
        del system
        sides = [TOUR_SCENE["sizes"][n % 3] // TOUR_DOWNSCALE
                 for n in range(TOUR_SCENE["n_images"] - 1)]
        seen, launches = {}, 0
        for name, ckpt in (("untrained", untrained), ("trained", path)):
            argv = tour + WILD_MODEL + ["--ckpt_path", ckpt]
            _, _, f1 = _wild_eval(argv + ["--split", "val", "--scene_name",
                                          f"val_{name}"], plain,
                                  [val_side ** 2], "tour", False)
            seen[name], stats, f2 = _wild_eval(
                argv + ["--split", "test_train", "--scene_name",
                        f"seen_{name}"], plain, [s * s for s in sides],
                "tour", False)
            launches = f1 + f2
        margin = seen["trained"] - seen["untrained"]
        print(f"[tour] eval, test_train split (the "
              f"{TOUR_SCENE['n_images'] - 1} training views): trained PSNR "
              f"{seen['trained']:.3f}, untrained {seen['untrained']:.3f}; "
              f"margin {margin:+.3f} dB (gate {TOUR_SEEN_MARGIN:g})")
        if not margin >= TOUR_SEEN_MARGIN:
            fail(f"on its training views the trained checkpoint beats the "
                 f"untrained one by {margin:.3f} dB, under "
                 f"{TOUR_SEEN_MARGIN:g}")
        out["tour_train_cli"], out["tour_graph"] = train_l, graph
        out["tour_eval_cli"] = (launches, 0)

        # ---- LLFF: 1 epoch in NDC, then val and the spiral
        t0 = time.perf_counter()
        make_llff_scene("llff", **LLFF_SCENE)
        print(f"[llff] scene of {LLFF_SCENE} written in "
              f"{time.perf_counter() - t0:.2f} s")
        wh = [str(LLFF_SCENE["width"]), str(LLFF_SCENE["height"])]
        llff = ["--dataset_name", "llff", "--root_dir", "llff"]
        hp = opt.get_opts(llff + ["--img_wh", *wh] + WILD_MODEL + WILD_TRAIN
                          + ["--num_epochs", "1", "--exp_name", "llff",
                             "--save_path", "ckpts"])
        n_px = LLFF_SCENE["width"] * LLFF_SCENE["height"]
        system, train_l, graph, _ = _wild_fit(hp, plain, n_px, "llff",
                                              graph_ms)
        path = os.path.join("ckpts", "llff", "epoch=0.ckpt")
        _wild_reload(system, hp, path, "llff")
        del system
        argv = llff + WILD_MODEL + ["--ckpt_path", path]
        psnr, _, f1 = _wild_eval(argv + ["--img_wh", *wh, "--split", "val",
                                         "--scene_name", "val"], plain,
                                 [n_px], "llff", True)
        test_px = int(LLFF_TEST_WH[0]) * int(LLFF_TEST_WH[1])
        _, stats, f2 = _wild_eval(argv + ["--img_wh", *LLFF_TEST_WH,
                                          "--split", "test", "--scene_name",
                                          "spiral"], plain,
                                  [test_px] * 120, "llff", True)
        print(f"[llff] val PSNR {psnr:.3f} (a held-out view after 1 epoch)")
        out["llff_train_cli"], out["llff_graph"] = train_l, graph
        out["llff_eval_cli"] = (f1 + f2, 0)
        return out
    finally:
        restore()
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)


# the BARF and appearance entry-points phase: pose refinement on a textured
# Blender scene with seeded pose noise (an untextured ball leaves the
# poses unobservable), a frozen control arm, eval with --refine_pose and
# with --optimize_appearance, and a short Phototourism fit with
# --refine_pose, all at the flagship width
BARF_SCENE = dict(n_train=8, n_val=1, n_test=2, size=800, texture=True)
BARF_NOISE = ["--pose_noise", "2", "0.02"]      # 2 deg RMS, 2% of distance
BARF_SCHEDULE = ["--barf_schedule", "paper", "--barf_epochs", "0", "2"]
BARF_REFINE = ["--refine_pose", *BARF_SCHEDULE, "--pose_warmup_epochs", "1",
               "--pose_lr_mult", "0.25"]
BARF_TRAIN = ["--dataset_name", "blender", "--batch_size", "1024",
              "--optimizer", "adam", "--lr", "5e-4", "--lr_scheduler",
              "cosine", "--steps_per_execution", "20", "--device_pool", "on",
              "--refresh_every", "500"]
# the JAX package's contract for joint refinement at test scale
# (tests/test_barf_recovery.py:275-276): the aligned errors after fit
# under this multiple of the injected ones
BARF_BOUND = 1.35
# pose and appearance gradients through the fused pair against the plain
# f32 path, norm-relative per tensor: f32 kernels sum the same products in
# another order (the coarse net's ill-conditioning leaves 2e-3 between two
# f32 implementations, ROADMAP C); bf16 rounds every activation and
# cotangent, the limit of tests/test_torch_lockstep.py's bf16 gradients
POSE_GRAD_F32_NORM = 2e-3
POSE_GRAD_BF16_NORM = 0.1
TOUR_BARF_SCENE = dict(n_images=12, sizes=[192, 160, 128], n_points=500)
BARF_PATHS = ("barf_train_cli", "control_train_cli", "barf_eval_cli",
              "opt_a_eval_cli", "tour_barf_train_cli")


class _BarfProbe:
    """Records, for every call of a captured train step, the epoch tensor
    the call filled and the BARF weights (xyz band) that the call's last
    replay computed from it: a copy into a fixed buffer is captured into
    the graph beside each fused forward (nothing is copied in an eager
    call).  Both reads are device copies, so the step is never synced."""

    def __init__(self, n_freqs):
        import torch
        import nerf_fl_torch.render.renderer as renderer
        from nerf_fl_torch.training import system as tsys
        self.buf = torch.full((n_freqs,), float("nan"), device="cuda")
        self.calls = []
        self._renderer, self._fused = renderer, renderer.fused_apply_nerf
        self._cls, self._run = tsys._StepGraph, tsys._StepGraph.run
        probe = self

        def fused(*a, **k):
            w = k.get("barf_w_xyz")
            if w is not None and torch.cuda.is_current_stream_capturing():
                probe.buf.copy_(w)
            return probe._fused(*a, **k)

        def run(graph, *a, **k):
            out = probe._run(graph, *a, **k)
            probe.calls.append((graph.epoch.clone(), probe.buf.clone()))
            return out

        renderer.fused_apply_nerf = fused
        tsys._StepGraph.run = run

    def restore(self):
        self._renderer.fused_apply_nerf = self._fused
        self._cls.run = self._run


def _grad_parity(dev, scene, wh):
    """One flagship batch of camera-frame rays, BARF at epoch 1 of 0-2
    (half the bands on): the gradients of the pose deltas and of the
    appearance table through the fused pair (bf16 and f32) against the
    plain f32 MLP path, norm-relative per tensor."""
    import numpy as np
    import torch
    from nerf_fl_torch.data.blender import BlenderDataset
    from nerf_fl_torch.models.poses import perturb_poses
    from nerf_fl_torch.render import RenderConfig, render_rays
    from nerf_fl_torch.training import build_params
    from nerf_fl_torch.training.losses import nerfw_loss
    from nerf_fl_torch.training.system import assemble_world_rays

    ds = BlenderDataset(scene, "train", img_wh=(wh, wh), refine_pose=True)
    init = np.concatenate([ds.poses, np.tile(np.array(
        [[[0, 0, 0, 1]]], np.float32), (len(ds.poses), 1, 1))], 1)
    noisy = perturb_poses(init, 2.0, 0.02, seed=0)
    idx = np.random.default_rng(0).choice(len(ds.all_rays), BATCH,
                                          replace=False)
    rays, ts, rgbs = (torch.from_numpy(np.ascontiguousarray(x[idx])).to(dev)
                      for x in (ds.all_rays, ds.all_ts, ds.all_rgbs))
    barf = dict(refine_pose=True, barf_schedule="paper", barf_epoch_start=0,
                barf_epoch_end=2)
    grads = {}
    for name, over in (("plain_f32", dict(compute_dtype="float32",
                                          use_fused=False)),
                       ("fused_f32", dict(compute_dtype="float32")),
                       ("fused_bf16", {})):
        cfg = RenderConfig(**{**FLAGSHIP, **barf, **over})
        params = build_params(cfg, N_VOCAB,
                              generator=torch.Generator().manual_seed(0),
                              device=dev, init_poses=noisy)
        table = params["learn_poses"]
        world = assemble_world_rays(params, rays, ts, ray_format="camdir")
        res = render_rays(params, world, ts, cfg,
                          epoch=torch.tensor(1.0, device=dev))
        loss = sum(nerfw_loss(res, rgbs).values())
        g = torch.autograd.grad(loss, [table.r, table.t,
                                       params["embedding_a"]])
        grads[name] = [x.detach().double() for x in g]
    ref = grads["plain_f32"]
    out = {}
    for name, limit in (("fused_f32", POSE_GRAD_F32_NORM),
                        ("fused_bf16", POSE_GRAD_BF16_NORM)):
        errs = [float((a - b).norm() / b.norm())
                for a, b in zip(grads[name], ref)]
        out[name] = errs
        print(f"[barf] gradients through the fused pair ({name}) against "
              f"the plain f32 path, {BATCH} camera-frame rays x (64 + 64) "
              f"samples, BARF at epoch 1 of 0-2: norm-relative error "
              f"learn_poses.r {errs[0]:.3e}, learn_poses.t {errs[1]:.3e}, "
              f"embedding_a {errs[2]:.3e} (limit {limit:g}); |grad r| "
              f"{float(ref[0].norm()):.3e}, |grad t| "
              f"{float(ref[1].norm()):.3e}")
        if not all(np.isfinite(e) and e <= limit for e in errs) \
                or not all(float(b.norm()) > 0 for b in ref):
            fail(f"pose / appearance gradients through the fused pair "
                 f"({name}) off the plain f32 path: {errs}, limit {limit}")
    return out


def phase_barf_entry_points(graph_ms):
    """BARF pose refinement and NeRF-W's test-time appearance fit through
    the port's entry points, in a temporary directory: write BARF_SCENE,
    hold the pose and appearance gradients through the fused pair to the
    plain f32 path, train 2 epochs with BARF_NOISE and BARF_REFINE from
    the device pool as a graph of 20 sub-steps (the gates of ``_wild_fit``;
    every call's BARF weights, computed inside the replayed graph from its
    epoch tensor, equal ``barf_weights`` of that call's epoch; the deltas
    exactly 0 in the checkpoint of the warmup epoch and moved after it; the
    aligned pose errors under BARF_BOUND times the injected ones), train a
    frozen control arm (noise, no refinement) 1 epoch whose deltas stay
    exactly 0, evaluate the BARF checkpoint with --refine_pose on
    test_train and with --optimize_appearance on test (each frame's fit
    loss falling, the right half's PSNR finite, 2 fused forward and 1
    fused backward launches an Adam step beside one forward a render
    chunk), and train a Phototourism collection 1 epoch with
    --refine_pose.  Returns the wrappers' launches of each kernel on each
    path and the BARF fit's graph counts."""
    import contextlib
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    from nerf_fl_torch import eval as ev
    from nerf_fl_torch import opt
    from nerf_fl_torch.core.encoding import barf_weights
    from nerf_fl_torch.data.synthetic import (make_blender_scene,
                                              make_phototourism_scene)
    from nerf_fl_torch.models.poses import all_poses, pose_errors
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.training import checkpoints
    from nerf_fl_torch.training.system import val_chunk_cap

    plain, restore = _count_plain()
    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_barf_")
    out = {}
    probe = None
    try:
        os.chdir(tmp)
        t0 = time.perf_counter()
        make_blender_scene("scene", **BARF_SCENE)
        print(f"[barf] scene of {BARF_SCENE} written in "
              f"{time.perf_counter() - t0:.1f} s")
        _grad_parity(torch.device("cuda"), "scene", IMG)

        # ---- BARF fit: counts at 0 just before, read just after
        model = ["--root_dir", "scene", *ENTRY_MODEL]
        hp = opt.get_opts(model + BARF_TRAIN + BARF_NOISE + BARF_REFINE + [
            "--num_epochs", "2", "--exp_name", "barf", "--save_path",
            "ckpts"])
        probe = _BarfProbe(hp.N_emb_xyz)
        system, train_l, graph, _ = _wild_fit(hp, plain, IMG * IMG, "barf",
                                              graph_ms)
        probe.restore()
        epochs = [float(e) for e, _ in probe.calls]
        read = all(torch.equal(w, barf_weights(
            e, hp.N_emb_xyz, 0, 2, schedule="paper", device=e.device))
            for e, w in probe.calls)
        print(f"[barf] the replayed graph's BARF weights after each of "
              f"{len(probe.calls)} calls equal barf_weights of the call's "
              f"epoch tensor: {read} (epochs {epochs[0]:.4f} .. "
              f"{epochs[-1]:.4f}, {len(set(epochs))} distinct; xyz band "
              f"weights after the last call "
              f"{[round(float(x), 4) for x in probe.calls[-1][1]]})")
        if not read or len(set(epochs)) != len(probe.calls) \
                or len(probe.calls) < 2:
            fail("the captured BARF step does not read its epoch tensor at "
                 "each call")
        warm = checkpoints.load_checkpoint(
            os.path.join("ckpts", "barf", "epoch=0.ckpt"))
        held = all(not np.asarray(warm["state_dict"]["learn_poses"][k]).any()
                   for k in ("r", "t"))
        table = system.params["learn_poses"]
        moved = [float(getattr(table, k).detach().abs().max())
                 for k in ("r", "t")]
        r_inj, t_inj = pose_errors(system.init_poses, system.true_poses)
        with torch.no_grad():
            refined = all_poses(table).cpu().numpy()
        r_ref, t_ref = pose_errors(refined, system.true_poses)
        last = system.epoch_stats[-1]
        print(f"[barf] pose deltas after the warmup epoch (epoch=0.ckpt) "
              f"exactly 0: {held}; after fit max |r| {moved[0]:.3e}, max "
              f"|t| {moved[1]:.3e}; aligned pose errors of "
              f"{len(refined)} cameras: rotation {r_inj:.4f} -> "
              f"{r_ref:.4f} deg, translation {t_inj:.5f} -> {t_ref:.5f} "
              f"(gate < {BARF_BOUND:g} x injected); last epoch "
              f"{last['rays_per_sec']:.0f} rays/s = "
              f"{last['rays_per_sec'] / (BATCH / graph_ms * 1e3):.3f} of "
              f"phase 6's bare graph step")
        if not held or min(moved) <= 0.0:
            fail("the pose deltas moved during the warmup or not after it")
        if not (r_ref < BARF_BOUND * r_inj and t_ref < BARF_BOUND * t_inj):
            fail(f"refinement let the poses walk: rotation {r_ref:.4f} / "
                 f"{r_inj:.4f}, translation {t_ref:.5f} / {t_inj:.5f}")
        out["barf_train_cli"], out["barf_graph"] = train_l, graph
        path = os.path.join("ckpts", "barf", "epoch=1.ckpt")
        _wild_reload(system, hp, path, "barf", system.init_poses)
        del system

        # ---- the frozen control arm: noise, no refinement
        hp = opt.get_opts(model + BARF_TRAIN + BARF_NOISE + [
            "--num_epochs", "1", "--exp_name", "control", "--save_path",
            "ckpts"])
        system, ctrl_l, _, _ = _wild_fit(hp, plain, IMG * IMG, "control",
                                         graph_ms)
        table = system.params["learn_poses"]
        still = (not table.r.requires_grad and not table.t.requires_grad
                 and float(table.r.abs().max()) == 0.0
                 and float(table.t.abs().max()) == 0.0)
        print(f"[control] noisy poses without refinement: deltas exactly 0 "
              f"after fit: {still}")
        if not still:
            fail("the frozen control arm moved its pose deltas")
        out["control_train_cli"] = ctrl_l
        del system

        # ---- eval with --refine_pose on the training views
        barf_eval = model + BARF_SCHEDULE + ["--refine_pose", "--ckpt_path",
                                             path]
        args = ev.get_opts(barf_eval + ["--split", "test_train",
                                        "--scene_name", "barf_seen"])
        chunk = val_chunk_cap(args.chunk, args.N_samples, args.N_importance)
        n_chunks = BARF_SCENE["n_train"] * -(-IMG * IMG // chunk)
        fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
        plain["calls"] = 0
        stats = {}
        psnr = ev.main(args, stats=stats)
        efwd, ebwd = fm.fused_mlp_fwd_cuda.launches, \
            fm.fused_mlp_bwd_cuda.launches
        print(f"[barf] eval --refine_pose test_train (the refined training "
              f"poses, at the checkpoint's epoch): PSNR {psnr:.3f}; "
              f"{len(stats['frame_s'])} frames, "
              f"{1e3 * stats['total_s'] / len(stats['frame_s']):.1f} ms a "
              f"frame; fused forward launches {efwd} for {n_chunks} chunks, "
              f"backward {ebwd}, plain MLP calls {plain['calls']}")
        if not np.isfinite(psnr) or (efwd, ebwd, plain["calls"]) != \
                (n_chunks, 0, n_chunks):
            fail(f"eval --refine_pose: PSNR {psnr}, launches {(efwd, ebwd)}"
                 f", plain calls {plain['calls']}")
        out["barf_eval_cli"] = (efwd, ebwd)

        # ---- eval with --optimize_appearance: counts at 0 just before
        args = ev.get_opts(barf_eval + ["--split", "test",
                                        "--optimize_appearance",
                                        "--scene_name", "opt_a"])
        n_frames, steps = BARF_SCENE["n_test"], args.opt_a_steps
        n_chunks = n_frames * -(-IMG * IMG // chunk)
        fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
        plain["calls"] = 0
        runs0 = fm.kernel_runs()
        stats, text = {}, io.StringIO()
        with contextlib.redirect_stdout(text):
            psnr = ev.main(args, stats=stats)
        torch.cuda.synchronize()
        efwd, ebwd = fm.fused_mlp_fwd_cuda.launches, \
            fm.fused_mlp_bwd_cuda.launches
        rf, rb = (b - a for a, b in zip(runs0, fm.kernel_runs()))
        lines = [x for x in text.getvalue().splitlines()
                 if x.startswith("[opt_a]")]
        for x in lines:
            print(x)
        curves = stats["opt_a_losses"]
        falling = len(curves) == n_frames and all(
            np.isfinite(c).all() and c[-1] < c[0] for c in curves)
        want = (n_frames * 2 * steps + n_chunks, n_frames * steps)
        print(f"[opt_a] eval --optimize_appearance test ({n_frames} "
              f"frames, {steps} Adam steps on {args.opt_a_rays} left-half "
              f"rays each): right-half PSNR {psnr:.3f}; fit seconds a frame "
              f"{[round(s, 3) for s in stats['opt_a_s']]}; fit MSE falling "
              f"in every frame: {falling}; fused launches {(efwd, ebwd)}, "
              f"runs on the card {(rf, rb)}, expected {want} (2 forward + 1 "
              f"backward an Adam step, 1 forward a render chunk); plain MLP "
              f"calls {plain['calls']} (the render's sigma-only coarse "
              f"pass)")
        if not (falling and np.isfinite(psnr)) or (efwd, ebwd) != want \
                or (rf, rb) != want or plain["calls"] != n_chunks:
            fail(f"eval --optimize_appearance: falling {falling}, PSNR "
                 f"{psnr}, launches {(efwd, ebwd)} and runs {(rf, rb)}, "
                 f"expected {want}, plain calls {plain['calls']}")
        out["opt_a_eval_cli"] = (efwd, ebwd)
        out["opt_a_s"] = stats["opt_a_s"]

        # ---- Phototourism with --refine_pose
        make_phototourism_scene("tour", **TOUR_BARF_SCENE)
        hp = opt.get_opts(["--dataset_name", "phototourism", "--root_dir",
                           "tour", "--img_downscale", "2", "--refine_pose"]
                          + WILD_MODEL + WILD_TRAIN + [
                              "--num_epochs", "1", "--exp_name", "tour",
                              "--save_path", "ckpts"])
        side = TOUR_BARF_SCENE["sizes"][0] // 2
        system, tour_l, _, _ = _wild_fit(hp, plain, side * side,
                                         "tour_barf", graph_ms)
        table = system.params["learn_poses"]
        moved = [float(getattr(table, k).detach().abs().max())
                 for k in ("r", "t")]
        with torch.no_grad():
            refined = all_poses(table).cpu().numpy()
        drift = pose_errors(refined, system.true_poses)
        print(f"[tour_barf] {len(refined)} cameras: deltas max |r| "
              f"{moved[0]:.3e}, max |t| {moved[1]:.3e}; aligned drift from "
              f"the COLMAP poses rotation {drift[0]:.4f} deg, translation "
              f"{drift[1]:.5f}")
        if not (min(moved) > 0 and np.isfinite(drift).all()):
            fail("Phototourism refinement left its deltas still")
        out["tour_barf_train_cli"] = tour_l
        return out
    finally:
        if probe is not None:
            probe.restore()
        restore()
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)


# the tools phase: the quality gate's card preset and the scale stress's,
# through the entry points in child processes, and the offline tools
TOOLS_JOBS = 4             # quality-gate arms at a time on the card
# every arm's test PSNR must be finite and above this floor, the JAX
# package's smoke test's (tests/test_quality_gate.py:93)
TOOLS_PSNR_FLOOR = 5.0
# the share of the profiled window the kernels keep busy: the union of
# their intervals (profile_trace) against the sum of their durations
# (experiments/trace_records.read_trace), which agree where no two kernels
# overlap
TOOLS_BUSY_AGREE = 1e-3
# GEMM kernels (cuBLAS's, nvjet on Hopper, or CUTLASS's) in a train step's
# trace mean that the plain MLP path ran: the fused step has none
GEMM_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
# the paths of phase 12 in the kernels line: the gate's and the scale
# stress's train and eval children, as their logs count them, and this
# process's evals of the stripped and the full checkpoint
TOOLS_PATHS = ("quality_gate_cli", "scale_stress_cli", "tools_eval_cli")


def _child(args, log, timeout):
    """Run ``python -m <args>`` from the checkout into ``log``; fails with
    its tail unless it exits 0.  Returns its seconds."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", *args], cwd=HERE,
                            stdout=f, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    if rc != 0:
        fail(f"python -m {' '.join(args)} exited {rc}:\n"
             f"{open(log).read()[-3000:]}")
    return time.perf_counter() - t0


def _arm_runs(name, k, steps_per_epoch, epochs, val_chunks):
    """Fail unless a training child's kernel count is the graph step's: 2 +
    2 runs a sub-step on the card (+ 2 forward a validation chunk), the
    wrappers' launches those of the eager first sub-step and the capture."""
    steps = steps_per_epoch * epochs
    want = {"steps": steps, "runs": [2 * steps + 2 * val_chunks, 2 * steps],
            "launches": [4 + 2 * val_chunks, 4]}
    got = {key: k[key] for key in want} if k else None
    if got != want:
        fail(f"{name}: the fused kernels' count of the run {got}, expected "
             f"{want}")


def phase_tools(graph_ms):
    """The port's tools on the card: ``nerf_fl_torch.tools.quality_gate
    --preset card`` (7 arms trained and 8 evaluations through ``python -m
    nerf_fl_torch.train`` / ``.eval``, TOOLS_JOBS at a time; each arm's
    fused kernel runs 2 + 2 a sub-step as its log counts them), a second
    run that trains and evaluates nothing, every PSNR finite and above
    TOOLS_PSNR_FLOOR, the artifacts in the workdir; ``profile_trace`` over
    the co_nerfw arm's --profile_dir window (2 + 2 fused kernels a sub-step,
    no GEMM, the busy share agreeing with trace_records'); ``save_weights_
    only`` on that arm's checkpoint, whose eval gives the full one's Mean
    PSNR bit for bit; ``gen_nerf_tsv`` on phase 10's Phototourism scene,
    its tsv byte for byte; and ``scale_stress --preset card`` beside the
    gate (the cache built, the eval PSNR finite, each stage's seconds, the
    peak RSS and the train rays/s).  Returns the children's and this
    process's fused launches by path."""
    import shutil
    import tempfile
    import numpy as np
    from nerf_fl_torch import eval as ev
    from nerf_fl_torch.data import RayBatcher
    from nerf_fl_torch.data.synthetic import make_phototourism_scene
    from nerf_fl_torch.experiments.trace_records import read_trace
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.tools import (gen_nerf_tsv, profile_trace,
                                     quality_gate as qg, save_weights_only)
    from nerf_fl_torch.training.system import val_chunk_cap

    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_tools_")
    stress = None
    try:
        os.chdir(tmp)
        t_phase = time.perf_counter()
        # the scale stress runs beside the gate, in a child of its own
        ss_ws = os.path.join(tmp, "stress")
        ss_log = open(os.path.join(tmp, "stress.log"), "w")
        stress = subprocess.Popen(
            [sys.executable, "-m", "nerf_fl_torch.tools.scale_stress",
             "--preset", "card", "--workdir", ss_ws], cwd=HERE,
            stdout=ss_log, stderr=subprocess.STDOUT)

        ws = os.path.join(tmp, "qg")
        gate = ["nerf_fl_torch.tools.quality_gate", "--preset", "card",
                "--workdir", ws, "--jobs", str(TOOLS_JOBS)]
        gate_s = _child(gate + ["--arm_timeout", "400"],
                        os.path.join(tmp, "gate.log"), 600)
        res = json.load(open(os.path.join(ws, "QUALITY_GATE.json")))
        p = qg.PRESETS["card"]
        psnr = res["psnr"]
        print(f"[tools] quality_gate --preset card: {res['arms_trained']} "
              f"arms trained, {res['evals_run']} evaluations in "
              f"{gate_s:.1f} s ({TOOLS_JOBS} at a time); test PSNR "
              + ", ".join(f"{k} {v:.2f}" for k, v in psnr.items()))
        if (res["arms_trained"], res["evals_run"]) != (7, 8) \
                or not res["pass"] or len(psnr) != 8 \
                or not all(np.isfinite(v) and v > TOOLS_PSNR_FLOOR
                           for v in psnr.values()) \
                or not os.path.exists(os.path.join(ws, "QUALITY_GATE.md")):
            fail(f"quality gate: {res['arms_trained']} arms trained, "
                 f"{res['evals_run']} evaluations, pass {res['pass']}, PSNR "
                 f"{psnr}; expected 7, 8, a pass, 8 finite PSNRs above "
                 f"{TOOLS_PSNR_FLOOR:g} and the markdown table")
        n_rays = p["n_train"] * p["img_wh"] ** 2
        per_epoch = RayBatcher(np.zeros((n_rays, 8), np.float32),
                               np.zeros(n_rays, np.int32),
                               np.zeros((n_rays, 3), np.float32),
                               p["batch"]).steps_per_epoch()
        val_chunks = (1 + p["epochs"]) * p["n_val"] * -(-p["img_wh"] ** 2 // (
            val_chunk_cap(32 * 1024, *p["samples"])))
        launches = [0, 0]
        for name, k in res["kernels"].items():
            _arm_runs(name, k, per_epoch, p["epochs"], val_chunks)
            launches = [a + b for a, b in zip(launches, k["launches"])]
        print(f"[tools] every arm: {per_epoch * p['epochs']} sub-steps, "
              f"fused runs on the card 2 + 2 a sub-step (+ 2 forward a "
              f"validation chunk, {val_chunks} chunks), as each train "
              f"log's [kernels] line counts them; the children's wrapper "
              f"launches {launches[0]} / {launches[1]}")
        again_s = _child(gate, os.path.join(tmp, "gate2.log"), 120)
        res2 = json.load(open(os.path.join(ws, "QUALITY_GATE.json")))
        print(f"[tools] the gate again: {res2['arms_trained']} arms trained, "
              f"{res2['evals_run']} evaluations in {again_s:.1f} s")
        if (res2["arms_trained"], res2["evals_run"]) != (0, 0) \
                or res2["psnr"] != psnr:
            fail("the second quality-gate run trained or evaluated again")

        # the profiled arm's window: its trace through profile_trace
        win = res["kernels"][p["profile"]]["profile"]
        summary = profile_trace.main(["--trace_dir", win["trace"],
                                      "--steps", str(win["steps"]),
                                      "--top", "12"])
        kernels, _ = read_trace(win["trace"])
        span = max(e["ts"] + e.get("dur", 0) for e in kernels) - \
            min(e["ts"] for e in kernels)
        busy_tr = sum(e.get("dur", 0) for e in kernels) / span
        gemms = sorted({n for n in summary["by_name"]
                        if any(m in n.lower() for m in GEMM_MARKS)})
        print(f"[tools] co_nerfw's --profile_dir window: {win['steps']} "
              f"sub-steps in {1e3 * win['seconds']:.1f} ms (host); fused "
              f"kernels {summary['fused_fwd']} / {summary['fused_bwd']}; "
              f"busy {100 * summary['busy_share']:.2f}% of the kernels' span "
              f"(profile_trace's union), {100 * busy_tr:.2f}% (trace_records' "
              f"sum), {100 * summary['busy_us'] / 1e6 / win['seconds']:.1f}% "
              f"of the host-timed window; GEMM kernels {gemms}")
        if (summary["fused_fwd"], summary["fused_bwd"]) != (
                2 * win["steps"], 2 * win["steps"]) or gemms \
                or abs(summary["busy_share"] - busy_tr) > TOOLS_BUSY_AGREE:
            fail("the profiled arm's window does not hold 2 + 2 fused "
                 "kernels a sub-step and no GEMM, or the busy shares differ")

        # save_weights_only: eval of the slim file, bit for bit the full one's
        arm = [a for a in qg.ARMS if a[0] == p["profile"]][0]
        full = qg.final_ckpt(ws, p, arm[0])
        slim = save_weights_only.main(["--ckpt_path", full])
        fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
        got = {}
        for label, path in (("full", full), ("slim", slim)):
            argv = qg.eval_argv(ws, qg.ensure_fixture(ws, p), p, arm[0],
                                arm[2], eval_name=f"tools_{label}")
            argv[argv.index("--ckpt_path") + 1] = path
            got[label] = ev.main(ev.get_opts(argv))
        eval_launches = (fm.fused_mlp_fwd_cuda.launches,
                         fm.fused_mlp_bwd_cuda.launches)
        print(f"[tools] save_weights_only: {os.path.getsize(slim)} bytes of "
              f"{os.path.getsize(full)}; eval Mean PSNR full {got['full']!r}, "
              f"slim {got['slim']!r}, the gate's {psnr[arm[0]]}; fused "
              f"launches {eval_launches}")
        if not (got["full"] == got["slim"]
                and round(float(got["full"]), 2) == psnr[arm[0]]) \
                or eval_launches[0] == 0:
            fail("eval of the stripped checkpoint differs from the full one")

        # gen_nerf_tsv on phase 10's scene: that scene's own tsv
        t0 = time.perf_counter()
        make_phototourism_scene("tour", **TOUR_SCENE)
        tsv = gen_nerf_tsv.main(["--root_dir", "tour", "--out", "gen.tsv",
                                 "--n_test", "1", "--dataset_name",
                                 "minitour"])
        same = open(tsv, "rb").read() == open(os.path.join(
            "tour", "minitour.tsv"), "rb").read()
        print(f"[tools] gen_nerf_tsv on phase 10's scene "
              f"({TOUR_SCENE['n_images']} images, written in "
              f"{time.perf_counter() - t0:.1f} s): byte for byte its tsv: "
              f"{same}")
        if not same:
            fail("gen_nerf_tsv does not give the scene's tsv")

        # the scale stress
        rc = stress.wait(timeout=400)
        ss_log.close()
        if rc != 0:
            fail(f"scale_stress --preset card exited {rc}:\n"
                 f"{open(ss_log.name).read()[-3000:]}")
        ss = json.load(open(os.path.join(ss_ws, "SCALE_STRESS.json")))
        sk = ss.get("train_kernels")
        print(f"[tools] scale_stress --preset card ({ss['n_images']} images "
              f"of {ss['sizes']} px): scene {ss.get('scene_gen_s')} s, cache "
              f"{ss.get('cache_build_s')} s, COLMAP reader "
              f"{ss['colmap_read_s']} s, JPEG decoder "
              f"{ss['jpeg_decode_s_per_image']} s an image, train "
              f"{ss['train_wall_s']} s (peak RSS {ss['train_peak_rss_mb']} "
              f"MB, {ss['train_rays_per_sec']} rays/s at its last progress "
              f"line; phase 6's graph step {BATCH / graph_ms * 1e3:.0f} "
              f"rays/s), eval {ss['eval_wall_s']} s, val PSNR "
              f"{ss['eval_psnr']}; fused kernels {sk}")
        if not (os.path.exists(os.path.join(ss_ws, "scene", "cache",
                                            "rays2.npy"))
                and ss["eval_psnr"] is not None
                and np.isfinite(ss["eval_psnr"]) and sk
                and sk["runs"][1] == 2 * sk["steps"] > 0
                and sk["runs"][0] >= 2 * sk["steps"]):
            fail("scale stress: no cache, no finite val PSNR, or fused "
                 "kernels off the graph step's 2 + 2 a sub-step")
        print(f"[tools] phase 12 in {time.perf_counter() - t_phase:.1f} s")
        return {"quality_gate_cli": tuple(launches),
                "scale_stress_cli": tuple(sk["launches"]),
                "tools_eval_cli": eval_launches}
    finally:
        if stress is not None and stress.poll() is None:
            stress.kill()
            stress.wait()
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)


def _adam(params):
    from types import SimpleNamespace
    from nerf_fl_torch.training import optimizers
    return optimizers.build_optimizer(
        SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))


def _dp_grads(params):
    """Each leaf's ``.grad``, copied to the host."""
    from nerf_fl_torch.training import optimizers
    return [p.grad.detach().cpu().clone()
            for _, p in optimizers.named_leaves(params) if p.grad is not None]


def _dp_state(params, opt):
    """Params and Adam state, copied to the host."""
    from nerf_fl_torch.training import optimizers
    leaves = [p.detach().cpu().clone()
              for _, p in optimizers.named_leaves(params)]
    state = [{k: v.detach().cpu().clone() for k, v in opt.state[q].items()}
             for g in opt.param_groups for q in g["params"]]
    return leaves, state


def _dp_rank(device, k):
    """Phase 13 (b), one rank of two sharing the card over gloo: the f32
    flagship DP step (K = k) from seed-0 weights and pool; returns the
    params after k sub-steps, the wrappers' launches and the kernels' runs
    of that call, and the ms a sub-step of a second call; rank 0 also
    returns one rank's meshless graph step over the same global batches
    (the same weights, pool and generator) and its ms."""
    import copy
    import torch
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import (build_params, epoch_perm,
                                        make_device_pool_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(devices=multihost.job_devices(device))
    cfg = RenderConfig(**{**FLAGSHIP, "perturb": 1.0,
                          "compute_dtype": "float32"})

    def start():
        gen = torch.Generator(device=device).manual_seed(0)
        params = build_params(cfg, N_VOCAB, generator=gen, device=device)
        return params, train_pool(device, gen)

    def call(run, params, pool, perm, i0, gen):
        return run(params, pool, perm, i0, i0 + k, 5e-4,
                   generator=gen)["train/loss"].cpu()

    def timed(run, params, pool, perm, gen):
        # the same generator and tensors: a replay of the captured graphs
        torch.cuda.synchronize()
        t = time.perf_counter()
        call(run, params, pool, perm, k, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / k

    def first_grads(params, pool, m):
        """The gradient of one eager step from a copy of ``params`` (the
        reduced one under a mesh)."""
        p = copy.deepcopy(params)
        step = make_device_pool_step(cfg, _adam(p), batch_size=BATCH,
                                     mesh=m)
        step(p, pool, perm, 0, 5e-4,
             generator=torch.Generator(device=device).manual_seed(7))
        return _dp_grads(p)

    params, pool = start()
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(device)
    place_params(mesh, params)
    grads = first_grads(params, pool, mesh)
    opt = _adam(params)
    run = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                steps_per_execution=k, mesh=mesh)
    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    runs0 = fm.kernel_runs(device)
    gen = torch.Generator(device=device).manual_seed(7)
    loss = call(run, params, pool, perm, 0, gen)
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "backend": mesh.backend, "loss": loss,
           "grads": grads,
           "launches": (fm.fused_mlp_fwd_cuda.launches,
                        fm.fused_mlp_bwd_cuda.launches),
           "runs": tuple(b - a for a, b in zip(runs0,
                                               fm.kernel_runs(device))),
           "captures": run.graph.captures,
           "state": _dp_state(params, opt)[0]}
    out["ms"] = timed(run, params, pool, perm, gen)
    if mesh.rank == 0:
        ref, pool = start()
        out["one_rank_grads"] = first_grads(ref, pool, None)
        ref_opt = _adam(ref)
        one = make_device_pool_step(cfg, ref_opt, batch_size=BATCH,
                                    steps_per_execution=k)
        gen = torch.Generator(device=device).manual_seed(7)
        out["one_rank_loss"] = call(one, ref, pool, perm, 0, gen)
        out["one_rank"] = _dp_state(ref, ref_opt)[0]
        out["one_rank_ms"] = timed(one, ref, pool, perm, gen)
    return out


def _sgd(params):
    from types import SimpleNamespace
    from nerf_fl_torch.training import optimizers
    return optimizers.build_optimizer(
        SimpleNamespace(optimizer="sgd", lr=TP_LR, weight_decay=0.0,
                        momentum=0.0),
        optimizers.trainable_parameters(
            params, optimizers.make_trainable_mask(params, False)))


def _tp_rank(device):
    """Phase 13 (d), one rank of two sharing the card over gloo on a data 1
    x model 2 mesh: with Adam the f32 eager steps and graph K-step and the
    bf16 graph K-step, with SGD an f32 graph K-step, and a tile's render
    (see the module docstring); rank 0 also runs one rank's plain-path
    steps and render from the same weights."""
    import copy
    import dataclasses
    import torch
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.parallel import make_mesh, multihost, place_params
    from nerf_fl_torch.parallel.mesh import (_shard_dim, param_shardings,
                                             whole_params)
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import (build_params, epoch_perm,
                                        make_device_pool_step, optimizers,
                                        render_chunked)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, 2, devices=multihost.job_devices(device))
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(device)
    out = {"rank": mesh.rank, "backend": mesh.backend}

    def rows(m, n):
        return torch.stack([m[k][:n] for k in sorted(m)], 1).cpu()

    def whole_grads(p, m):
        """Each leaf's gradient after a step, gathered whole under ``m``."""
        specs = {} if m is None else param_shardings(m, p, True)
        got = []
        for name, q in optimizers.named_leaves(p):
            g = torch.zeros_like(q) if q.grad is None else q.grad.detach()
            dim = _shard_dim(specs.get(name, ()))
            got.append((g if dim is None else m.model.all_gather(g, dim))
                       .cpu())
        return got

    def train(cfg, params, steps, m, n_steps=TP_STEPS, make_opt=_adam):
        """n_steps sub-steps, one a call (steps 1) or K a call; the params
        and optimizer state (whole), the metric rows, the ms a sub-step,
        the graph's counts, and after a first single step its gradient."""
        p = copy.deepcopy(params)
        opt = make_opt(p)
        if m is not None:
            place_params(m, p, True, opt)
        run = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                    steps_per_execution=steps, mesh=m)
        gen = torch.Generator(device=device).manual_seed(7)
        res = {"rows": [], "ms": [], "replays": []}
        for i0 in range(0, n_steps, steps):
            n = min(steps, n_steps - i0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if steps == 1:
                got = {k: v[None] for k, v in run(
                    p, pool, perm, i0, TP_LR, generator=gen).items()}
            else:
                got = run(p, pool, perm, i0, n_steps, TP_LR, generator=gen)
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t) * 1e3 / n)
            res["rows"].append(rows(got, n))
            res["names"] = sorted(got)
            if steps == 1 and i0 == 0:
                res["grads"] = whole_grads(p, m)
            if steps > 1:
                res["replays"].append(run.graph.replays)
                if any(bool(v[n:].isfinite().any()) for v in got.values()):
                    fail("a masked TP sub-step wrote a metric row")
        res["rows"] = torch.cat(res["rows"])
        with whole_params(m, p, opt, m is not None):
            res["state"] = _dp_state(p, opt)
        if steps > 1:
            res["captures"] = run.graph.captures
            pieces = run.graph.pieces
            if m is not None:
                res["cuts"] = len(pieces.plan)
                res["digest"] = pieces.digest()
        return res

    for dtype in ("float32", "bfloat16"):
        cfg = RenderConfig(**{**FLAGSHIP, "perturb": 1.0,
                              "compute_dtype": dtype})
        plain = dataclasses.replace(cfg, use_fused=False)
        gen = torch.Generator(device=device).manual_seed(0)
        params = build_params(cfg, N_VOCAB, generator=gen, device=device)
        pool = train_pool(device, gen)
        runs0 = fm.kernel_runs(device)
        graph = train(cfg, params, TP_K, mesh)
        graph["runs"] = tuple(b - a for a, b in
                              zip(runs0, fm.kernel_runs(device)))
        out[dtype] = {"graph": graph}
        if mesh.rank == 0:
            out[dtype]["one_rank"] = train(plain, params, TP_K, None)
        if dtype == "bfloat16":
            del params, pool
            torch.cuda.empty_cache()
            continue
        out[dtype]["eager"] = train(cfg, params, 1, mesh)
        out[dtype]["sgd"] = train(cfg, params, TP_SGD_K, mesh,
                                  TP_SGD_K, _sgd)
        if mesh.rank == 0:
            out[dtype]["one_rank_step"] = train(plain, params, 1, None, 1)
            out[dtype]["one_rank_sgd"] = train(plain, params, TP_SGD_K,
                                               None, TP_SGD_K, _sgd)
        # the tile: TP_TILE x TP_TILE rays at the middle of phase 3's
        # frame, at test time, from the seed-0 weights
        rays, ts = frame_rays(device)
        at = torch.arange(TP_TILE, device=device)
        lo = (IMG - TP_TILE) // 2
        idx = ((lo + at)[:, None] * IMG + lo + at[None, :]).reshape(-1)
        rays, ts = rays[idx], ts[idx]
        tp = copy.deepcopy(params)
        place_params(mesh, tp, True)
        t = time.perf_counter()
        out["render"] = render_chunked(
            tp, rays, ts, cfg, mesh=mesh,
            generator=torch.Generator(device=device).manual_seed(5))
        out["render_s"] = time.perf_counter() - t
        if mesh.rank == 0:
            out["render_one"] = render_chunked(
                params, rays, ts, plain,
                generator=torch.Generator(device=device).manual_seed(5))
        del params, pool, tp
        torch.cuda.empty_cache()
    return out


def _state_diff(a, b) -> float:
    """Max |a - b| over two ``_dp_state`` results (params and Adam
    state)."""
    (pa, sa), (pb, sb) = a, b
    if len(pa) != len(pb) or len(sa) != len(sb):
        fail("TP states of different shapes")
    worst = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
    for x, y in zip(sa, sb):
        if x.keys() != y.keys():
            fail("TP Adam states with other keys")
        worst = max([worst] + [float((x[k].float() - y[k].float()).abs()
                                     .max()) for k in x])
    return worst


def phase_tp(dev):
    """Phase 13 (d): the tensor-parallel K-step and render on one card
    (see the module docstring).  Returns the times and the cut count."""
    import numpy as np
    from nerf_fl_torch.parallel import launch
    t0 = time.perf_counter()
    ranks = launch.spawn(_tp_rank, (), devices=[dev, dev], timeout=900)
    r0, r1 = ranks
    f32, bf16 = r0["float32"], r0["bfloat16"]
    g = f32["graph"]
    loss_col = g["names"].index("train/loss")

    def params_d(a, b, mean=False):
        """The largest per-leaf max (or mean) |a - b| over the params."""
        return max(float((x - y).abs().mean() if mean else
                         (x - y).abs().max())
                   for x, y in zip(a["state"][0], b["state"][0]))

    def loss_rel(a, b):
        x, y = a["rows"][:, loss_col], b["rows"][:, loss_col]
        return float(((x - y).abs() / y.abs()).max())

    graph_eager = max(_state_diff(g["state"], f32["eager"]["state"]),
                      float((g["rows"] - f32["eager"]["rows"]).abs().max()))
    one_loss = loss_rel(g, f32["one_rank"])
    grad_norm = max(float((a - b).norm() / (b.norm() + 1e-30))
                    for a, b in zip(f32["eager"]["grads"],
                                    f32["one_rank_step"]["grads"]))
    one = params_d(g, f32["one_rank"])
    one_mean = params_d(g, f32["one_rank"], mean=True)
    sgd = params_d(f32["sgd"], f32["one_rank_sgd"])
    ranks_d = max(_state_diff(r0[d][k]["state"], r1[d][k]["state"])
                  for d, k in (("float32", "graph"), ("float32", "sgd"),
                               ("bfloat16", "graph")))
    graphs = [r[d][k] for r in ranks for d, k in (
        ("float32", "graph"), ("float32", "sgd"), ("bfloat16", "graph"))]
    cuts = [x["cuts"] for x in graphs]
    digests = {x["digest"] for x in graphs}
    captures = [x["captures"] for x in graphs]
    replays = [r[d]["graph"]["replays"] for r in ranks
               for d in ("float32", "bfloat16")]
    runs = [r[d]["graph"]["runs"] for r in ranks
            for d in ("float32", "bfloat16")]
    bg, bo = bf16["graph"], bf16["one_rank"]
    bf_loss = loss_rel(bg, bo)
    bf_max = params_d(bg, bo)
    bf_mean = params_d(bg, bo, mean=True)
    render = max(float(np.abs(r0["render"][k] - r0["render_one"][k]).max())
                 for k in r0["render_one"])
    render_ranks = max(float(np.abs(r0["render"][k] - r1["render"][k]).max())
                       for k in r0["render"])
    want_replays = [TP_K - 1, TP_K - 1 + TP_STEPS - TP_K]
    eager_ms = f32["eager"]["ms"]
    print(f"[parallel] (d) tensor parallel, data 1 x model 2 over "
          f"{r0['backend']} on one card, flagship plain MLP path, {TP_STEPS} "
          f"sub-steps (K {TP_K}, the second call's tail masked): cuts a "
          f"sub-step by rank and run {cuts} (plan checksums "
          f"{sorted(digests)}), captures {captures}, replays after each "
          f"call {replays} (want {want_replays}), fused runs {runs}")
    print(f"[parallel] (d) f32 Adam: graph K-step against the same ranks' "
          f"eager steps max |d| {graph_eager:.3e} (params, Adam state, "
          f"metrics; limit 0); against one rank's plain-path steps: losses "
          f"max rel {one_loss:.3e} (limit {DP_LOSS_RTOL:g}), one eager "
          f"step's gradient ||d|| / ||g|| by leaf at most {grad_norm:.3e} "
          f"(limit {TP_GRAD_NORM:g}), params after {TP_STEPS} sub-steps "
          f"max |d| "
          f"{one:.3e}, largest leaf mean {one_mean:.3e} (limits "
          f"{TP_BF16_MAX:g} / {TP_BF16_MEAN:g}); f32 SGD: {TP_SGD_K} graph "
          f"sub-steps against one rank's, params max |d| {sgd:.3e} (limit "
          f"{DP_ATOL:g}); rank 1 against rank 0 {ranks_d:.3e} (limit 0)")
    print(f"[parallel] (d) bf16 Adam: graph K-step against one rank's: "
          f"losses max rel {bf_loss:.3e} (limit {TP_BF16_LOSS_RTOL:g}), "
          f"params max |d| {bf_max:.3e} (limit {TP_BF16_MAX:g}), largest "
          f"leaf mean |d| {bf_mean:.3e} (limit {TP_BF16_MEAN:g})")
    print(f"[parallel] (d) {TP_TILE} x {TP_TILE} tile under model 2 against "
          f"one rank's render: max |d| {render:.3e} (limit "
          f"{TP_RENDER_TOL:g}), rank 1 against rank 0 {render_ranks:.3e}; "
          f"{r0['render_s']:.2f} s")
    print(f"[parallel] (d) ms a sub-step (f32 Adam): eager "
          f"{[round(x, 1) for x in eager_ms]}, graph by call "
          f"{[round(x, 1) for x in g['ms']]}; bf16 graph by call "
          f"{[round(x, 1) for x in bg['ms']]}; one rank's plain-path graph "
          f"by call {[round(x, 2) for x in f32['one_rank']['ms']]} (f32), "
          f"{[round(x, 2) for x in bo['ms']]} (bf16); "
          f"{time.perf_counter() - t0:.1f} s with the spawn")
    if graph_eager != 0.0 or ranks_d != 0.0 or render_ranks != 0.0:
        fail("the TP graph K-step differs from the eager steps, or the "
             "ranks differ")
    if one_loss > DP_LOSS_RTOL or grad_norm > TP_GRAD_NORM \
            or one > TP_BF16_MAX or one_mean > TP_BF16_MEAN \
            or sgd > DP_ATOL:
        fail("the f32 TP steps disagree with one rank's")
    if len(set(cuts)) != 1 or len(digests) != 1 or cuts[0] < 2:
        fail(f"the ranks cut the TP sub-step differently: {cuts}")
    if any(c != 1 for c in captures) \
            or any(r != want_replays for r in replays):
        fail(f"TP graph K-step: captures {captures}, replays {replays}")
    if any(r != (0, 0) for r in runs):
        fail(f"a sharded field ran fused kernels: {runs}")
    if bf_loss > TP_BF16_LOSS_RTOL or bf_max > TP_BF16_MAX \
            or bf_mean > TP_BF16_MEAN:
        fail("the bf16 TP graph K-step is out of its limits against one "
             "rank's")
    if render > TP_RENDER_TOL:
        fail(f"the tile under model 2 is {render:.3e} from one rank's")
    return {"tp_eager_ms": float(np.median(eager_ms[1:])),
            "tp_graph_ms": g["ms"][-1], "tp_cuts": cuts[0]}

def phase_parallel(dev):
    """Phase 13 (see the module docstring).  Returns the fused launches
    of (a)'s mesh call and (b)'s two ranks, and the times."""
    import copy
    import torch
    import torch.distributed as dist
    from nerf_fl_torch.ops import fused_mlp as fm
    from nerf_fl_torch.parallel import (launch, make_mesh, multihost,
                                        place_params)
    from nerf_fl_torch.render import RenderConfig
    from nerf_fl_torch.training import (build_params, epoch_perm,
                                        make_device_pool_step)

    t_phase = time.perf_counter()
    out = {}
    # (a) a one-rank NCCL mesh against the meshless graph step
    cfg = RenderConfig(**{**FLAGSHIP, "perturb": 1.0})
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_params(cfg, N_VOCAB, generator=gen, device=dev)
    pool = train_pool(dev, gen)
    perm = torch.from_numpy(epoch_perm(0, 0, POOL, POOL)).to(dev)
    multihost.initialize_distributed(f"localhost:{launch.free_port()}", 1,
                                     0, backend="nccl", device=dev)
    try:
        mesh = make_mesh(1, 1, devices=[dev])
        sides = {}
        for name, m in (("meshless", None), ("mesh", mesh)):
            p = copy.deepcopy(params)
            if m is not None:
                place_params(m, p)
            opt = _adam(p)
            run = make_device_pool_step(cfg, opt, batch_size=BATCH,
                                        steps_per_execution=TIME_K, mesh=m)
            fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches \
                = 0
            runs0 = fm.kernel_runs(dev)
            g = torch.Generator(device=dev).manual_seed(7)
            loss = run(p, pool, perm, 0, TIME_K, 5e-4,
                       generator=g)["train/loss"]
            torch.cuda.synchronize()
            sides[name] = dict(
                state=_dp_state(p, opt), loss=loss.cpu(), run=run, params=p,
                gen=g,
                launches=(fm.fused_mlp_fwd_cuda.launches,
                          fm.fused_mlp_bwd_cuda.launches),
                runs=tuple(b - a for a, b in zip(runs0,
                                                 fm.kernel_runs(dev))))
        (pa, sa), (pb, sb) = sides["meshless"]["state"], \
            sides["mesh"]["state"]
        same = all(torch.equal(a, b) for a, b in zip(pa, pb)) and all(
            a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
            for a, b in zip(sa, sb)) and torch.equal(
            sides["meshless"]["loss"], sides["mesh"]["loss"])
        mr = sides["mesh"]
        print(f"[parallel] (a) one-rank NCCL mesh (backend "
              f"{mesh.backend}): {TIME_K} graph sub-steps, two graphs each "
              f"around the all-reduce, against the meshless graph step: "
              f"params, Adam state and losses bit for bit: {same}; fused "
              f"runs {mr['runs']} ({mr['runs'][0] / TIME_K:g} + "
              f"{mr['runs'][1] / TIME_K:g} a sub-step), host launches "
              f"{mr['launches']}, {mr['run'].graph.captures} capture(s)")
        if not same:
            fail("the one-rank mesh graph step differs from the meshless one")
        if mr["runs"] != (2 * TIME_K, 2 * TIME_K) \
                or mr["run"].graph.captures != 1 \
                or len(mr["run"].graph.pieces.graphs) != 2:
            fail(f"mesh graph step: {mr['runs']} fused runs in {TIME_K} "
                 f"sub-steps, expected 2 + 2 a sub-step in one capture of "
                 f"two graphs")
        out["mesh_launches"] = mr["launches"]
        out["mesh_runs"] = mr["runs"]
        times = {"meshless": [], "mesh": []}
        i0 = TIME_K
        for name in ("meshless", "mesh", "mesh", "meshless"):
            side = sides[name]
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                side["run"](side["params"], pool, perm, i0, i0 + TIME_K,
                            5e-4, generator=side["gen"])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3 / TIME_K)
                i0 += TIME_K
        out["mesh_ms"] = sorted(times["mesh"])[len(times["mesh"]) // 2]
        out["meshless_ms"] = sorted(times["meshless"])[
            len(times["meshless"]) // 2]
        print(f"[parallel] (a) graph step ms a sub-step: one-rank NCCL mesh "
              f"{out['mesh_ms']:.3f} (windows "
              f"{[round(x, 3) for x in times['mesh']]}), meshless "
              f"{out['meshless_ms']:.3f} (windows "
              f"{[round(x, 3) for x in times['meshless']]}): the split "
              f"around the all-reduce costs "
              f"{out['mesh_ms'] - out['meshless_ms']:+.3f} ms a sub-step")
        del sides
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks sharing the card over gloo
    t0 = time.perf_counter()
    ranks = launch.spawn(_dp_rank, (DP_K,), devices=[dev, dev], timeout=600)
    r0 = ranks[0]
    worst = max(float((a - b).abs().max())
                for a, b in zip(r0["state"], r0["one_rank"]))
    over = sum(int(((a - b).abs() > 1e-6).sum())
               for a, b in zip(r0["state"], r0["one_rank"]))
    total = sum(a.numel() for a in r0["state"])
    agree = max(float((a - b).abs().max())
                for a, b in zip(r0["state"], ranks[1]["state"]))
    loss_rel = float(((r0["loss"] - r0["one_rank_loss"]).abs()
                      / r0["one_rank_loss"].abs()).max())
    grad_rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                   for a, b in zip(r0["grads"], r0["one_rank_grads"]))
    print(f"[parallel] (b) two ranks on one card over "
          f"{r0['backend']}: {DP_K} f32 sub-steps of the flagship DP step "
          f"against one rank's over the same global batches: losses max "
          f"rel {loss_rel:.3e} (limit {DP_LOSS_RTOL:g}), one eager step's "
          f"reduced gradient max |d| / leaf max {grad_rel:.3e} (limit "
          f"{DP_GRAD_REL:g}), params max |d| {worst:.3e} (limit "
          f"{DP_ATOL:g}; {over} of {total} over 1e-6), rank 1 against "
          f"rank 0 {agree:.3e}; fused runs by rank "
          f"{[r['runs'] for r in ranks]} "
          f"({DP_K} sub-steps), host launches "
          f"{[r['launches'] for r in ranks]}; the two-rank step "
          f"{max(r['ms'] for r in ranks):.2f} ms a sub-step, one rank's "
          f"{r0['one_rank_ms']:.2f} (f32, one card); "
          f"{time.perf_counter() - t0:.1f} s with the spawn")
    if worst > DP_ATOL or agree != 0.0 or r0["backend"] != "gloo" \
            or loss_rel > DP_LOSS_RTOL or grad_rel > DP_GRAD_REL \
            or len(r0["grads"]) != len(r0["one_rank_grads"]):
        fail("the two-rank DP step disagrees with one rank's")
    if any(r["runs"] != (2 * DP_K, 2 * DP_K) or r["captures"] != 1
           for r in ranks):
        fail("a rank of the DP step ran other than 2 + 2 fused kernels a "
             "sub-step in one capture")
    out["two_rank_launches"] = tuple(sum(r["launches"][i] for r in ranks)
                                     for i in (0, 1))
    out["two_rank_runs"] = tuple(sum(r["runs"][i] for r in ranks)
                                 for i in (0, 1))
    out["two_rank_ms"] = max(r["ms"] for r in ranks)
    out["one_rank_f32_ms"] = r0["one_rank_ms"]

    # (c) more ranks than cards: the CLI refuses before any rank starts
    n = torch.cuda.device_count() + 1
    res = subprocess.run(
        [sys.executable, "-m", "nerf_fl_torch.train", "--root_dir",
         os.path.join(HERE, "no_scene"), "--num_gpus", str(n)],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    want = f"requested mesh data={n} x model=1 = {n} devices but only " \
        f"{n - 1} cuda device(s) available"
    print(f"[parallel] (c) train --num_gpus {n} on {n - 1} card(s): exit "
          f"code {res.returncode}, make_mesh's message "
          f"{'present' if want in res.stderr else 'MISSING'}")
    if res.returncode == 0 or want not in res.stderr:
        fail(f"train --num_gpus {n} did not refuse with make_mesh's "
             f"message:\n{res.stderr[-2000:]}")
    out.update(phase_tp(dev))
    print(f"[parallel] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return out


POINTS_N = 1_000_000       # a real reconstruction's points3D.bin
POINTS_TRACK = 8           # images that see each point


def phase_colmap_native():
    """The native COLMAP points decoder (``csrc/colmap_fast.c``, host C)
    at a real reconstruction's size, in a temporary directory: build it
    with the C compiler (no fallback to the pure-Python reader), write
    TOUR_SCENE with a points3D.bin of POINTS_N points with tracks of
    POINTS_TRACK images, decode it with the native and the pure-Python
    reader (every array bit for bit the same), then build
    ``PhototourismDataset(use_cache=False)`` over it (no fallback line;
    every image's near plane finite and below its far).  Prints the
    seconds of the build, the writer, both readers and the dataset's
    stages; returns them."""
    import contextlib
    import io
    import shutil
    import tempfile
    import numpy as np
    from nerf_fl_torch.data import colmap, colmap_native
    from nerf_fl_torch.data.phototourism import PhototourismDataset
    from nerf_fl_torch.data.synthetic import (make_phototourism_scene,
                                              write_point_cloud)

    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    lib = colmap_native.build()
    if not colmap_native.native_available():
        fail(f"the native COLMAP decoder did not load: "
             f"{colmap_native._unavailable}")
    out["build"] = time.perf_counter() - t0
    here, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_colmap_")
    try:
        os.chdir(tmp)
        make_phototourism_scene("tour", **TOUR_SCENE)
        sparse = os.path.join("tour", "dense", "sparse")
        ids = sorted(colmap.read_images_binary(
            os.path.join(sparse, "images.bin")))
        path = os.path.join(sparse, "points3D.bin")
        t0 = time.perf_counter()
        write_point_cloud(path, POINTS_N, ids, POINTS_TRACK)
        out["write"] = time.perf_counter() - t0
        size = os.path.getsize(path)
        if size != 8 + POINTS_N * (51 + 8 * POINTS_TRACK):
            fail(f"points3D.bin of {size} bytes")
        t0 = time.perf_counter()
        native = colmap_native.read_points3d_arrays(path, with_tracks=True)
        out["native"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pure = colmap.read_points3d_arrays(path, with_tracks=True)
        out["pure"] = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and a.shape == b.shape
                   and a.tobytes() == b.tobytes()
                   for a, b in zip(native, pure))
        print(f"[colmap] {POINTS_N:,} points with tracks of {POINTS_TRACK} "
              f"({size / 1e6:.1f} MB, written in {out['write']:.3f} s): "
              f"native decoder {out['native']:.4f} s (built in "
              f"{out['build']:.2f} s: {os.path.basename(lib)}), pure-Python "
              f"reader {out['pure']:.3f} s ({out['pure'] / out['native']:.0f}"
              f" x); the arrays bit for bit the same: {same}")
        if not same or len(native.ids) != POINTS_N \
                or native.tracks.shape != (POINTS_N * POINTS_TRACK, 2):
            fail("the native and the pure-Python COLMAP readers disagree")
        del native, pure
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            ds = PhototourismDataset("tour", "val", TOUR_DOWNSCALE,
                                     use_cache=False)
        out["dataset"] = time.perf_counter() - t0
        out.update(ds.stage_s)
        near = np.array([ds.nears[k] for k in ds.img_ids])
        far = np.array([ds.fars[k] for k in ds.img_ids])
        print(f"[colmap] PhototourismDataset(use_cache=False) over "
              f"{len(ds.img_ids)} images and the {POINTS_N:,}-point cloud in "
              f"{out['dataset']:.3f} s: points {ds.stage_s['points']:.4f} s, "
              f"near / far {ds.stage_s['near_far']:.3f} s "
              f"({ds.stage_s['near_far'] / len(ds.img_ids) * 1e3:.1f} ms an "
              f"image); nears {near.min():.4f}-{near.max():.4f}, fars "
              f"{far.min():.4f}-{far.max():.4f}")
        if "[colmap]" in said.getvalue():
            fail(f"the dataset fell back: {said.getvalue().strip()}")
        if ds.xyz_world.shape != (POINTS_N, 3) \
                or not np.all(np.isfinite(near) & (near > 0) & (near < far)):
            fail("the dataset's near / far planes are not finite and ordered")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase"] = time.perf_counter() - t_phase
    print(f"[colmap] phase 14 in {out['phase']:.1f} s")
    return out


def probe_block(name) -> str:
    """Which block a probe's kernel is built from, for its [probe] line;
    the Hopper-block probes and sin with what ptxas and the build report."""
    from nerf_fl_torch.ops import anatomy
    if name in anatomy.PE_TERMS:
        terms = anatomy.PE_TERMS[name]
        info = anatomy.pe_plan(terms)
        r = ptxas_info("anatomy_pe", f"pe_mm_hopper_kernelILi{terms}EE")
        passes = 6 if terms == 3 else 1
        return (f"block: hopper (wgmma from shared memory, {info['rows']} "
                f"rows a tile, {info['threads']} threads, TERMS {terms}: "
                f"{passes} bf16 pass{'es' if passes > 1 else ''} of K = 128, "
                f"P's image resident ({info['image_bytes']} B in "
                f"{info['slabs']} slabs, one bulk copy a block), "
                f"{info['smem']} B shared memory, {r[0]} registers, spill "
                f"{r[1]} / {r[2]} B)")
    if name in ("chain8", "concat", "split", "static", "full", "consol"):
        if name in anatomy.CHAIN_PROBES:
            skip = anatomy.PROBES[name].variant
            info, src = anatomy.chain_plan(skip), "anatomy_chain"
            kernel = f"chain_hopper_kernelILi{skip}ELi{info['stages']}EE"
        else:
            transient = name == "full"
            info, src = anatomy.net_plan(transient), "anatomy_net"
            kernel = f"net_hopper_kernelILb{int(transient)}E"
        r = ptxas_info(src, kernel)
        return (f"block: hopper (wgmma from shared memory, {info['rows']} "
                f"rows a tile, {info['threads']} threads, ring of "
                f"{info['stages']} x {info['stage_bytes'] // 1024} KB slabs, "
                f"{info['slabs']} slabs a tile, {info['smem']} B shared "
                f"memory, {r[0]} registers, spill {r[1]} / {r[2]} B)")
    if name == "sin":
        r = ptxas_info("anatomy_pe", "sin_kernel")
        return (f"block: a tile of 256 float4s a block, one block a tile "
                f"({r[0]} registers, spill {r[1]} / {r[2]} B, {r[3]} B stack "
                f"frame)")
    if name == "pe_vpu":
        r = ptxas_info("anatomy_pe", "pe_vpu_kernel")
        return (f"block: a float4 of a row's 32-column quarter a lane, four "
                f"rows a warp instruction, 8 rows a thread, one 64-row tile "
                f"a block, streaming stores, sinf skipped warp-uniformly "
                f"({r[0]} registers, spill {r[1]} / {r[2]} B)")
    return "block: elementwise, one column a thread"


def probe_work(name, ops, n):
    """(operations, their type, bytes) one launch of a probe needs: each
    input read once, the (n, 128) f32 output written once.  MACs per point
    follow the padded layer shapes of the probes' files.  pe_mm's f32
    product is counted as this card does it, six bf16 passes on the tensor
    cores (its [probe] line notes the bound of the same product as f32
    FMAs on the CUDA cores)."""
    trunk = 128 * 256 + 6 * 256 * 256 + 384 * 256
    static = trunk + 256 * 384 + 384 * 128 + 128 * 128
    skip = 7 * 256 * 256 + 384 * 256
    macs = {"static": static, "consol": static,
            "full": static + 384 * 128 + 4 * 128 * 128,
            "chain8": 8 * 256 * 256, "concat": skip, "split": skip,
            "pe_mm": 6 * 128 * 128, "pe_mm_bf16": 128 * 128}
    if name in macs:
        flops, kind = 2.0 * macs[name] * n, "bf16"
    else:
        # per output element: pe_vpu 3 mul + 2 add, + phase, sin, * scale;
        # pe_only two such encoders with a 12-step sin_cw each and two adds
        per = {"pe_vpu": 7 + SIN_OPS, "sin": SIN_OPS,
               "pe_only": 2 * (7 + SIN_OPS) + 2}[name]
        flops, kind = float(per) * n * 128, "f32"
    nbytes = sum(t.numel() * t.element_size() for t in ops) + n * 128 * 4
    if name == "pe_vpu":
        # its function depends on three of the input's 128 columns
        nbytes -= n * (128 - 3) * 4
    if name in ("concat", "split"):
        nbytes -= ops[8].numel() * ops[8].element_size()   # w[4] is not read
    return flops, kind, nbytes


def pe_mm_dense_units(dev, n=65_536, seed=11) -> float:
    """pe_mm's E (trg 0, ph 0, s 1: out is E) for N(0, 1) x (n, 128) and
    P (128, 128) from a numpy seed, against the float64 product: the worst
    error in units of 2^-24 sum_k |x_k P_kc|."""
    import numpy as np
    import torch
    from nerf_fl_torch.ops import anatomy

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (n, 128)).astype(np.float32)).to(dev)
    P = torch.from_numpy(rng.normal(0, 1, (128, 128)).astype(np.float32)
                         ).to(dev)
    rows = anatomy.pe_mm_rows(dev)
    rows[0] = P
    rows[1] = torch.zeros_like(rows[1])
    rows[2] = torch.zeros_like(rows[2])
    E = anatomy.PROBES["pe_mm"].cuda(*rows, x).double()
    ref = x.double() @ P.double()
    unit = 2.0 ** -24 * (x.double().abs() @ P.double().abs())
    return float(((E - ref).abs() / unit).max())


def phase_anatomy(dev, cfg, smi_name):
    """Phase 8: the eleven probes against their plain versions, timed; the
    fused forward at the same size; the measured split; the entry points."""
    import torch
    from nerf_fl_torch.experiments import kernel_anatomy, kernel_anatomy2
    from nerf_fl_torch.experiments.chain_ablation import ring_depth, \
        shipped_depth
    from nerf_fl_torch.experiments.fused_ablation import built_from, \
        patched_sources
    from nerf_fl_torch.experiments.pe_ablation import variant_build
    from nerf_fl_torch.experiments.probe_timing import CALLS, cases as \
        probe_cases, queued_ms
    from nerf_fl_torch.ops import _build, anatomy
    from nerf_fl_torch.ops import fused_mlp as fm

    n = N_ANATOMY
    part, (peak_bf16, peak_bw) = peak_for(smi_name)
    peak = {"bf16": peak_bf16, "f32": F32_PEAKS[part]}
    t0 = time.perf_counter()
    cases = probe_cases(anatomy, n, dev)
    print(f"[anatomy] operands for {n} points from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    f32_gate = {"sin": PROBE_F32_ATOL, "pe_mm": PROBE_F32_ATOL,
                "pe_vpu": PROBE_F32_ATOL, "pe_mm_bf16": PROBE_F32_ATOL,
                "pe_only": F32_ATOL}
    failures, rows, outs = [], {}, {}
    with torch.no_grad():
        for name, ops in cases.items():
            probe = anatomy.PROBES[name]
            got, ref = probe.cuda(*ops), probe.plain(*ops)
            torch.cuda.synchronize()
            diff = (got - ref).abs()
            err, mean = float(diff.max()), float(diff.mean())
            if tuple(got.shape) != (n, 128) or not torch.isfinite(got).all():
                failures.append(f"{name}: output not finite ({n}, 128)")
            if name in f32_gate:
                bad = err > f32_gate[name]
                gate = f"atol {f32_gate[name]:g}"
            else:
                # worst |d| as a share of its limit: 1 is the gate
                worst = float((diff / (PROBE_BF16_ATOL
                                       + PROBE_BF16_RTOL * ref.abs())).max())
                bad = worst > 1.0 or mean > PROBE_BF16_MEAN
                gate = (f"{PROBE_BF16_ATOL:g} + {PROBE_BF16_RTOL:g} |ref| "
                        f"(worst at {worst:.2f} of it), mean "
                        f"{PROBE_BF16_MEAN:g}")
            if bad:
                failures.append(f"probe {name} != plain: max {err:.3e} mean "
                                f"{mean:.3e} (gate {gate})")
            if name in ("static", "consol", "split"):
                outs[name] = got
            del got, ref, diff
            for _ in range(2):                               # warm up
                probe.cuda(*ops)
            k_ms, k_all = cuda_ms(lambda: probe.cuda(*ops), 7)
            d_ms, d_all = queued_ms(lambda: probe.cuda(*ops))
            p_ms, _ = cuda_ms(lambda: probe.plain(*ops), 5)
            lib_ms = lib_d_ms = None
            if name == "sin":
                lib_ms, _ = cuda_ms(lambda: torch.sin(ops[0]), 7)
                lib_d_ms, _ = queued_ms(lambda: torch.sin(ops[0]))
            flops, kind, nbytes = probe_work(name, ops, n)
            t_ops, t_bytes = flops / peak[kind] * 1e3, nbytes / peak_bw * 1e3
            bound_ms = max(t_ops, t_bytes)
            rows[name] = dict(
                max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib_ms, library_device_ms=lib_d_ms)
            lib = "" if lib_ms is None else (
                f", torch.sin {lib_ms:.3f} ms per call, {lib_d_ms:.4f} "
                f"queued (kernel / torch.sin queued "
                f"{d_ms / lib_d_ms:.3f})")
            if name == "pe_mm":
                fma_ms = 2.0 * 128 * 128 * n / peak["f32"] * 1e3
                lib += (f"; as f32 FMAs on the CUDA cores the product's "
                        f"bound would be {fma_ms:.3f} ms")
            print(f"[probe] {name:10s} max_abs_err {err:.2e} mean {mean:.2e} "
                  f"(gate {gate}); {k_ms:.3f} ms per call (runs "
                  f"{[round(x, 3) for x in k_all]}), {d_ms:.4f} ms queued "
                  f"(windows of {CALLS}: {[round(x, 4) for x in d_all]}), "
                  f"plain {p_ms:.3f} ms{lib}; {flops / 1e9:.1f} G{kind} op, "
                  f"{nbytes / 1e9:.3f} GB, bound {bound_ms:.3f} ms by "
                  f"{rows[name]['bound_by']} = {100 * bound_ms / k_ms:.1f}% of "
                  f"bound per call, {100 * bound_ms / d_ms:.1f}% queued; "
                  f"{probe_block(name)}")
        if not torch.equal(outs["static"], outs["consol"]):
            failures.append("consol differs from static (must be bitwise "
                            "equal)")
        print("[probe] consol == static bit for bit: "
              f"{torch.equal(outs['static'], outs['consol'])}")
        split_ops, split_out = cases["split"], outs["split"]
        vpu_ops = cases["pe_vpu"]
        del outs, cases
        units = pe_mm_dense_units(dev)
        print(f"[probe] pe_mm on a dense N(0, 1) P: max |E - x @ P| "
              f"{units:.2f} units of 2^-24 sum|x P| (bound "
              f"{PE_DENSE_UNITS:g})")
        if not units <= PE_DENSE_UNITS:
            failures.append(f"pe_mm on a dense P: {units:.2f} units of "
                            f"2^-24 sum|x P| (bound {PE_DENSE_UNITS:g})")
        if failures:
            fail("\n".join(failures))

        # the fused forward kernel on the same number of points, as it is
        # and without its encoders (fused_ablation.py's no_encoders variant:
        # wrong values, time only), per call and queued
        inp, net, sx, sd = fused_case(dev, cfg, n, 5)

        def fused():
            return fm.fused_mlp_fwd_cuda(inp, net, sx, sd)

        for _ in range(2):
            fused()
        fused_ms, _ = cuda_ms(fused, 7)
        fused_q, _ = queued_ms(fused)
        flops = 2.0 * fine_macs(cfg) * n
        fused_line("fwd", n, fused_ms, flops, flops / peak_bf16 * 1e3, net)
        t0 = time.perf_counter()
        with built_from(patched_sources("no_encoders"),
                        _build.BUILD / "ablation" / "no_encoders",
                        fm._lib.cache_clear):
            for _ in range(2):
                fused()
            build_s = time.perf_counter() - t0
            nope_ms, _ = cuda_ms(fused, 7)
            nope_q, _ = queued_ms(fused)
        del inp

        # split with concat's ring depth (chain_ablation.py): the same
        # arithmetic, so bit for bit split as it ships, and concat's work
        # but for the copy
        split = anatomy.PROBES["split"]
        depth = shipped_depth("concat")
        t0 = time.perf_counter()
        with ring_depth("split", depth):
            same = torch.equal(split.cuda(*split_ops), split_out)
            ring_s = time.perf_counter() - t0
            split.cuda(*split_ops)
            split_cc_q, _ = queued_ms(lambda: split.cuda(*split_ops))
        if not same:
            fail(f"split with a ring of {depth} slabs differs from split as "
                 f"it ships")
        del split_ops, split_out

        # pe_vpu as the parent built it (pe_ablation.py's column_a_thread
        # variant: one thread a column; bit for bit the shipped kernel)
        vpu = anatomy.PROBES["pe_vpu"]
        shipped_vpu = vpu.cuda(*vpu_ops)
        t0 = time.perf_counter()
        with variant_build("vpu_column_a_thread"):
            same = torch.equal(vpu.cuda(*vpu_ops), shipped_vpu)
            vpu_build_s = time.perf_counter() - t0
            vpu_parent_q, _ = queued_ms(lambda: vpu.cuda(*vpu_ops))
        vpu_q, _ = queued_ms(lambda: vpu.cuda(*vpu_ops))
        if not same:
            fail("pe_vpu's first design differs from the shipped kernel")
        del shipped_vpu, vpu_ops
        rows["pe_vpu"]["parent_device_ms"] = vpu_parent_q
        bound = rows["pe_vpu"]["bound_ms"]
        print(f"[probe] pe_vpu queued {vpu_q:.4f} ms against the parent's "
              f"design (one thread a column) {vpu_parent_q:.4f} ms (built "
              f"in {vpu_build_s:.1f} s, bit for bit the shipped kernel): "
              f"{vpu_parent_q / vpu_q:.2f}x; bound {bound:.4f} ms = "
              f"{100 * bound / vpu_q:.1f}% of it")
    r = {k: v["device_ms"] for k, v in rows.items()}
    ring = {k: anatomy.chain_plan(anatomy.PROBES[k].variant)["stages"]
            for k in anatomy.CHAIN_PROBES}
    chain8_tf = 2.0 * 8 * 256 * 256 * n / r["chain8"] / 1e9
    nope_tf = 2.0 * fine_macs(cfg) * n / nope_q / 1e9
    print(f"[anatomy] at {n} points, queued ms (device time; per call in "
          f"brackets): fused_mlp_fwd (bf16, transient, a_dim 48) "
          f"{fused_q:.4f} ({fused_ms:.3f}), the same kernel without its "
          f"encoders {nope_q:.4f} ({nope_ms:.3f}; built in {build_s:.1f} s) "
          f"| fullnet_nope {r['full']:.4f}, staticnet {r['static']:.4f}, "
          f"consol {r['consol']:.4f}: the net probes and the fused kernel "
          f"on one block (hopper) | fused - fullnet_nope = "
          f"{fused_q - r['full']:.4f} beside pe_only_vpu {r['pe_only']:.4f} "
          f"and the encoders' share by ablation, fused - no_encoders = "
          f"{fused_q - nope_q:.4f} | fullnet_nope / fused = "
          f"{r['full'] / fused_q:.3f} | fullnet_nope - staticnet = "
          f"{r['full'] - r['static']:.4f} (the transient branch) | the chain "
          f"probes on the same block: chain8 {r['chain8']:.4f} "
          f"({ring['chain8']}-slab ring), split skip {r['split']:.4f} "
          f"({ring['split']}), concat skip {r['concat']:.4f} ({ring['concat']}"
          f"), split at {depth} slabs {split_cc_q:.4f} (built in "
          f"{ring_s:.1f} s, bit for bit split) | concat - split = "
          f"{r['concat'] - r['split']:.4f} (the copy and concat's shallower "
          f"ring), concat - split@{depth} = {r['concat'] - split_cc_q:.4f} "
          f"(the copy alone), split - chain8 = "
          f"{r['split'] - r['chain8']:.4f} (the skip's 128 extra K rows) | "
          f"chain8 {chain8_tf:.0f} TFLOP/s queued beside the fused forward "
          f"without its encoders {nope_tf:.0f} | the PE family: pe_mm "
          f"{r['pe_mm']:.4f}, pe_mm_bf16 {r['pe_mm_bf16']:.4f}, pe_vpu "
          f"{r['pe_vpu']:.4f}, sin {r['sin']:.4f}, pe_only "
          f"{r['pe_only']:.4f} | pe_mm - pe_vpu = "
          f"{r['pe_mm'] - r['pe_vpu']:.4f} (matmul PE against multiply-add "
          f"PE), pe_mm - pe_mm_bf16 = {r['pe_mm'] - r['pe_mm_bf16']:.4f} (the "
          f"five extra passes), pe_mm_bf16 - sin = "
          f"{r['pe_mm_bf16'] - r['sin']:.4f} (the product over the bare "
          f"stream)")

    # the entry points themselves: counts at 0 just before, read just after
    for probe in anatomy.PROBES.values():
        probe.launches = 0
    fm.fused_mlp_fwd_cuda.launches = fm.fused_mlp_bwd_cuda.launches = 0
    for mod in (kernel_anatomy, kernel_anatomy2):
        res = mod.main(device=dev, n=n, reps=ANATOMY_REPS)
        missing = [k for k in mod.RESULT_NAMES
                   if not math.isfinite(res["ms"].get(k, float("nan")))
                   or not res["ms"][k] > 0]
        if missing or res["device"] != torch.cuda.get_device_name(dev):
            fail(f"{mod.__name__}: no finite time for {missing} on "
                 f"{res['device']}")
    counts = {k: p.launches for k, p in anatomy.PROBES.items()}
    fused = (fm.fused_mlp_fwd_cuda.launches, fm.fused_mlp_bwd_cuda.launches)
    print(f"[anatomy] entry points' launches: {counts}; fused forward and "
          f"backward {fused}")
    if fused != (0, 0):
        fail(f"the anatomy entry points launched the fused kernels: {fused}")
    expect = ANATOMY_REPS + 2          # first call, warm-up, timed launches
    if any(v != expect for v in counts.values()):
        fail(f"an anatomy probe was not launched {expect} times: {counts}")
    for name, row in rows.items():
        row["launches"] = counts[name]
    return rows, fused


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "nerf_fl_torch")):
        print("chip_smoke: the nerf_fl_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from nerf_fl_torch.ops import _build
    from nerf_fl_torch.ops import fused_mlp as fm

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for src in _build.sources():
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[ptxas] {src}:", line.strip())

    smi_name = smi.split(",")[0]
    from nerf_fl_torch.ops import anatomy

    def probe_counts():
        return {k: p.launches for k, p in anatomy.PROBES.items()}

    phase_kernels(dev)
    (launches, bwd_render, launches32, sigma32), cfg = phase_render(dev)
    on_render = probe_counts()
    k_ms, p_ms, bound_ms, bound_by, chunk_err, fwd32, sigma = phase_timing(
        dev, cfg, smi_name)
    phase_bwd_kernels(dev)
    (fwd_train, bwd_train), graph = phase_train(dev)
    on_train = {k: v - on_render[k] for k, v in probe_counts().items()}
    train = phase_bwd_timing(cfg, smi_name)
    ipe_rows = phase_ipe(smi_name)
    bwd, bwd32 = train["fine"], train["fine_f32"]
    bf16_rows = [train["fine"], train["coarse"]]
    f32_rows = [train["fine_f32"], train["coarse_f32"]]
    t0 = time.perf_counter()
    arms = phase_arm_step()
    arm_s = time.perf_counter() - t0
    before_cli = probe_counts()
    cli = phase_entry_points(graph["ms"])
    on_cli = {k: v - before_cli[k] for k, v in probe_counts().items()}
    before_wild = probe_counts()
    wild = phase_wild_entry_points(graph["ms"])
    on_wild = {k: v - before_wild[k] for k, v in probe_counts().items()}
    before_barf = probe_counts()
    t0 = time.perf_counter()
    barf = phase_barf_entry_points(graph["ms"])
    barf_s = time.perf_counter() - t0
    on_barf = {k: v - before_barf[k] for k, v in probe_counts().items()}
    before_tools = probe_counts()
    t0 = time.perf_counter()
    tools = phase_tools(graph["ms"])
    tools_s = time.perf_counter() - t0
    on_tools = {k: v - before_tools[k] for k, v in probe_counts().items()}
    before_par = probe_counts()
    t0 = time.perf_counter()
    par = phase_parallel(dev)
    par_s = time.perf_counter() - t0
    on_par = {k: v - before_par[k] for k, v in probe_counts().items()}
    colmap_s = phase_colmap_native()
    probes, fused_on_anatomy = phase_anatomy(dev, cfg, smi_name)

    def graph_line(g, i):
        # fit's graph step: its captures, the launches one capture recorded,
        # its replays, and the kernel's runs over fit as it counts them
        return {"captures": g["captures"],
                "captured_launches": g["captured_launches"][i],
                "replays": g["replays"], "runs_on_card": g["runs"][i]}

    # launches: each main path's run, as the wrappers count their host
    # calls (the render frame, one train step, fit, eval); errors: the worst
    # over the main paths' shapes (the render chunk, the fine and the
    # coarse pass of a train step), bf16
    kernels = [{
        "name": "fused_mlp_fwd", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerf_fl_tpu/ops/fused_mlp.py:319",
        "launches": launches + fwd_train + cli["train_cli"][0]
        + cli["eval_cli"][0] + sum(wild[k][0] for k in WILD_PATHS)
        + sum(barf[k][0] for k in BARF_PATHS)
        + sum(tools[k][0] for k in TOOLS_PATHS)
        + par["mesh_launches"][0] + par["two_rank_launches"][0],
        "launches_by_path": {"render_frame": launches,
                             "train_step": fwd_train,
                             "train_graph_substep": graph["launches"][0],
                             "train_cli": cli["train_cli"][0],
                             "eval_cli": cli["eval_cli"][0],
                             **{k: wild[k][0] for k in WILD_PATHS},
                             **{k: barf[k][0] for k in BARF_PATHS},
                             **{k: tools[k][0] for k in TOOLS_PATHS},
                             "dp_one_rank_nccl_graph": par["mesh_launches"][0],
                             "dp_two_ranks_gloo": par["two_rank_launches"][0],
                             "kernel_anatomy": fused_on_anatomy[0]},
        "dp_runs_on_card": {"one_rank_nccl_graph": par["mesh_runs"][0],
                            "two_ranks_gloo": par["two_rank_runs"][0]},
        "train_cli_graph": graph_line(cli["train_graph"], 0),
        "tour_train_cli_graph": graph_line(wild["tour_graph"], 0),
        "llff_train_cli_graph": graph_line(wild["llff_graph"], 0),
        "barf_train_cli_graph": graph_line(barf["barf_graph"], 0),
        "max_abs_err": max([chunk_err] + [v["fwd_err"] for v in bf16_rows]),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "nerf_fl_tpu/ops/fused_mlp.py:359",
        "launches": bwd_render + bwd_train + cli["train_cli"][1]
        + cli["eval_cli"][1] + sum(wild[k][1] for k in WILD_PATHS)
        + sum(barf[k][1] for k in BARF_PATHS)
        + sum(tools[k][1] for k in TOOLS_PATHS)
        + par["mesh_launches"][1] + par["two_rank_launches"][1],
        "launches_by_path": {"render_frame": bwd_render,
                             "train_step": bwd_train,
                             "train_graph_substep": graph["launches"][1],
                             "train_cli": cli["train_cli"][1],
                             "eval_cli": cli["eval_cli"][1],
                             **{k: wild[k][1] for k in WILD_PATHS},
                             **{k: barf[k][1] for k in BARF_PATHS},
                             **{k: tools[k][1] for k in TOOLS_PATHS},
                             "dp_one_rank_nccl_graph": par["mesh_launches"][1],
                             "dp_two_ranks_gloo": par["two_rank_launches"][1],
                             "kernel_anatomy": fused_on_anatomy[1]},
        "dp_runs_on_card": {"one_rank_nccl_graph": par["mesh_runs"][1],
                            "two_ranks_gloo": par["two_rank_runs"][1]},
        "train_cli_graph": graph_line(cli["train_graph"], 1),
        "tour_train_cli_graph": graph_line(wild["tour_graph"], 1),
        "llff_train_cli_graph": graph_line(wild["llff_graph"], 1),
        "barf_train_cli_graph": graph_line(barf["barf_graph"], 1),
        "max_abs_err": max(v["bwd_err"] for v in bf16_rows),
        "max_norm_rel_err": max(v["bwd_norm_rel"] for v in bf16_rows),
        "norm_rel_limit": BWD_BF16_NORM,
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None}, {
        # the f32 instances (the CLIs' default --compute_dtype): launches
        # over the f32 frame and one f32 device-pool train step; ms at the
        # bf16 rows' shapes; bound: three TF32 passes, beside the CUDA cores'
        "name": "fused_mlp_fwd_f32", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerf_fl_tpu/ops/fused_mlp.py:319",
        "launches": launches32 + graph["f32_launches"][0],
        "launches_by_path": {"render_frame_f32": launches32,
                             "train_step_f32": graph["f32_launches"][0]},
        "max_abs_err": max([fwd32["err"]] + [v["fwd_err"]
                                             for v in f32_rows]),
        "ms": fwd32["ms"], "plain_ms": fwd32["plain_ms"],
        "bound_ms": fwd32["bound_ms"], "bound_by": fwd32["bound_by"],
        "bound_cuda_core_ms": fwd32["core_ms"],
        "step_ms": {"fine": bwd32["fwd_ms"],
                    "coarse": train["coarse_f32"]["fwd_ms"]},
        "library_ms": None}, {
        "name": "fused_mlp_bwd_f32", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "nerf_fl_tpu/ops/fused_mlp.py:359",
        "launches": graph["f32_launches"][1],
        "launches_by_path": {"render_frame_f32": 0,
                             "train_step_f32": graph["f32_launches"][1]},
        "max_abs_err": max(v["bwd_err"] for v in f32_rows),
        "max_rel_err_ties_matched": max(v["bwd_rel"] for v in f32_rows),
        "rel_limit": BWD_F32_REL,
        "ties": {"fine": bwd32["ties"],
                 "coarse": train["coarse_f32"]["ties"]},
        "ms": bwd32["ms"], "plain_ms": bwd32["plain_ms"],
        "bound_ms": bwd32["bound_ms"], "bound_by": bwd32["bound_by"],
        "bound_cuda_core_ms": bwd32["core_ms"],
        "coarse_ms": train["coarse_f32"]["ms"],
        "library_ms": None}, {
        # the render's test-time coarse pass at f32 (no TPU kernel: the JAX
        # package runs that pass on XLA's GEMMs); ms at the size of its
        # launches in the f32 frame, beside the plain MLP path it replaced,
        # and at all of the f32 kernel's points
        "name": "fused_sigma_f32", "route": "cuda",
        "source": "nerf_fl_torch/csrc/fused_mlp_fwd.cu",
        "replaces": None,
        "launches": sigma32,
        "launches_by_path": {"render_frame_f32": sigma32},
        "max_abs_err": sigma["err"], "ms": sigma["ms"],
        "plain_ms": sigma["plain_ms"], "bound_ms": sigma["bound_ms"],
        "bound_by": sigma["bound_by"], "bound_cuda_core_ms": sigma["core_ms"],
        "replaced_path_ms": sigma["mlp_ms"], "library_ms": None,
        "points": sigma["points"], "all_points": sigma["all_points"]},
        *ipe_rows]
    # the probes: launches from the anatomy entry points' run (their counts
    # read after the render frame and the train step are those paths')
    for name, row in probes.items():
        probe = anatomy.PROBES[name]
        kernels.append({
            "name": f"anatomy_{name}", "route": "cuda",
            "source": f"nerf_fl_torch/csrc/{probe.source}.cu",
            "replaces": probe.replaces, "launches": row["launches"],
            "launches_by_path": {"render_frame": on_render[name],
                                 "train_step": on_train[name],
                                 "train_and_eval_cli": on_cli[name],
                                 "wild_train_and_eval_cli": on_wild[name],
                                 "barf_train_and_eval_cli": on_barf[name],
                                 "tools_cli": on_tools[name],
                                 "parallel": on_par[name],
                                 "kernel_anatomy": row["launches"]},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            **({"parent_device_ms": row["parent_device_ms"]}
               if "parent_device_ms" in row else {})})
    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s in all, "
          f"the arm sub-steps {arm_s:.1f} s, phase 11 {barf_s:.1f} s, phase "
          f"12 {tools_s:.1f} s, phase 13 {par_s:.1f} s, phase 14 "
          f"{colmap_s['phase']:.1f} s")
    print("[arm_step] " + json.dumps({k: round(v, 3) for k, v in arms.items()}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
