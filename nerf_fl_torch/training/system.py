"""Model assembly, the train step, chunked rendering and the train loop.

Counterpart of ``nerf_fl_tpu/training/system.py``: ``build_params``,
the train step on world-space rays (``make_train_step``, with
``microbatch`` and ``steps_per_execution``, and ``stack_batches``), the
device-resident ray pool (``epoch_perm``, ``make_device_pool_step``),
``val_chunk_cap``, ``render_chunked`` and ``render_chunked_async``, and
the training system (``config_from_hparams``, ``DevicePrefetcher``,
``NeRFSystem``, ``gauge_val_psnr``) that ``nerf_fl_torch.train`` drives.
Rays come world-space (8 columns) or, for Phototourism, as camera-frame
directions (5 columns, ``ray_format="camdir"``) that ``assemble_world_rays``
poses inside the step from the learned-pose table, which pose refinement
(BARF) trains: the pose deltas' updates are scaled by ``pose_lr_mult`` and
held at zero until ``pose_warmup_epochs``, and the positional encoding is
annealed by the epoch.  With a ``parallel.make_mesh`` mesh the step,
the pool step and the chunked render are data-parallel (and the field
tensor-parallel under a model axis); ``NeRFSystem`` builds the mesh of a
``torch.distributed`` job.

``steps_per_execution`` K > 1 is JAX's ``lax.scan`` of K steps in one
dispatch.  On the card its counterpart is a CUDA graph of one sub-step
(batch in, render, loss, backward, Adam, metrics out), captured once and
replayed for each sub-step, so a replay costs about its device time and no
host dispatch (``_StepGraph``).  The lr and the epoch reach the graph as
device tensors filled before each call, so BARF's annealing and the pose
warmup follow the epoch in a replay; the K sub-steps of a call share one
epoch, as JAX's scan does.  On the CPU the same sub-step runs eagerly K
times: the plain version the graph is held to.  JAX's ``fold_in_range``
(one stacked PRNG key a sub-step) has no counterpart: the port draws from
a ``torch.Generator``, whose Philox offset advances with each sub-step in
a replay exactly as in an eager step, so K sub-steps draw what K eager
steps draw.  The card's PyTorch lets a graph register a generator
(``CUDAGraph.register_generator_state``), so any CUDA generator, or the
device's default one (None), may drive the draws.
"""
from __future__ import annotations

import contextlib
import functools
import os
import queue
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core.rays import get_rays
from ..data.sampler import host_rows
from ..device import resolve_device
from ..models import init_embedding, init_learn_pose, init_nerf, pose_for
from ..parallel import mesh as mesh_mod
from ..render import RenderConfig, render_rays
from ..utils.spans import PoseMark, mark, span
from .losses import loss_dict
from .optimizers import named_leaves, set_lr


def build_params(cfg: RenderConfig, n_vocab: int, *,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 init_poses: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """{'nerf_coarse', ['nerf_fine'], ['embedding_a'], ['embedding_t'],
    ['learn_poses']}; for mip-NeRF (``cfg.model`` "mipnerf") {'nerf'}, the
    one field both levels share, initialised as mip-NeRF's (glorot),
    whose weight gradients from the two levels add into one set.

    Everything is drawn on ``generator``'s device (the CPU with torch's
    default generator if None) and then moved to ``device``; a CPU
    generator gives the same weights on every device.  ``device`` None
    means CUDA, and raises where there is none.  The embedding tables are
    ``nn.Parameter``s, trained with the fields.  ``init_poses`` (N, 4, 4)
    adds the learned-pose table (``models.poses.LearnPose``: zero deltas
    on those poses).
    """
    dev = resolve_device(device)
    draw = generator.device if generator is not None else None
    if cfg.model == "mipnerf":
        return {"nerf": init_nerf(cfg.nerf_config("mip"), generator=generator,
                                  device=draw, init="glorot").to(dev)}
    params: Dict[str, Any] = {
        "nerf_coarse": init_nerf(cfg.nerf_config("coarse"),
                                 generator=generator, device=draw)}
    if cfg.N_importance > 0:
        params["nerf_fine"] = init_nerf(cfg.nerf_config("fine"),
                                        generator=generator, device=draw)
    for key, on, dim in (("embedding_a", cfg.encode_a, cfg.N_a),
                         ("embedding_t", cfg.encode_t, cfg.N_tau)):
        if on:
            params[key] = init_embedding(n_vocab, dim, generator=generator,
                                         device=draw)
    if init_poses is not None:
        params["learn_poses"] = init_learn_pose(len(init_poses), init_poses)
    return {k: v.to(dev) if isinstance(v, torch.nn.Module)
            else torch.nn.Parameter(v.to(dev)) for k, v in params.items()}


def assemble_world_rays(params, rays: torch.Tensor, ts: torch.Tensor, *,
                        ray_format: str,
                        id_to_cam: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """A batch of stored rays as world-space 8-column rays.

    'world':  rays are already [o, d, near, far] and are returned as they
              are.
    'camdir': rays are [camera-frame dir, near, far]; each ray's pose is
              gathered from the learned-pose table (``all_poses``, every
              camera's pose computed anew) at its image's row, ``ts``
              mapped through ``id_to_cam`` where image ids are sparse, and
              the direction rotated into the world.
    """
    if ray_format == "world":
        return rays
    ids = ts if id_to_cam is None else id_to_cam.index_select(0, ts.long())
    c2ws = pose_for(params["learn_poses"], ids)[:, :3, :]
    rays_o, rays_d = get_rays(rays[:, :3], c2ws)
    return torch.cat([rays_o, rays_d, rays[:, 3:5]], dim=-1)


def make_train_step(cfg: RenderConfig, optimizer: torch.optim.Optimizer, *,
                    loss_name: str = "nerfw", microbatch: int = 1,
                    steps_per_execution: int = 1, ray_format: str = "world",
                    id_to_cam: Optional[np.ndarray] = None,
                    pose_lr_mult: float = 1.0,
                    pose_warmup_epochs: float = 0.0, mesh=None) -> Callable:
    """The train step: render -> loss -> backward -> optimizer step ->
    metrics.  Returns ``step(params, batch, lr, epoch=0.0,
    generator=None)``, which updates the parameters that ``optimizer``
    holds (the trainable ones, ``optimizers.make_trainable_mask``) in place
    and returns the metrics as device scalars: ``train/loss``,
    ``train/psnr`` (from the fine rgb, the coarse one without a fine
    model) and one ``train/<term>`` per loss term.

    ``batch`` is {'rays' (B, 8), 'ts' (B,), 'rgbs' (B, 3)} on the params'
    device; with ``ray_format`` 'camdir' the rays are (B, 5) camera-frame
    directions that ``assemble_world_rays`` poses from the params'
    ``learn_poses`` (``id_to_cam`` maps sparse image ids to its rows). With
    ``microbatch`` M > 1 the gradient is the mean of the gradients of M
    equal slices, each with its own loss (so NeRF-W's log(mean beta) term
    is per slice), and one optimizer step is taken, as the JAX package's
    step does.  ``generator`` drives the stochastic draws (perturb,
    noise_std); on the card it is a CUDA generator.  ``epoch`` (a float or
    an f32 device scalar) anneals BARF's encoding under
    ``cfg.refine_pose``; the pose deltas (the optimizer's ``"pose"`` group,
    ``optimizers.param_groups``) move by ``pose_lr_mult * (epoch >=
    pose_warmup_epochs)`` times the optimizer's update, their moments
    accumulating all the same, as the JAX package scales its updates.

    With ``steps_per_execution`` K > 1 it returns ``multi(params, batches,
    lr, epoch=0.0, generator=None, valid=None)`` instead, which runs K
    steps of ``stack_batches``'s stacked ``batches`` ({'rays' (K, B, 8),
    ...}) at one lr and returns the metrics with a leading K axis, as
    device tensors and without a host sync.  ``valid`` (a numpy bool (K,),
    None for all) must be a prefix: the sub-steps it marks False are not
    run, leave the parameters and the optimizer state untouched, and read
    NaN in the metrics.  On the card the sub-steps replay a CUDA graph
    (``_StepGraph``; ``multi.graph`` counts its captures) or the call
    raises: it never runs them eagerly instead.  The optimizer must then be
    capturable with a device lr, as every optimizer that
    ``optimizers.build_optimizer`` makes on the card is; another one (torch's
    own SGD) raises.

    With ``mesh`` (``parallel.make_mesh``) the step is data-parallel:
    ``batch`` holds this rank's rows of the global batch (``shard_batch``;
    ``data.sampler.host_rows`` with ``microbatch``), the gradients and the
    metrics are reduced over the data group (``_train_body``), and every
    rank returns the global step's metrics.
    """
    body = _train_body(cfg, optimizer, loss_name, microbatch, ray_format,
                       id_to_cam, pose_lr_mult, pose_warmup_epochs, mesh)

    def step(params, batch, lr, epoch=0.0, generator=None):
        with span("nerf.step"):
            set_lr(optimizer, lr)
            return body(params, batch, epoch, generator)

    K = steps_per_execution
    if K <= 1:
        return step
    graph = _StepGraph(body, optimizer, K)

    def feed(statics, batches, fresh):
        if fresh:
            statics["stage"] = {k: torch.empty_like(v, device=graph.device)
                                for k, v in batches.items()}
        for k, v in batches.items():
            statics["stage"][k].copy_(v)

    def load(statics, k):
        return {name: v.index_select(0, k)[0]
                for name, v in statics["stage"].items()}

    def multi(params, batches, lr, epoch=0.0, generator=None, valid=None):
        shapes = tuple((k, tuple(v.shape), v.dtype)
                       for k, v in sorted(batches.items()))
        if any(shape[0] != K for _, shape, _ in shapes):
            raise ValueError(f"batches must be stacked {K} deep: {shapes}")
        with span("nerf.step"):
            return graph.run(params, lr, epoch, generator,
                             _valid_count(valid, K), shapes,
                             lambda st, fresh: feed(st, batches, fresh),
                             load)

    multi.graph = graph
    return multi


def _train_body(cfg: RenderConfig, optimizer: torch.optim.Optimizer,
                loss_name: str, microbatch: int, ray_format: str = "world",
                id_to_cam: Optional[np.ndarray] = None,
                pose_lr_mult: float = 1.0,
                pose_warmup_epochs: float = 0.0, mesh=None) -> Callable:
    """``body(params, batch, epoch, generator)``: one train step at the lr
    the optimizer holds (``make_train_step``'s step, ``set_lr`` aside).
    ``id_to_cam`` goes to the device once, here, so a captured step reads
    it where it lies.

    The body is two halves, ``body.grads`` (render, loss, backward: the
    gradients in ``.grad``, the loss terms and the mse as device scalars)
    and ``body.update`` (the optimizer step and the metrics), which a data
    mesh joins with ``body.sync`` (``_GradSync``): the gradients and those
    scalars all-reduced over the data group and divided by its size, which
    is the global batch's gradient because every NeRF-W loss term is a mean
    over rays.  The psnr comes from the reduced mse.  Under the mesh each
    rank renders its rows of the global batch and draws at the global
    shape (``render_rays``' ``shard``), as the JAX package's step does.

    The pose deltas' update is scaled after the optimizer's step, on the
    device: ``torch.lerp(before, after, s)`` with ``s = pose_lr_mult *
    (epoch >= pose_warmup_epochs)`` computed from the epoch tensor, so no
    host value of the epoch enters a captured step.  A scaled lr would not
    do: Ranger's lookahead syncs to the unscaled fast weights (as JAX's
    does, its updates scaled after), and capturable Adam at lr 0 divides 0
    by 0 where a camera's second moment is still 0.  ``lerp`` gives
    ``before`` exactly at s = 0 and ``after`` exactly at s = 1."""
    loss_fn = loss_dict[loss_name]
    typ = "fine" if cfg.N_importance > 0 or cfg.model == "mipnerf" \
        else "coarse"
    params_held = [p for group in optimizer.param_groups
                   for p in group["params"]]
    dev = params_held[0].device
    idmap = None if id_to_cam is None else torch.as_tensor(
        np.asarray(id_to_cam), dtype=torch.int64, device=dev)
    poses = [p for group in optimizer.param_groups if group.get("pose")
             for p in group["params"]]
    scale_poses = bool(poses) and (pose_lr_mult != 1.0
                                   or pose_warmup_epochs > 0.0)
    epoch_as_tensor = cfg.refine_pose or scale_poses
    shard = None if mesh is None or mesh.num_data == 1 else \
        (mesh.data_index, mesh.num_data)

    def as_tensor(epoch):
        if torch.is_tensor(epoch):
            return epoch
        return torch.full((), float(epoch), dtype=torch.float32, device=dev)

    def loss_of(params, b, epoch, generator):
        rays = b["rays"]
        if ray_format != "world":
            mark("pose", dev)
            rays = assemble_world_rays(params, rays, b["ts"],
                                       ray_format=ray_format,
                                       id_to_cam=idmap)
            if rays.requires_grad:
                rays = PoseMark.apply(rays)
        results = render_rays(params, rays, b.get("ts"), cfg,
                              generator=generator, epoch=epoch, shard=shard)
        mark("loss", dev)
        loss_d = loss_fn(results, b["rgbs"])
        mse = torch.mean((results[f"rgb_{typ}"] - b["rgbs"]) ** 2)
        return sum(loss_d.values()), loss_d, mse

    def grads(params, batch, epoch, generator):
        """{'loss', each term, 'mse'}; the gradients in ``.grad``."""
        optimizer.zero_grad(set_to_none=True)
        M = max(1, microbatch)
        n = batch["rays"].shape[0]
        if n % M:
            raise ValueError(f"batch {n} not divisible by microbatch {M}")
        loss = mse = None
        loss_d: Dict[str, torch.Tensor] = {}
        for j in range(M):
            b = {k: v[j * n // M:(j + 1) * n // M] for k, v in batch.items()}
            l_j, ld_j, mse_j = loss_of(params, b, epoch, generator)
            mark("backward", dev)
            l_j.backward()
            loss = l_j.detach() if loss is None else loss + l_j.detach()
            mse = mse_j.detach() if mse is None else mse + mse_j.detach()
            for k, v in ld_j.items():
                loss_d[k] = v.detach() + loss_d.get(k, 0.0)
        if M > 1:          # sum, then divide: the JAX step's order
            for p in params_held:
                if p.grad is not None:
                    p.grad.div_(M)
            loss, mse = loss / M, mse / M
            loss_d = {k: v / M for k, v in loss_d.items()}
        return {"loss": loss, **loss_d, "mse": mse}

    def update(raw, epoch):
        """The optimizer step on the gradients in ``.grad``; the metrics
        of ``raw`` (``grads``' values, reduced under a mesh)."""
        mark("optimizer", dev)
        if scale_poses:
            before = [p.detach().clone() for p in poses]
        optimizer.step()
        if scale_poses:
            s = pose_lr_mult * (epoch >= pose_warmup_epochs).float()
            with torch.no_grad():
                for p, b in zip(poses, before):
                    p.copy_(torch.lerp(b, p, s))
        mark("row", dev)
        metrics = {"train/loss": raw["loss"],
                   "train/psnr": -10.0 * torch.log10(raw["mse"])}
        for k, v in raw.items():
            if k not in ("loss", "mse"):
                metrics[f"train/{k}"] = v
        return metrics

    sync = None if mesh is None else _GradSync(mesh, params_held)

    def body(params, batch, epoch, generator):
        if epoch_as_tensor:
            epoch = as_tensor(epoch)
        raw = grads(params, batch, epoch, generator)
        if sync is not None:
            flat = sync.pack(raw)
            sync.reduce(flat)
            raw = sync.unpack(flat)
        return update(raw, epoch)

    body.grads, body.update, body.sync = grads, update, sync
    return body


class _GradSync:
    """A data mesh's reduction of one step: ``pack`` flattens the held
    parameters' gradients and the step's metric values into one buffer,
    ``reduce`` sums it over the data group in place (one collective a
    sub-step), ``unpack`` divides by the group's size and writes the
    gradients back into ``.grad``, returning the metric values."""

    def __init__(self, mesh, held):
        self.mesh, self.held = mesh, held
        self.names = None

    def pack(self, raw: Dict[str, torch.Tensor]) -> torch.Tensor:
        self.names = list(raw)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.held]
        return torch.cat([g.reshape(-1) for g in grads]
                         + [torch.stack([raw[n] for n in self.names])])

    def reduce(self, flat: torch.Tensor) -> None:
        self.mesh.data.all_reduce(flat)

    def unpack(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        mean = flat / self.mesh.num_data
        at = 0
        for p in self.held:
            g = mean[at:at + p.numel()].view_as(p)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
            at += p.numel()
        return {n: mean[at + j] for j, n in enumerate(self.names)}


def stack_batches(batches, k: Optional[int] = None):
    """Stack a list of batch dicts of tensors leaf-wise into one
    {'rays' (K, B, 8 or 5), ...} dict on the batches' device, for a
    ``steps_per_execution`` train step (one copy in a call).

    If ``k`` exceeds ``len(batches)`` the last batch is repeated to pad the
    stack; returns (stacked, valid) with ``valid``, a numpy bool (k,),
    marking the real sub-steps.
    """
    k = len(batches) if k is None else k
    if not 0 < len(batches) <= k:
        raise ValueError(f"{len(batches)} batches do not fit a stack of {k}")
    valid = np.arange(k) < len(batches)
    batches = list(batches) + [batches[-1]] * (k - len(batches))
    return ({name: torch.stack([b[name] for b in batches])
             for name in batches[0]}, valid)


def _valid_count(valid, k: int) -> int:
    """The number of leading True entries of ``valid`` (None: all ``k``);
    raises unless it is a non-empty prefix of length ``k``."""
    if valid is None:
        return k
    valid = np.asarray(valid, bool)
    n = int(valid.sum())
    if valid.shape != (k,) or not valid[:n].all() or n == 0:
        raise ValueError(f"valid must be a non-empty prefix of {k} sub-steps,"
                         f" got {valid}")
    return n


@contextlib.contextmanager
def _fresh_leaves(params: Dict[str, Any], held):
    """Inside the block, a copy of ``params`` whose trainable tensors
    (``held``) are new leaves on the same storage, swapped into their
    modules and restored after; each hands its grad to its parameter as
    the grad arrives.  A leaf's grad accumulator keeps the stream it was
    made on for as long as any live autograd graph holds it, and one made
    on the default stream cannot take part in a capture; new leaves get
    theirs on the capture stream, whatever graph of the caller's still
    holds the parameters'."""
    held = {id(p) for p in held}
    swapped = []

    def fresh(p):
        q = torch.nn.Parameter(p.detach())
        q.register_post_accumulate_grad_hook(
            lambda q, p=p: setattr(p, "grad", q.grad))
        return q

    out = {}
    try:
        for key, v in params.items():
            if isinstance(v, torch.nn.Module):
                for mod in v.modules():
                    for name, p in list(mod._parameters.items()):
                        if p is not None and id(p) in held:
                            swapped.append((mod, name, p))
                            mod._parameters[name] = fresh(p)
                out[key] = v
            else:
                out[key] = fresh(v) if id(v) in held else v
        yield out
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


class _StepGraph:
    """K sub-steps of a train step a call: on the card one sub-step
    captured as CUDA graphs and replayed, on the CPU run eagerly.

    A sub-step loads its batch through a device counter ``k`` (the
    sub-step's index in the call), runs ``body`` (zero_grad, render, loss,
    backward, optimizer step), writes its metrics into row ``k`` of a (K,
    metrics) buffer and advances ``k``, all on the device, so a replay
    needs no host write.  The graph reads fixed addresses: the call's
    inputs are copied into static buffers (``feed``), the parameters and
    the optimizer state are updated in place, the lr is the optimizer's
    device tensor (``set_lr``, outside the graph), the epoch is the f32
    device scalar ``epoch``, filled before each call (every sub-step of a
    call reads the call's epoch), and the grads live in
    the graph's memory pool from its capture on, where each replay's
    backward writes them and its optimizer step reads them.  The graph is
    captured again only when the call's key changes: the batch shapes, the
    generator, the addresses of the parameters and of whatever ``feed``
    does not copy.

    Under a mesh the sub-step is cut at its collectives
    (``parallel.mesh.Pieces``): the data all-reduce of the gradients and
    metric values (``_GradSync.reduce``) and, under a model axis, the
    tensor-parallel layers' all-reduces and all-gathers, in the forward and
    in the backward.  Each piece between two collectives is a graph of its
    own, in one memory pool; a replay runs each piece and then its
    collective, uncaptured, on the tensors the pieces wrote.  A data mesh
    has one cut (two graphs); data 1 x model 2 at the flagship has 24.
    The one design serves NCCL and gloo (ranks sharing a card) alike.
    ``pieces.plan`` names the cuts in order; after a capture every rank of
    the job compares a checksum of its plan with the others' and the call
    raises where they differ, before any replay could wait on a collective
    that another rank does not run.  On the CPU the same plan is recorded
    on the first sub-step of a new key, the collectives running where they
    are called.

    Capture follows PyTorch's recipe: one eager sub-step on a side stream
    first (it initializes Adam's state, caches and libraries), then the
    capture on that stream.  The eager sub-step is the call's first one,
    so no step is taken that the caller did not ask for; if the capture
    then fails, the call raises after that first sub-step.  ``captures``
    counts the captures and ``replays`` the replays; ``fused_launches``
    holds the fused forward and backward launches that the captured
    sub-step recorded.  The wrappers' ``launches`` count those calls (the
    eager sub-step's and the capture's) and nothing at a replay, which makes
    no host call; the kernels' own count on the card
    (``fused_mlp.kernel_runs``) sees every run.

    Traced (``utils/spans.py``): on the host a call's fills and ``feed``
    under ``nerf.step.prepare``, then ``nerf.step.capture`` and
    ``nerf.step.replay`` (``nerf.step.eager`` on the CPU), then the metrics'
    clone under ``nerf.step.rows``; on the device each sub-step runs from a
    ``load`` mark to an ``end`` mark, through ``pose`` (camera-frame rays),
    the renderer's stages, ``loss``, ``backward``, ``pose_backward`` (pose
    refinement), ``optimizer`` and ``row``.  The marks are nodes of the
    graph and run at every replay.
    """

    def __init__(self, body, optimizer: torch.optim.Optimizer, k: int):
        self.body, self.optimizer, self.K = body, optimizer, k
        sync = getattr(body, "sync", None)
        self.mesh = None if sync is None else sync.mesh
        self.held = [p for g in optimizer.param_groups for p in g["params"]]
        self.device = self.held[0].device
        if self.device.type == "cuda":
            if not all(g.get("capturable") and torch.is_tensor(g["lr"])
                       for g in optimizer.param_groups):
                raise NotImplementedError(
                    f"steps_per_execution > 1 on the card with "
                    f"{type(optimizer).__name__} (not capturable with a "
                    f"device lr) is not ported yet")
        self.key = self.pieces = None
        self.names = self.out = None
        self.statics: Dict[str, Any] = {}
        self.k = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.epoch = torch.zeros((), dtype=torch.float32, device=self.device)
        self.captures = self.replays = 0
        self.fused_launches = None

    @property
    def graph(self):
        """The first captured piece (the whole sub-step without a mesh),
        None before a capture."""
        return None if self.pieces is None or not self.pieces.graphs \
            else self.pieces.graphs[0]

    def sub_step(self, params, generator, load):
        mark("load", self.device)
        with _fresh_leaves(params, self.held) as fresh:
            m = self.body(fresh, load(self.statics, self.k), self.epoch,
                          generator)
        self.write_row(m)
        mark("end", self.device)

    def write_row(self, m):
        if self.out is None:
            self.names = list(m)
            self.out = torch.full((self.K, len(m)), float("nan"),
                                  device=self.device)
        self.out.index_copy_(0, self.k,
                             torch.stack([m[n] for n in self.names])[None])
        self.k.add_(1)

    def run(self, params, lr, epoch, generator, n_valid: int, key, feed,
            load) -> Dict[str, torch.Tensor]:
        with span("nerf.step.prepare"):
            key = (key, generator,
                   tuple(p.data_ptr() for _, p in named_leaves(params)))
            fresh = key != self.key
            if fresh:
                # frees the old graphs' pool
                self.key = self.pieces = None
            set_lr(self.optimizer, lr)
            self.epoch.fill_(float(epoch))
            feed(self.statics, fresh)
            self.k.zero_()
            if self.out is not None:
                self.out.fill_(float("nan"))
        if self.device.type != "cuda":
            with span("nerf.step.eager"):
                for i in range(n_valid):
                    if fresh and i == 0:
                        self.pieces = mesh_mod.Pieces(False)
                        with mesh_mod.recording(self.pieces, self.mesh):
                            self.sub_step(params, generator, load)
                    else:
                        self.sub_step(params, generator, load)
        else:
            first = 0
            if fresh:
                with span("nerf.step.capture"):
                    self._capture(params, generator, load)
                first = 1
            if n_valid > first:
                with span("nerf.step.replay"):
                    for _ in range(first, n_valid):
                        self.pieces.replay()
            self.replays += n_valid - first
        self.key = key
        with span("nerf.step.rows"):
            res = self.out.clone()
            return {n: res[:, j] for j, n in enumerate(self.names)}

    def _capture(self, params, generator, load):
        from ..ops import fused_mlp as fm
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.sub_step(params, generator, load)
        pieces = mesh_mod.Pieces(
            True, generator,
            relaxed=self.mesh is not None and self.mesh.num_model > 1)
        before = (fm.fused_mlp_fwd_cuda.launches,
                  fm.fused_mlp_bwd_cuda.launches)
        # torch.cuda.graph's set-up (no pending work, no cached blocks that
        # the capture could free), but capture_begin / capture_end by hand:
        # torch.cuda.graph leaves the side stream current when a failed
        # capture makes capture_end raise
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        with torch.cuda.stream(side):
            pieces.begin()
            try:
                with mesh_mod.recording(pieces, self.mesh):
                    self.sub_step(params, generator, load)
            finally:
                pieces.end()
        self.fused_launches = (fm.fused_mlp_fwd_cuda.launches - before[0],
                               fm.fused_mlp_bwd_cuda.launches - before[1])
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self.mesh is not None:
            here = torch.tensor([len(pieces.plan), pieces.digest()],
                                dtype=torch.int64, device=self.device)
            every = self.mesh.world.all_gather(here[None]).cpu()
            if not (every == every[:1]).all():
                raise RuntimeError(
                    f"the ranks cut the sub-step at other collectives "
                    f"(cuts, plan checksum by rank: {every.tolist()}); "
                    f"this rank's plan: {pieces.plan}")
        self.pieces = pieces
        self.captures += 1


def epoch_perm(seed: int, epoch: int, n_pool: int,
               n_padded: int) -> np.ndarray:
    """Per-epoch batch order for the device pool: the permutation
    ``RayBatcher`` draws (``np.random.default_rng([seed, epoch])``), so the
    pool and the host-fed path train batch for batch alike; padded by
    whole-cycle wrap-around to ``n_padded``.  int32, as the JAX package's."""
    perm = np.random.default_rng([seed, epoch]).permutation(n_pool) \
        .astype(np.int32)
    if n_padded <= n_pool:
        return perm[:n_padded]
    return np.tile(perm, -(-n_padded // n_pool))[:n_padded]


def make_device_pool_step(cfg: RenderConfig, optimizer: torch.optim.Optimizer,
                          *, batch_size: int, loss_name: str = "nerfw",
                          microbatch: int = 1,
                          steps_per_execution: int = 1,
                          ray_format: str = "world",
                          id_to_cam: Optional[np.ndarray] = None,
                          pose_lr_mult: float = 1.0,
                          pose_warmup_epochs: float = 0.0,
                          mesh=None) -> Callable:
    """Train step that draws its batch from a device-resident pool.

    Returns ``run(params, pool, perm, i, lr, epoch=0.0, generator=None)``:
    ``pool`` is {'rays', 'ts', 'rgbs'} over the whole dataset on the
    device, ``perm`` the epoch's ``epoch_perm`` as a device tensor, and
    step ``i`` of the epoch trains on rows ``perm[i*B:(i+1)*B]``, gathered
    on the device (no host work per step).

    With ``steps_per_execution`` K > 1 it returns ``run(params, pool, perm,
    i0, n_steps, lr, epoch=0.0, generator=None)``, as the JAX package's:
    sub-step k trains on ``perm[(i0+k)B:(i0+k+1)B]`` when ``i0 + k <
    n_steps`` and is not run otherwise (its metrics read NaN); the
    metrics come back with a leading K axis.  The offset is a device scalar
    that the sub-step advances itself, so on the card a replay of the
    step's graph needs no host write (``make_train_step``).  The graph
    reads ``pool`` and ``perm`` where they lie: a new tensor for either (a
    new epoch's ``perm``) captures the step again.  ``ray_format``,
    ``id_to_cam``, ``pose_lr_mult``, ``pose_warmup_epochs`` and ``mesh``
    are ``make_train_step``'s.  Under a data mesh every rank holds the
    whole pool and the epoch's ``perm``, as the JAX package replicates them,
    and gathers its rows of each step's B indices (``host_rows``: its
    contiguous B / data of each of the ``microbatch`` slices).
    """
    B = batch_size
    rows = None
    if mesh is not None:
        rows = host_rows(B, mesh.data_index, mesh.num_data, microbatch)
    if steps_per_execution <= 1:
        step = make_train_step(cfg, optimizer, loss_name=loss_name,
                               microbatch=microbatch, ray_format=ray_format,
                               id_to_cam=id_to_cam, pose_lr_mult=pose_lr_mult,
                               pose_warmup_epochs=pose_warmup_epochs,
                               mesh=mesh)

        def run(params, pool, perm, i, lr, epoch=0.0, generator=None):
            idx = perm[i * B:(i + 1) * B]
            if rows is not None:
                idx = idx.index_select(0, torch.as_tensor(rows,
                                                          device=perm.device))
            idx = idx.long()
            batch = {k: v.index_select(0, idx) for k, v in pool.items()}
            return step(params, batch, lr, epoch, generator)

        return run

    K = steps_per_execution
    graph = _StepGraph(_train_body(cfg, optimizer, loss_name, microbatch,
                                   ray_format, id_to_cam, pose_lr_mult,
                                   pose_warmup_epochs, mesh),
                       optimizer, K)

    def feed(statics, pool, perm, i0, fresh):
        if fresh:
            statics["i0"] = torch.zeros(1, dtype=torch.int64,
                                        device=graph.device)
            statics["rows"] = torch.arange(B, device=graph.device) \
                if rows is None else torch.as_tensor(rows,
                                                     device=graph.device)
        statics["i0"].fill_(i0)
        statics["pool"], statics["perm"] = pool, perm

    def load(statics, k):
        at = (statics["i0"] + k) * B + statics["rows"]
        idx = statics["perm"].index_select(0, at).long()
        return {name: v.index_select(0, idx)
                for name, v in statics["pool"].items()}

    def run(params, pool, perm, i0, n_steps, lr, epoch=0.0, generator=None):
        n_valid = min(K, n_steps - i0)
        if n_valid < 1:
            raise ValueError(f"no step to run: i0 {i0} >= n_steps {n_steps}")
        if (i0 + n_valid) * B > perm.shape[0]:
            raise ValueError(f"perm has {perm.shape[0]} rows, steps up to "
                             f"{i0 + n_valid - 1} need {(i0 + n_valid) * B}")
        with span("nerf.step"):
            key = (B,) + tuple((k, tuple(v.shape), v.dtype, v.data_ptr())
                               for k, v in sorted(pool.items())) \
                + (tuple(perm.shape), perm.dtype, perm.data_ptr())
            return graph.run(params, lr, epoch, generator, n_valid, key,
                             lambda st, fresh: feed(st, pool, perm, i0,
                                                    fresh),
                             load)

    run.graph = graph
    return run


def params_device(params: Dict[str, Any]) -> torch.device:
    m = params["nerf"] if "nerf" in params else params["nerf_coarse"]
    return m.xyz[0].weight.device


def val_chunk_cap(chunk: int, n_samples: int, n_importance: int) -> int:
    """Largest render chunk (power of two, >= 1024) whose sample-point count
    stays under a ~6.5M budget; the same rule as the JAX package, so both
    render in the same chunks."""
    total = n_samples * (2 if n_importance > 0 else 1) + n_importance
    cap = max(1024, 2 ** int(np.log2(6_500_000 / max(1, total))))
    return min(chunk, cap)


def render_chunked(params, rays, ts, cfg: RenderConfig, *,
                   chunk: int = 32 * 1024, test_time: bool = True,
                   output_transient: bool = True, epoch: float = 0.0,
                   generator: Optional[torch.Generator] = None, keys=None,
                   inflight: int = 4, a_override=None,
                   device=None, mesh=None) -> Dict[str, np.ndarray]:
    """Render arbitrarily many rays in fixed-size chunks; returns numpy
    arrays.  The tail chunk is padded by repeating its last ray and trimmed
    after, so every chunk has the same shape; fewer rays than a chunk are
    rendered as one chunk of their own size (padding them to ``chunk``
    would only add work).  ``keys`` restricts the
    returned (and copied back) outputs.  ``device`` None means CUDA; the
    params must live on the device.

    With ``mesh`` (a data axis of more than one rank) the render is
    data-parallel, as the JAX package's: the chunk is rounded up to a
    multiple of the data size, each rank renders its contiguous rows of
    every chunk (drawing at the chunk's shape, ``render_rays``' ``shard``)
    and the pixel outputs are all-gathered, so every rank returns the
    whole frame.  Every rank of the job must call it."""
    return render_chunked_async(
        params, rays, ts, cfg, chunk=chunk, test_time=test_time,
        output_transient=output_transient, epoch=epoch, generator=generator,
        keys=keys, inflight=inflight, a_override=a_override, device=device,
        mesh=mesh)()


def render_chunked_async(params, rays, ts, cfg: RenderConfig, *,
                         chunk: int = 32 * 1024, test_time: bool = True,
                         output_transient: bool = True, epoch: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         keys=None, inflight: int = 4, a_override=None,
                         device=None, mesh=None):
    """Dispatch a full render and defer the final readback.

    Every chunk is enqueued before return; at most ``inflight`` chunks'
    results wait on the device before the oldest is copied back (and,
    under ``mesh``, gathered: ``render_chunked``).  Returns a ``finish()``
    callable producing render_chunked's result dict.

    Traced under ``nerf.render.frame`` (``utils/spans.py``): each chunk's
    pad and copy to the device under ``nerf.render.upload``, its
    ``render_rays`` under ``nerf.render.enqueue``, each read-back under
    ``nerf.render.readback``, and ``finish()`` under
    ``nerf.render.finish``; on the device each chunk runs from an
    ``upload`` mark to an ``end`` mark.
    """
    with span("nerf.render.frame"):
        want, dev = resolve_device(device), params_device(params)
        if dev.type != want.type or (want.index is not None and dev != want):
            raise ValueError(f"params live on {dev}, not {want}")
        rays = torch.as_tensor(np.asarray(rays, np.float32) if not
                               torch.is_tensor(rays) else rays)
        ts = torch.as_tensor(np.asarray(ts) if not torch.is_tensor(ts) else ts)
        if a_override is not None:
            a_override = torch.as_tensor(a_override, dtype=torch.float32,
                                         device=dev)
        keys = None if keys is None else frozenset(keys)
        n = len(rays)
        chunk = max(1, min(chunk, n))
        parts = 1 if mesh is None else mesh.num_data
        if chunk % parts:
            # every rank renders the same number of rows of every chunk
            chunk = -(-chunk // parts) * parts
            print(f"[render] rounding chunk up to {chunk} "
                  f"(multiple of data={parts})")
        shard = None if parts == 1 else (mesh.data_index, parts)
        per = chunk // parts
        outs = defaultdict(list)
        pending: deque = deque()

        def drain_one():
            with span("nerf.render.readback"):
                res, keep = pending.popleft()
                for k, v in res.items():
                    v = v.float()
                    if shard is not None:
                        v = mesh.data.all_gather(v)
                    outs[k].append(v[:keep].cpu().numpy())

        with torch.no_grad():
            for i in range(0, n, chunk):
                with span("nerf.render.upload"):
                    mark("upload", dev)
                    r = rays[i:i + chunk]
                    t = ts[i:i + chunk]
                    keep = len(r)
                    pad = chunk - keep
                    if pad > 0:
                        r = torch.cat([r, r[-1:].expand(pad, -1)], 0)
                        t = torch.cat([t, t[-1:].expand(pad)], 0)
                    if shard is not None:
                        r = r[shard[0] * per:(shard[0] + 1) * per]
                        t = t[shard[0] * per:(shard[0] + 1) * per]
                    r = r.to(dev, non_blocking=True)
                    t = t.to(dev, non_blocking=True)
                with span("nerf.render.enqueue"):
                    a_emb = None if a_override is None else \
                        a_override.expand(per, a_override.shape[-1])
                    res = render_rays(params, r, t, cfg, generator=generator,
                                      epoch=epoch, test_time=test_time,
                                      output_transient=output_transient,
                                      a_embedded=a_emb, shard=shard)
                    if keys is not None:
                        res = {k: v for k, v in res.items() if k in keys}
                    mark("end", dev)
                pending.append((res, keep))
                if len(pending) >= max(1, inflight):
                    drain_one()

    def finish():
        with span("nerf.render.finish"):
            while pending:
                drain_one()
            return {k: np.concatenate(v, 0) for k, v in outs.items()}

    return finish


# ----------------------------------------------------------------------
# the training system
# ----------------------------------------------------------------------

def config_from_hparams(hparams, white_back: bool) -> RenderConfig:
    """The render config of a train run's flags (``--use_pallas`` is
    ``use_fused``: auto None, on True, off False); flags absent from
    ``hparams`` (eval's have no --perturb / --noise_std) count as the train
    parser's defaults."""
    g = functools.partial(getattr, hparams)
    return RenderConfig(
        N_samples=hparams.N_samples, N_importance=hparams.N_importance,
        use_disp=hparams.use_disp, perturb=g("perturb", 1.0),
        noise_std=g("noise_std", 1.0), white_back=white_back,
        N_emb_xyz=hparams.N_emb_xyz, N_emb_dir=hparams.N_emb_dir,
        encode_a=hparams.encode_a, N_a=hparams.N_a,
        encode_t=hparams.encode_t, N_tau=hparams.N_tau,
        beta_min=hparams.beta_min,
        refine_pose=g("refine_pose", False),
        barf_schedule=g("barf_schedule", "fork"),
        barf_epoch_start=g("barf_epochs", [4, 8])[0],
        barf_epoch_end=g("barf_epochs", [4, 8])[1],
        compute_dtype=g("compute_dtype", "float32"),
        use_fused=_TRISTATE[g("use_pallas", "auto")],
        fast_trig=_TRISTATE[g("fast_trig", "auto")],
        remat_mlp=g("remat_mlp", False),
        mlp_depth=g("mlp_depth", 8), mlp_width=g("mlp_width", 256),
        model=g("model", "nerf"))


_TRISTATE = {"auto": None, "on": True, "off": False}


class _Moved(NamedTuple):
    item: Any
    event: Any


def _map_batch(x, fn, in_dict=False):
    """Apply ``fn`` to the array leaves inside dicts of ``x`` (a batch, or
    a tuple holding one); other members pass through."""
    if isinstance(x, dict):
        return {k: _map_batch(v, fn, True) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map_batch(v, fn, in_dict) for v in x)
    if in_dict and isinstance(x, (np.ndarray, torch.Tensor)):
        return fn(x)
    return x


class DevicePrefetcher:
    """Host -> device feed on a worker thread.

    A daemon thread applies ``put`` (host work: a gather, a stack) to the
    items of ``it`` up to ``depth`` ahead of the consumer and, with a
    ``device``, moves the arrays inside the item's dicts there.  On the
    card it copies from pinned host memory on a side stream and records an
    event; the consumer's stream waits on that event and each tensor is
    recorded on the consuming stream, so the copy overlaps the step before
    and its memory is not reused early.  ``close()`` stops the worker,
    drops what is queued and joins the thread.
    """

    _END = object()

    def __init__(self, it, put=None, depth: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = False
        self._dev = None if device is None else torch.device(device)
        cuda = self._dev is not None and self._dev.type == "cuda"
        self._side = torch.cuda.Stream(self._dev) if cuda else None

        def to_device(x):
            t = torch.as_tensor(x)
            if self._side is None:
                return t.to(self._dev)
            return t.pin_memory().to(self._dev, non_blocking=True)

        def move(item):
            if self._dev is None:
                return item
            if self._side is None:
                return _map_batch(item, to_device)
            with torch.cuda.stream(self._side):
                out = _map_batch(item, to_device)
                event = torch.cuda.Event()
                event.record(self._side)
            return _Moved(out, event)

        def blocking_put(item):
            # gives up once the consumer has closed the feed, so a worker
            # never stays parked on a full queue holding device memory
            while not self._stop:
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                for b in it:
                    if self._stop or not blocking_put(
                            move(put(b) if put is not None else b)):
                        return
            except BaseException as e:  # raised on the consumer's side
                self._err = e
            finally:
                blocking_put(self._END)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        b = self._q.get()
        if b is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        if isinstance(b, _Moved):
            stream = torch.cuda.current_stream(self._dev)
            stream.wait_event(b.event)
            _map_batch(b.item, lambda t: t.record_stream(stream))
            return b.item
        return b

    def close(self):
        """Stop the worker, drop queued items and join the thread;
        idempotent."""
        self._stop = True
        while self._t.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return


# Kineto keeps a device record only if its timestamp, moved onto the host
# clock, lies between the profiler's start and stop.  On an H100 (torch
# 2.11, CUDA 12.8) the moved clock read up to ~1 ms early or late, at times
# ~14 ms, so windows that began and ended in a synchronize lost their first
# or last kernels' records; with this much quiet inside the profiler on
# each side no window lost a fused kernel's record
# (experiments/trace_records.py)
PROFILE_MARGIN_S = 0.1


def _host_tensor(a: np.ndarray, dtype) -> torch.Tensor:
    """``a`` as a CPU tensor of ``dtype``, copied where numpy cannot lend
    a writable array (a memory-mapped cache)."""
    a = np.asarray(a, dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class NeRFSystem:
    """End-to-end training: the counterpart of the JAX package's
    ``NeRFSystem`` (``setup``, ``configure``, ``restore``,
    ``run_validation``, ``fit``) on ``device`` (None: CUDA).

    With ``--num_gpus`` x ``--model_parallel`` > 1 (or ``--num_hosts`` >
    1) it is one rank of a ``torch.distributed`` job (``parallel.launch``
    starts the ranks; the train CLI does): ``setup`` builds the (data,
    model) mesh (``parallel.make_mesh``) and keeps this rank's rows of
    every batch, ``configure`` fails every rank if they would resume from
    different states, broadcasts the parameters from rank 0 and shards
    them under ``--model_parallel`` (``place_params``), the steps reduce
    their gradients over the data group, validation renders through the
    mesh, and only global rank 0 logs and writes checkpoints (whole ones:
    a tensor-parallel model is gathered first).  A multi-host job feeds
    host-sharded batches (no device pool).  Without those flags no process
    group exists and ``mesh`` is None.

    ``fit`` runs the feed that ``configure`` chose: the device-resident
    pool (``make_device_pool_step``; one permutation buffer on the device,
    refilled each epoch, so a graph step is captured once for the run),
    host-fed groups of ``steps_per_execution`` K > 1 batches (stacked on
    the worker thread of a ``DevicePrefetcher``), or host-fed single steps.
    Metrics reach the host only at log steps.  The per-epoch lr reaches a
    captured step through ``set_lr``'s device tensor, the epoch through the
    step's epoch tensor; under ``--refine_pose --barf_schedule paper`` the
    epoch is continuous, ``epoch + i / steps_per_epoch`` for a call whose
    first step is step i of the epoch, and the epoch's validation renders
    at ``epoch + 1``, as the JAX package's fit does.  Each epoch ends in a
    validation pass and a checkpoint; ``epoch_stats`` keeps each epoch's
    seconds and rays/s, ``profile_window`` the ``--profile_dir`` window.
    ``setup`` keeps the clean initial poses in ``true_poses`` and, under
    ``--pose_noise``, trains from ``perturb_poses`` of them
    (``init_poses``).
    """

    def __init__(self, hparams, logger=None, device=None):
        self.hparams = hparams
        self.logger = logger
        self.device = resolve_device(device)
        self.loss_name = "nerfw"
        self.global_step = 0
        self.start_epoch = 0
        self.epoch_stats = []
        self.profile_window = None
        self.mesh = None

    @property
    def is_main(self) -> bool:
        """Whether this process writes the logs and checkpoints."""
        return self.mesh is None or self.mesh.is_main

    def _make_mesh(self):
        """The job's mesh, None for one device and one host."""
        import torch.distributed as dist
        from ..parallel import make_mesh, multihost
        g = functools.partial(getattr, self.hparams)
        num_data, num_model = max(1, g("num_gpus", 1)), \
            max(1, g("model_parallel", 1))
        if num_data * num_model == 1 and g("num_hosts", 1) == 1:
            return None
        if not dist.is_initialized():
            raise ValueError(
                f"--num_gpus {num_data} x --model_parallel {num_model} over "
                f"--num_hosts {g('num_hosts', 1)} needs one process a rank "
                "in a torch.distributed job: run it through python -m "
                "nerf_fl_torch.train (or nerf_fl_torch.parallel.launch)")
        return make_mesh(num_data, num_model,
                         devices=multihost.job_devices(self.device))

    # -- datasets ------------------------------------------------------
    def setup(self):
        from ..data import RayBatcher, dataset_dict
        from ..models import validate_vocab
        h = self.hparams
        self.mesh = self._make_mesh()
        # --pose_noise needs the learned-pose (camdir) rays even without
        # refinement: the noisy control arm trains with frozen deltas
        refine = getattr(h, "refine_pose", False) or \
            any(getattr(h, "pose_noise", (0.0, 0.0)))
        kwargs = {"root_dir": h.root_dir}
        if h.dataset_name == "phototourism":
            kwargs.update(img_downscale=h.img_downscale,
                          val_num=getattr(h, "num_gpus", 1),
                          use_cache=h.use_cache, refine_pose=refine)
        elif h.dataset_name == "blender":
            kwargs.update(img_wh=tuple(h.img_wh), perturbation=h.data_perturb,
                          refine_pose=refine,
                          mip=getattr(h, "model", "nerf") == "mipnerf")
        elif h.dataset_name == "llff":
            kwargs.update(img_wh=tuple(h.img_wh),
                          spheric_poses=h.spheric_poses,
                          val_num=getattr(h, "num_gpus", 1))
        self.train_dataset = dataset_dict[h.dataset_name](split="train",
                                                          **kwargs)
        self.val_dataset = dataset_dict[h.dataset_name](split="val", **kwargs)
        self.cfg = config_from_hparams(h, self.train_dataset.white_back)
        if self.cfg.model == "mipnerf":
            self.loss_name = "mip"
        self.ray_format = getattr(self.train_dataset, "ray_format", "world")
        max_id = int(np.max(self.train_dataset.all_ts))
        if self.cfg.encode_a or self.cfg.encode_t:
            validate_vocab(h.N_vocab, max_id)

        # the learned-pose table's initial poses, in image order, and the
        # map from sparse image ids to its rows (the JAX package's)
        poses = np.asarray(self.train_dataset.poses, np.float32)
        self.true_poses = self.init_poses = np.concatenate(
            [poses, np.tile(np.array([[[0, 0, 0, 1]]], np.float32),
                            (len(poses), 1, 1))], axis=1)
        rot_deg, trans_frac = getattr(h, "pose_noise", (0.0, 0.0))
        if rot_deg or trans_frac:
            # seeded SE(3) noise on the initial poses, which the deltas can
            # represent exactly; the clean ones stay in true_poses
            if self.ray_format != "camdir":
                raise ValueError(
                    "--pose_noise requires the learned-pose ray path "
                    "(camdir); this dataset baked world-space rays that "
                    "would silently ignore the noisy poses")
            from ..models.poses import perturb_poses, pose_errors
            self.init_poses = perturb_poses(
                self.true_poses, rot_deg, trans_frac,
                seed=getattr(h, "pose_noise_seed", 0))
            r0, t0 = pose_errors(self.init_poses, self.true_poses)
            print(f"[pose_noise] injected rot {r0:.3f} deg / "
                  f"trans {t0:.4f} (aligned means over "
                  f"{len(self.init_poses)} cams)", flush=True)
        ids = getattr(self.train_dataset, "img_ids", list(range(len(poses))))
        self.id_to_cam = None
        if list(ids) != list(range(len(poses))):
            idmap = np.zeros(max(max(ids), max_id) + 1, np.int32)
            for i, id_ in enumerate(ids):
                idmap[id_] = i
            self.id_to_cam = idmap
        shard = {} if self.mesh is None else dict(
            host_index=self.mesh.data_index, host_count=self.mesh.num_data,
            microbatch=max(1, getattr(h, "microbatch", 1)))
        self.batcher = RayBatcher(
            self.train_dataset.all_rays, self.train_dataset.all_ts,
            self.train_dataset.all_rgbs, h.batch_size,
            seed=getattr(h, "seed", 0), **shard)

    # -- state ---------------------------------------------------------
    def configure(self):
        from .checkpoints import latest_checkpoint
        from .optimizers import (build_optimizer, make_trainable_mask,
                                 param_groups)
        h, dev = self.hparams, self.device
        seed = getattr(h, "seed", 0)
        refine = getattr(h, "refine_pose", False)
        needs_poses = self.ray_format == "camdir" or refine
        self.params = build_params(
            self.cfg, h.N_vocab, generator=torch.Generator().manual_seed(seed),
            device=dev, init_poses=self.init_poses if needs_poses else None)
        # without pose refinement the pose table is frozen: no gradient,
        # not in the optimizer; with it the deltas form their own group
        self.mask = make_trainable_mask(self.params, refine)
        for name, p in named_leaves(self.params):
            p.requires_grad_(self.mask[name])
        self.optimizer = build_optimizer(h, param_groups(self.params,
                                                         self.mask))
        pose_lr = dict(pose_lr_mult=getattr(h, "pose_lr_mult", 1.0),
                       pose_warmup_epochs=getattr(h, "pose_warmup_epochs",
                                                  0.0))

        ckpt_path = getattr(h, "ckpt_path", None)
        if ckpt_path == "auto":
            ckpt_path = latest_checkpoint(os.path.join(h.save_path,
                                                       h.exp_name))
            print(f"[ckpt] auto-resume from {ckpt_path}" if ckpt_path else
                  "[ckpt] auto-resume: no checkpoint found, starting fresh")
        if ckpt_path:
            self.restore(ckpt_path)
        mesh = self.mesh
        if mesh is not None:
            # every rank resolves --ckpt_path on its own (auto-resume scans
            # its save_path); ranks that disagree would mix parameter
            # states, so every rank fails instead
            here = torch.tensor([self.start_epoch, self.global_step],
                                dtype=torch.int64, device=dev)
            every = mesh.world.all_gather(here[None])
            if not bool((every == every[:1]).all()):
                raise RuntimeError(
                    "checkpoint resume state differs across hosts — use a "
                    "shared save_path or pass an explicit --ckpt_path "
                    f"(epoch, step by rank: {every.tolist()})")
            from ..parallel import place_params
            place_params(mesh, self.params, self._model_parallel(),
                         self.optimizer)

        self.spe = max(1, getattr(h, "steps_per_execution", 1))
        mb = max(1, getattr(h, "microbatch", 1))
        if mb > 1 and h.batch_size % mb:
            raise ValueError(f"batch_size {h.batch_size} not divisible by "
                             f"--microbatch {mb}")
        b = self.batcher
        pool_bytes = b.rays.nbytes + b.ts.nbytes + b.rgbs.nbytes
        dp_mode = getattr(h, "device_pool", "auto")
        self.device_pool = None
        use_pool = dp_mode == "on" or (dp_mode == "auto"
                                       and pool_bytes <= (2 << 30))
        from ..parallel import multihost
        if use_pool and multihost.is_multihost():
            if dp_mode == "on":
                print("[data] --device_pool on ignored: multihost feeds "
                      "host-sharded batches")
            use_pool = False
        if use_pool:
            pool = {"rays": _host_tensor(b.rays, np.float32),
                    "ts": _host_tensor(b.ts, np.int32),
                    "rgbs": _host_tensor(b.rgbs, np.float32)}
            self.device_pool = ({k: v.to(dev) for k, v in pool.items()}, b.n)
            n_groups = max(1, -(-b.steps_per_epoch() // self.spe))
            self._perm = torch.empty(n_groups * self.spe * h.batch_size,
                                     dtype=torch.int32, device=dev)
            self.train_step = make_device_pool_step(
                self.cfg, self.optimizer, batch_size=h.batch_size,
                loss_name=self.loss_name, microbatch=mb,
                steps_per_execution=self.spe, ray_format=self.ray_format,
                id_to_cam=self.id_to_cam, mesh=mesh, **pose_lr)
            print(f"[data] device-resident ray pool: {pool_bytes / 1e6:.0f} "
                  f"MB uploaded once; batches are drawn on the device")
        else:
            self.train_step = make_train_step(
                self.cfg, self.optimizer, loss_name=self.loss_name,
                microbatch=mb, steps_per_execution=self.spe,
                ray_format=self.ray_format, id_to_cam=self.id_to_cam,
                mesh=mesh, **pose_lr)
        # the same generator state on every rank: each draws at the global
        # batch's shape and keeps its rows
        self.generator = torch.Generator(dev).manual_seed(seed + 1234)

    def _model_parallel(self) -> bool:
        return self.mesh is not None and self.mesh.num_model > 1

    def restore(self, path: str):
        """A full checkpoint (with ``opt_state``; either format) resumes
        weights, optimizer state, epoch and step; a weights-only one loads
        non-strictly, honouring ``--prefixes_to_ignore``."""
        from . import checkpoints
        ckpt = checkpoints.load_checkpoint(path)
        leaves = dict(named_leaves(self.params))
        if "opt_state" in ckpt:
            sd = ckpt["state_dict"]
            have = set()
            for k, v in sd.items():
                have |= {f"{k}.{n}" for n in v} if isinstance(v, dict) \
                    else {k}
            missing = sorted(set(leaves) - have)
            if missing:
                raise ValueError(f"{path} lacks {missing} for a full resume")
            checkpoints.load_into(self.params, ckpt)
            if ckpt["format"] == "torch":
                lrs = [g["lr"] for g in self.optimizer.param_groups]
                self.optimizer.load_state_dict(ckpt["opt_state"])
                for g, lr in zip(self.optimizer.param_groups, lrs):
                    g["lr"] = lr          # keep the device lr of a capture
            else:
                checkpoints.opt_state_from_jax(ckpt["opt_state"],
                                               self.optimizer, leaves)
            self.start_epoch = int(ckpt.get("epoch", -1)) + 1
            self.global_step = int(ckpt.get("global_step", 0))
            print(f"[ckpt] restored {path} (resume at epoch "
                  f"{self.start_epoch})")
        else:
            prefixes = tuple(getattr(self.hparams, "prefixes_to_ignore",
                                     ("loss",)) or ())
            checkpoints.load_into(self.params, ckpt, prefixes)
            loaded = sorted(n for n in set(self.params) & set(
                ckpt["state_dict"]) if not any(n.startswith(p)
                                               for p in prefixes))
            print(f"[ckpt] loaded weights (non-strict) from {path}: "
                  f"{', '.join(loaded)}")

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    # -- validation ----------------------------------------------------
    def run_validation(self, epoch: int, max_images: Optional[int] = None):
        """(mean loss, mean psnr, GT | pred | depth of the first image)
        over the val split, rendered with the training config (the
        parameters' storage, which a graph step trains in place)."""
        from ..utils.visualization import visualize_depth
        h = self.hparams
        n = len(self.val_dataset)
        if max_images is not None:
            n = min(n, max_images)
        losses, psnrs = [], []
        first_viz = None
        for i in range(n):
            sample = self.val_dataset[i]
            rgbs = sample["rgbs"]
            res = render_chunked(
                self.params, sample["rays"], sample["ts"], self.cfg,
                chunk=val_chunk_cap(h.chunk, self.cfg.N_samples,
                                    self.cfg.N_importance),
                test_time=False, epoch=float(epoch),
                generator=self._generator(1000 + i),
                keys=("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine",
                      "beta", "transient_sigmas"), device=self.device,
                mesh=self.mesh)
            typ = "fine" if "rgb_fine" in res else "coarse"
            loss_d = loss_dict[self.loss_name](
                {k: torch.from_numpy(v) for k, v in res.items()},
                torch.from_numpy(rgbs))
            losses.append(float(sum(v for v in loss_d.values())))
            mse = np.mean((res[f"rgb_{typ}"] - rgbs) ** 2)
            psnrs.append(-10.0 * np.log10(mse))
            if i == 0:
                W, H = (int(x) for x in sample["img_wh"]) \
                    if "img_wh" in sample else h.img_wh
                img = res[f"rgb_{typ}"].reshape(H, W, 3).transpose(2, 0, 1)
                gt = rgbs.reshape(H, W, 3).transpose(2, 0, 1)
                depth = visualize_depth(res[f"depth_{typ}"].reshape(H, W))
                first_viz = np.stack([gt, np.clip(img, 0, 1), depth])
        return float(np.mean(losses)), float(np.mean(psnrs)), first_viz

    # -- the loop ------------------------------------------------------
    def _profiler(self):
        """(before(), after(n_real)) around each step call: a torch.profiler
        window over steps +100 to +120 of this run, written as a Chrome
        trace into --profile_dir.  On the card the window also keeps the
        fused kernels' runs in it as the kernels count them
        (``fused_mlp.kernel_runs``), beside which the trace's count of them
        can be held.  The profiler keeps a quiet margin of
        ``PROFILE_MARGIN_S`` on each side of the window's work, outside its
        timed seconds."""
        from ..ops import fused_mlp as fm
        prof_dir = getattr(self.hparams, "profile_dir", None) \
            if self.is_main else None
        start, stop = self.global_step + 100, self.global_step + 120
        st = {"prof": None, "done": not prof_dir}
        cuda = self.device.type == "cuda"

        def before():
            if st["done"] or st["prof"] is not None \
                    or self.global_step < start:
                return
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                st["runs"] = fm.kernel_runs(self.device)   # synchronizes
            st["prof"] = torch.profiler.profile(activities=acts)
            st["prof"].__enter__()
            time.sleep(PROFILE_MARGIN_S)
            st["t0"], st["step0"] = time.perf_counter(), self.global_step

        def after(n_real):
            if st["prof"] is None or self.global_step < stop:
                return
            if cuda:
                torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - st["t0"]
            time.sleep(PROFILE_MARGIN_S)
            st["prof"].__exit__(None, None, None)
            os.makedirs(prof_dir, exist_ok=True)
            path = os.path.join(prof_dir, "trace.json")
            st["prof"].export_chrome_trace(path)
            self.profile_window = {
                "trace": path, "seconds": seconds,
                "steps": self.global_step + n_real - st["step0"]}
            if cuda:
                self.profile_window["fused_runs"] = tuple(
                    b - a for a, b in zip(st["runs"],
                                          fm.kernel_runs(self.device)))
            st["prof"], st["done"] = None, True
            print(f"[profiler] trace of {self.profile_window['steps']} steps "
                  f"({seconds:.4f} s) written to {path}")

        return before, after

    def _mip_lr(self) -> float:
        """``--lr_scheduler mip`` at the global step: mip-NeRF's decay from
        --lr to --lr / 100 over the run's steps, behind its 2,500-step
        delay (``optimizers.mip_lr``)."""
        from .optimizers import mip_lr
        total = max(1, self.hparams.num_epochs
                    * max(1, self.batcher.steps_per_epoch()))
        return mip_lr(self.global_step, lr_init=self.hparams.lr,
                      lr_final=self.hparams.lr / 100, max_steps=total)

    def _frac_anneal(self) -> bool:
        return self.cfg.refine_pose and self.cfg.barf_schedule == "paper"

    def _steps(self, epoch: int, lr, feed_box):
        """Yield (a call of the step, sub-steps it runs) for each step call
        of an epoch; a call whose first step is step i of the epoch trains
        at epoch ``epoch + i / steps_per_epoch`` under BARF's paper
        schedule, else at ``epoch``.  ``lr``: a float, or a function read
        at each call (``--lr_scheduler mip``)."""
        h = self.hparams
        at = lr if callable(lr) else (lambda: lr)
        spe, B = self.spe, h.batch_size
        gen = self.generator
        n_epoch = max(1, self.batcher.steps_per_epoch())
        frac = self._frac_anneal()

        def ep(i):
            return epoch + i / n_epoch if frac else float(epoch)

        if self.device_pool is not None:
            pool, n_pool = self.device_pool
            n_steps = self.batcher.steps_per_epoch()
            self._perm.copy_(torch.from_numpy(epoch_perm(
                getattr(h, "seed", 0), epoch, n_pool, self._perm.numel())))
            for i in range(0, n_steps, spe):
                if spe > 1:
                    yield (lambda i=i: self.train_step(
                        self.params, pool, self._perm, i, n_steps, at(),
                        ep(i), gen)), min(spe, n_steps - i)
                else:
                    yield (lambda i=i: self.train_step(
                        self.params, pool, self._perm, i, at(), ep(i),
                        gen)), 1
            return
        if spe > 1:
            def grouped(it=self.batcher.epoch(epoch)):
                buf = []
                for b in it:
                    buf.append({k: torch.from_numpy(v) for k, v in b.items()})
                    if len(buf) == spe:
                        yield buf
                        buf = []
                if buf:
                    yield buf

            def put(bs):
                stacked, valid = stack_batches(bs, spe)
                return stacked, valid, len(bs)

            feed_box.append(DevicePrefetcher(grouped(), put,
                                             device=self.device))
            for j, (stacked, valid, n_real) in enumerate(feed_box[-1]):
                yield (lambda s=stacked, v=valid, e=ep(j * spe):
                       self.train_step(self.params, s, at(), e, gen, v)), \
                    n_real
            return
        feed_box.append(DevicePrefetcher(self.batcher.epoch(epoch),
                                         device=self.device))
        for j, batch in enumerate(feed_box[-1]):
            yield (lambda b=batch, e=ep(j): self.train_step(
                self.params, b, at(), e, gen)), 1

    def fit(self):
        from . import checkpoints
        from .logging import ExperimentLogger
        from .optimizers import lr_for_epoch
        from ..parallel import whole_params
        from .logging import NullLogger
        h = self.hparams
        if self.logger is None:
            self.logger = ExperimentLogger("logs", h.exp_name) \
                if self.is_main else NullLogger()
        ckpt_dir = os.path.join(h.save_path, h.exp_name)
        if getattr(h, "num_sanity_val_steps", 1) > 0:
            with span("nerf.fit.validation"):
                self.run_validation(self.start_epoch, max_images=1)
        prof_before, prof_after = self._profiler()
        log_every = getattr(h, "log_every", 50)
        refresh = getattr(h, "refresh_every", 0) or 0
        last = (None, {})
        for epoch in range(self.start_epoch, h.num_epochs):
            if h.lr_scheduler == "mip":
                # mip-NeRF's schedule by the step, read at each call
                lr = self._mip_lr
            else:
                lr = lr_for_epoch(h, epoch)
            t0, n_rays, steps0 = time.time(), 0, self.global_step
            feeds = []
            try:
                for call, n_real in self._steps(epoch, lr, feeds):
                    prof_before()
                    metrics = call()
                    prof_after(n_real)
                    n_rays += h.batch_size * n_real
                    # with K sub-steps a call, log when the window
                    # [global_step, global_step + n_real) holds a multiple
                    g = self.global_step
                    if (g % log_every == 0
                            or g % log_every + n_real > log_every):
                        with span("nerf.fit.log_read"):
                            m = {k: float(v.reshape(-1)[n_real - 1])
                                 for k, v in metrics.items()}
                        m["lr"] = lr() if callable(lr) else lr
                        dt = time.time() - t0
                        if dt > 0:
                            m["train/rays_per_sec"] = n_rays / dt
                        self.logger.scalars(m, g + n_real - 1)
                        last = (g + n_real - 1, m)
                    if refresh > 0 and (g % refresh == 0
                                        or g % refresh + n_real > refresh):
                        dt = time.time() - t0
                        tail = ""
                        if last[0] is not None:
                            m = last[1]
                            tail = (f" loss={m['train/loss']:.4f} "
                                    f"psnr={m['train/psnr']:.2f} "
                                    f"(step {last[0]})")
                        print(f"epoch {epoch} step {g} "
                              f"{n_rays / dt if dt > 0 else 0.0:,.0f} "
                              f"rays/s{tail}",
                              end="\r" if sys.stdout.isatty() else "\n",
                              flush=True)
                    self.global_step += n_real
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            finally:
                for feed in feeds:
                    feed.close()
            seconds = time.time() - t0
            t1 = time.time()
            # the epoch's annealing state at its end: the continuous paper
            # ramp has reached epoch + 1, the fork rule holds epoch
            with span("nerf.fit.validation"):
                val_loss, val_psnr, viz = self.run_validation(
                    epoch + 1 if self._frac_anneal() else epoch)
            self.logger.scalars({"val/loss": val_loss, "val/psnr": val_psnr},
                                self.global_step)
            if viz is not None:
                self.logger.images("val/GT_pred_depth", viz, self.global_step)
            print(f"epoch {epoch}: lr={lr() if callable(lr) else lr:.3e} "
                  f"val/loss={val_loss:.4f} "
                  f"val/psnr={val_psnr:.2f}")
            with span("nerf.fit.checkpoint"), whole_params(
                    self.mesh, self.params, self.optimizer,
                    self._model_parallel()):
                if self.is_main:
                    checkpoints.save_checkpoint(
                        os.path.join(ckpt_dir, f"epoch={epoch}.ckpt"),
                        self.params, self.optimizer, epoch=epoch,
                        global_step=self.global_step)
            self.epoch_stats.append({
                "epoch": epoch, "steps": self.global_step - steps0,
                "seconds": seconds, "rays_per_sec": n_rays / seconds,
                "val_psnr": val_psnr, "val_and_ckpt_seconds":
                    time.time() - t1})
        self.logger.close()


def gauge_val_psnr(system: NeRFSystem, epoch: int, max_images: int = 2,
                   gauge=None):
    """Val PSNR with a global SE(3) gauge ``T`` (refined frame -> true
    frame) removed before rendering: each val camera becomes ``inv(T) @
    c2w``.  Returns (mean val PSNR, T).  ``gauge`` None estimates ``T``
    from the learned poses against ``system.true_poses``
    (``gauge_transform``, Procrustes over the camera centers).  Where
    refinement left per-camera noise rather than a coherent drift, that
    fit moves the val cameras away from the scene and the score falls
    below the raw one: read it as a drift diagnostic."""
    from ..data.rays_np import get_rays
    from ..models.poses import all_poses, gauge_transform
    if gauge is None:
        with torch.no_grad():
            refined = all_poses(system.params["learn_poses"]).cpu().numpy()
        T = gauge_transform(refined, system.true_poses)
    else:
        T = np.asarray(gauge, np.float64)
    Tinv = np.linalg.inv(T)
    ds, h = system.val_dataset, system.hparams
    psnrs = []
    for i in range(min(len(ds), max_images)):
        sample = ds[i]
        c2w = np.eye(4)
        c2w[:3, :4] = np.asarray(sample["c2w"], np.float64)
        cc = (Tinv @ c2w)[:3, :4].astype(np.float32)
        rays_o, rays_d = get_rays(ds.directions, cc)
        n_px = len(rays_o)
        rays = np.concatenate([
            rays_o, rays_d, np.full((n_px, 1), ds.near, np.float32),
            np.full((n_px, 1), ds.far, np.float32)], 1)
        res = render_chunked(
            system.params, rays, sample["ts"], system.cfg,
            chunk=val_chunk_cap(h.chunk, system.cfg.N_samples,
                                system.cfg.N_importance),
            test_time=False, epoch=float(epoch),
            generator=system._generator(1000 + i),
            keys=("rgb_coarse", "rgb_fine"), device=system.device,
            mesh=system.mesh)
        typ = "fine" if "rgb_fine" in res else "coarse"
        mse = np.mean((res[f"rgb_{typ}"] - sample["rgbs"]) ** 2)
        psnrs.append(-10.0 * np.log10(mse))
    return float(np.mean(psnrs)), T
