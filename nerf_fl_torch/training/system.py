"""Model assembly, the train step and chunked rendering.

Counterpart of ``nerf_fl_tpu/training/system.py``: ``build_params``,
the train step on world-space rays (``make_train_step``, with
``microbatch`` and ``steps_per_execution``, and ``stack_batches``), the
device-resident ray pool (``epoch_perm``, ``make_device_pool_step``),
``val_chunk_cap``, ``render_chunked`` and ``render_chunked_async``.  Single
device; the mesh and multihost branches and camera-frame rays belong to
later slices.

``steps_per_execution`` K > 1 is JAX's ``lax.scan`` of K steps in one
dispatch.  On the card its counterpart is a CUDA graph of one sub-step
(batch in, render, loss, backward, Adam, metrics out), captured once and
replayed for each sub-step, so a replay costs about its device time and no
host dispatch (``_StepGraph``).  On the CPU the same sub-step runs eagerly
K times: the plain version the graph is held to.  JAX's ``fold_in_range``
(one stacked PRNG key a sub-step) has no counterpart: the port draws from
a ``torch.Generator``, whose Philox offset advances with each sub-step in
a replay exactly as in an eager step, so K sub-steps draw what K eager
steps draw.  The card's PyTorch lets a graph register a generator
(``CUDAGraph.register_generator_state``), so any CUDA generator, or the
device's default one (None), may drive the draws.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import init_embedding, init_nerf
from ..render import RenderConfig, render_rays
from .losses import loss_dict
from .optimizers import named_leaves, set_lr


def build_params(cfg: RenderConfig, n_vocab: int, *,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Dict[str, Any]:
    """{'nerf_coarse', ['nerf_fine'], ['embedding_a'], ['embedding_t']}.

    Everything is drawn on ``generator``'s device (the CPU with torch's
    default generator if None) and then moved to ``device``; a CPU
    generator gives the same weights on every device.  ``device`` None
    means CUDA, and raises where there is none.  The embedding tables are
    ``nn.Parameter``s, trained with the fields.
    """
    dev = resolve_device(device)
    draw = generator.device if generator is not None else None
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
    return {k: v.to(dev) if isinstance(v, torch.nn.Module)
            else torch.nn.Parameter(v.to(dev)) for k, v in params.items()}


def make_train_step(cfg: RenderConfig, optimizer: torch.optim.Optimizer, *,
                    loss_name: str = "nerfw", microbatch: int = 1,
                    steps_per_execution: int = 1) -> Callable:
    """The train step: render -> loss -> backward -> optimizer step ->
    metrics.  Returns ``step(params, batch, lr, epoch=0.0,
    generator=None)``, which updates the parameters that ``optimizer``
    holds (the trainable ones, ``optimizers.make_trainable_mask``) in place
    and returns the metrics as device scalars: ``train/loss``,
    ``train/psnr`` (from the fine rgb, the coarse one without a fine
    model) and one ``train/<term>`` per loss term.

    ``batch`` is {'rays' (B, 8), 'ts' (B,), 'rgbs' (B, 3)} on the params'
    device.  With ``microbatch`` M > 1 the gradient is the mean of the
    gradients of M equal slices, each with its own loss (so NeRF-W's
    log(mean beta) term is per slice), and one optimizer step is taken, as
    the JAX package's step does.  ``generator`` drives the stochastic draws
    (perturb, noise_std); on the card it is a CUDA generator.

    With ``steps_per_execution`` K > 1 it returns ``multi(params, batches,
    lr, epoch=0.0, generator=None, valid=None)`` instead, which runs K steps
    of ``stack_batches``'s stacked ``batches`` ({'rays' (K, B, 8), ...}) at
    one lr and returns the metrics with a leading K axis, as device tensors
    and without a host sync.  ``valid`` (a numpy bool (K,), None for all)
    must be a prefix: the sub-steps it marks False are not run, leave the
    parameters and the optimizer state untouched, and read NaN in the
    metrics.  On the card the sub-steps replay a CUDA graph (``_StepGraph``;
    ``multi.graph`` counts its captures) or the call raises: it never runs
    them eagerly instead.  The optimizer must then be capturable
    (``optimizers.build_optimizer``'s adam on the card): sgd on the card
    raises as not ported yet, as BARF (``cfg.refine_pose``) does anywhere.
    """
    body = _train_body(cfg, optimizer, loss_name, microbatch)

    def step(params, batch, lr, epoch=0.0, generator=None):
        set_lr(optimizer, lr)
        return body(params, batch, epoch, generator)

    K = steps_per_execution
    if K <= 1:
        return step
    graph = _StepGraph(body, optimizer, cfg, K)

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
        return graph.run(params, lr, epoch, generator, _valid_count(valid, K),
                         shapes, lambda st, fresh: feed(st, batches, fresh),
                         load)

    multi.graph = graph
    return multi


def _train_body(cfg: RenderConfig, optimizer: torch.optim.Optimizer,
                loss_name: str, microbatch: int) -> Callable:
    """``body(params, batch, epoch, generator)``: one train step at the lr
    the optimizer holds (``make_train_step``'s step, ``set_lr`` aside)."""
    loss_fn = loss_dict[loss_name]
    typ = "fine" if cfg.N_importance > 0 else "coarse"
    params_held = [p for group in optimizer.param_groups
                   for p in group["params"]]

    def loss_of(params, b, epoch, generator):
        results = render_rays(params, b["rays"], b["ts"], cfg,
                              generator=generator, epoch=epoch)
        loss_d = loss_fn(results, b["rgbs"])
        mse = torch.mean((results[f"rgb_{typ}"] - b["rgbs"]) ** 2)
        return sum(loss_d.values()), loss_d, mse

    def body(params, batch, epoch, generator):
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
        optimizer.step()
        metrics = {"train/loss": loss, "train/psnr": -10.0 * torch.log10(mse)}
        for k, v in loss_d.items():
            metrics[f"train/{k}"] = v
        return metrics

    return body


def stack_batches(batches, k: Optional[int] = None):
    """Stack a list of batch dicts of tensors leaf-wise into one
    {'rays' (K, B, 8), ...} dict on the batches' device, for a
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
    captured as a CUDA graph and replayed, on the CPU run eagerly.

    A sub-step loads its batch through a device counter ``k`` (the
    sub-step's index in the call), runs ``body`` (zero_grad, render, loss,
    backward, optimizer step), writes its metrics into row ``k`` of a (K,
    metrics) buffer and advances ``k``, all on the device, so a replay
    needs no host write.  The graph reads fixed addresses: the call's
    inputs are copied into static buffers (``feed``), the parameters and
    the optimizer state are updated in place, the lr is the optimizer's
    device tensor (``set_lr``, outside the graph), and the grads live in
    the graph's memory pool from its capture on, where each replay's
    backward writes them and its optimizer step reads them.  The graph is
    captured again only when the call's key changes: the batch shapes, the
    generator, the addresses of the parameters and of whatever ``feed``
    does not copy.

    Capture follows PyTorch's recipe: one eager sub-step on a side stream
    first (it initializes Adam's state, caches and libraries), then the
    capture on that stream.  The eager sub-step is the call's first one,
    so no step is taken that the caller did not ask for; if the capture
    then fails, the call raises after that first sub-step.  ``captures``
    counts the captures; ``fused_launches`` holds the fused forward and
    backward launches that one sub-step made while it was captured.
    """

    def __init__(self, body, optimizer: torch.optim.Optimizer,
                 cfg: RenderConfig, k: int):
        self.body, self.optimizer, self.K = body, optimizer, k
        self.held = [p for g in optimizer.param_groups for p in g["params"]]
        self.device = self.held[0].device
        if cfg.refine_pose:         # BARF reads the epoch, which a graph bakes
            raise NotImplementedError("steps_per_execution > 1 with "
                                      "refine_pose is not ported yet")
        if self.device.type == "cuda":
            if not all(g.get("capturable") and torch.is_tensor(g["lr"])
                       for g in optimizer.param_groups):
                raise NotImplementedError(
                    f"steps_per_execution > 1 on the card with "
                    f"{type(optimizer).__name__} (not capturable with a "
                    f"device lr) is not ported yet")
        self.key = self.graph = None
        self.names = self.out = None
        self.statics: Dict[str, Any] = {}
        self.k = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.captures = 0
        self.fused_launches = None

    def sub_step(self, params, epoch, generator, load):
        with _fresh_leaves(params, self.held) as fresh:
            m = self.body(fresh, load(self.statics, self.k), epoch,
                          generator)
        if self.out is None:
            self.names = list(m)
            self.out = torch.full((self.K, len(m)), float("nan"),
                                  device=self.device)
        self.out.index_copy_(0, self.k,
                             torch.stack([m[n] for n in self.names])[None])
        self.k.add_(1)

    def run(self, params, lr, epoch, generator, n_valid: int, key, feed,
            load) -> Dict[str, torch.Tensor]:
        key = (key, generator,
               tuple(p.data_ptr() for _, p in named_leaves(params)))
        fresh = key != self.key
        if fresh:
            self.key = self.graph = None       # frees the old graph's pool
        set_lr(self.optimizer, lr)
        feed(self.statics, fresh)
        self.k.zero_()
        if self.out is not None:
            self.out.fill_(float("nan"))
        first = 0
        if self.device.type != "cuda":
            for _ in range(n_valid):
                self.sub_step(params, epoch, generator, load)
        else:
            if fresh:
                self._capture(params, epoch, generator, load)
                first = 1
            for _ in range(first, n_valid):
                self.graph.replay()
        self.key = key
        res = self.out.clone()
        return {n: res[:, j] for j, n in enumerate(self.names)}

    def _capture(self, params, epoch, generator, load):
        from ..ops import fused_mlp as fm
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.sub_step(params, epoch, generator, load)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = (fm.fused_mlp_fwd_cuda.launches,
                  fm.fused_mlp_bwd_cuda.launches)
        # torch.cuda.graph's set-up (no pending work, no cached blocks that
        # the capture could free), but capture_begin / capture_end by hand:
        # torch.cuda.graph leaves the side stream current when a failed
        # capture makes capture_end raise
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                self.sub_step(params, epoch, generator, load)
            finally:
                graph.capture_end()
        self.fused_launches = (fm.fused_mlp_fwd_cuda.launches - before[0],
                               fm.fused_mlp_bwd_cuda.launches - before[1])
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = graph
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
                          steps_per_execution: int = 1) -> Callable:
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
    new epoch's ``perm``) captures the step again.
    """
    if steps_per_execution <= 1:
        step = make_train_step(cfg, optimizer, loss_name=loss_name,
                               microbatch=microbatch)
        B = batch_size

        def run(params, pool, perm, i, lr, epoch=0.0, generator=None):
            idx = perm[i * B:(i + 1) * B].long()
            batch = {k: v.index_select(0, idx) for k, v in pool.items()}
            return step(params, batch, lr, epoch, generator)

        return run

    K, B = steps_per_execution, batch_size
    graph = _StepGraph(_train_body(cfg, optimizer, loss_name, microbatch),
                       optimizer, cfg, K)

    def feed(statics, pool, perm, i0, fresh):
        if fresh:
            statics["i0"] = torch.zeros(1, dtype=torch.int64,
                                        device=graph.device)
            statics["rows"] = torch.arange(B, device=graph.device)
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
        key = (B,) + tuple((k, tuple(v.shape), v.dtype, v.data_ptr())
                           for k, v in sorted(pool.items())) \
            + (tuple(perm.shape), perm.dtype, perm.data_ptr())
        return graph.run(params, lr, epoch, generator, n_valid, key,
                         lambda st, fresh: feed(st, pool, perm, i0, fresh),
                         load)

    run.graph = graph
    return run


def params_device(params: Dict[str, Any]) -> torch.device:
    m = params["nerf_coarse"]
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
                   device=None) -> Dict[str, np.ndarray]:
    """Render arbitrarily many rays in fixed-size chunks; returns numpy
    arrays.  The tail chunk is padded by repeating its last ray and trimmed
    after, so every chunk has the same shape.  ``keys`` restricts the
    returned (and copied back) outputs.  ``device`` None means CUDA; the
    params must live on the device."""
    return render_chunked_async(
        params, rays, ts, cfg, chunk=chunk, test_time=test_time,
        output_transient=output_transient, epoch=epoch, generator=generator,
        keys=keys, inflight=inflight, a_override=a_override, device=device)()


def render_chunked_async(params, rays, ts, cfg: RenderConfig, *,
                         chunk: int = 32 * 1024, test_time: bool = True,
                         output_transient: bool = True, epoch: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         keys=None, inflight: int = 4, a_override=None,
                         device=None):
    """Dispatch a full render and defer the final readback.

    Every chunk is enqueued before return; at most ``inflight`` chunks'
    results wait on the device before the oldest is copied back.  Returns a
    ``finish()`` callable producing render_chunked's result dict.
    """
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
    outs = defaultdict(list)
    pending: deque = deque()

    def drain_one():
        res, keep = pending.popleft()
        for k, v in res.items():
            outs[k].append(v[:keep].float().cpu().numpy())

    with torch.no_grad():
        for i in range(0, n, chunk):
            r = rays[i:i + chunk]
            t = ts[i:i + chunk]
            keep = len(r)
            pad = chunk - keep
            if pad > 0:
                r = torch.cat([r, r[-1:].expand(pad, -1)], 0)
                t = torch.cat([t, t[-1:].expand(pad)], 0)
            r = r.to(dev, non_blocking=True)
            t = t.to(dev, non_blocking=True)
            a_emb = None if a_override is None else \
                a_override.expand(chunk, a_override.shape[-1])
            res = render_rays(params, r, t, cfg, generator=generator,
                              epoch=epoch, test_time=test_time,
                              output_transient=output_transient,
                              a_embedded=a_emb)
            if keys is not None:
                res = {k: v for k, v in res.items() if k in keys}
            pending.append((res, keep))
            if len(pending) >= max(1, inflight):
                drain_one()

    def finish():
        while pending:
            drain_one()
        return {k: np.concatenate(v, 0) for k, v in outs.items()}

    return finish
