"""Model assembly, the train step and chunked rendering.

Counterpart of ``nerf_fl_tpu/training/system.py``: ``build_params``,
the train step on world-space rays (``make_train_step``, with
``microbatch``), the device-resident ray pool
(``epoch_perm``, ``make_device_pool_step``), ``val_chunk_cap``,
``render_chunked`` and ``render_chunked_async``.  Single device; the mesh
and multihost branches, ``steps_per_execution`` and camera-frame rays
belong to later slices.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import init_embedding, init_nerf
from ..render import RenderConfig, render_rays
from .losses import loss_dict
from .optimizers import set_lr


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
                    loss_name: str = "nerfw", microbatch: int = 1) -> Callable:
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
    """
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

    def step(params, batch, lr, epoch=0.0, generator=None):
        set_lr(optimizer, lr)
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

    return step


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
                          microbatch: int = 1) -> Callable:
    """Train step that draws its batch from a device-resident pool.

    Returns ``run(params, pool, perm, i, lr, epoch=0.0, generator=None)``:
    ``pool`` is {'rays', 'ts', 'rgbs'} over the whole dataset on the
    device, ``perm`` the epoch's ``epoch_perm`` as a device tensor, and
    step ``i`` of the epoch trains on rows ``perm[i*B:(i+1)*B]``, gathered
    on the device (no host work per step).
    """
    step = make_train_step(cfg, optimizer, loss_name=loss_name,
                           microbatch=microbatch)
    B = batch_size

    def run(params, pool, perm, i, lr, epoch=0.0, generator=None):
        idx = perm[i * B:(i + 1) * B].long()
        batch = {k: v.index_select(0, idx) for k, v in pool.items()}
        return step(params, batch, lr, epoch, generator)

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
