"""Model assembly and chunked rendering: the eval entry points.

Counterpart of the render half of ``nerf_fl_tpu/training/system.py``
(``build_params``, ``val_chunk_cap``, ``render_chunked``,
``render_chunked_async``).  Single device; the mesh and multihost branches
belong to a later slice.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import init_embedding, init_nerf
from ..render import RenderConfig, render_rays


def build_params(cfg: RenderConfig, n_vocab: int, *,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Dict[str, Any]:
    """{'nerf_coarse', ['nerf_fine'], ['embedding_a'], ['embedding_t']}.

    Everything is drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; torch's default one if None) and then moved to
    ``device``, so a seed gives the same weights on every device.
    ``device`` None means CUDA, and raises where there is none.
    """
    dev = resolve_device(device)
    params: Dict[str, Any] = {
        "nerf_coarse": init_nerf(cfg.nerf_config("coarse"),
                                 generator=generator)}
    if cfg.N_importance > 0:
        params["nerf_fine"] = init_nerf(cfg.nerf_config("fine"),
                                        generator=generator)
    if cfg.encode_a:
        params["embedding_a"] = init_embedding(n_vocab, cfg.N_a,
                                               generator=generator)
    if cfg.encode_t:
        params["embedding_t"] = init_embedding(n_vocab, cfg.N_tau,
                                               generator=generator)
    return {k: v.to(dev) for k, v in params.items()}


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
