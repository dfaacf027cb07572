"""Semantics of ``nerf_fl_tpu/ops/sorting.py`` in torch idiom.

The JAX versions avoid sort and gather because both lower badly on the TPU;
on the GPU a stable sort and ``torch.gather`` are the direct way.
"""
from __future__ import annotations

from typing import Optional

import torch


def rank_merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge per-row sorted a (N, A) and b (N, B) into sorted (N, A+B);
    on ties a's elements come first (stable sort of the concatenation)."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True).values


def sorted_uniform(shape, *, generator: Optional[torch.Generator] = None,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """Per-row SORTED Uniform(0, 1) order statistics via normalized
    cumulative exponential spacings (no sort)."""
    *batch, n = shape
    e = torch.empty((*batch, n + 1), device=device, dtype=dtype)
    e.exponential_(generator=generator)
    s = torch.cumsum(e, dim=-1)
    return s[..., :-1] / s[..., -1:]
