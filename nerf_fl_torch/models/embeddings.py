"""Per-image appearance / transient embedding tables, (N_vocab, dim) tensors.

Counterpart of ``nerf_fl_tpu/models/embeddings.py``.
"""
from __future__ import annotations

from typing import Optional

import torch


def init_embedding(n_vocab: int, dim: int, *,
                   generator: Optional[torch.Generator] = None,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """torch ``nn.Embedding`` default init: N(0, 1)."""
    return torch.randn((n_vocab, dim), generator=generator, device=device,
                       dtype=dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, D) table gathered at integer ids (...,) -> (..., D)."""
    return table[ids.long()]


def validate_vocab(n_vocab: int, max_id: int, what: str = "ts") -> None:
    """Startup guard against image ids outside the table."""
    if max_id >= n_vocab:
        raise ValueError(
            f"--N_vocab={n_vocab} is too small: max {what} id in the dataset is "
            f"{max_id}. Increase --N_vocab to at least {max_id + 1}.")
