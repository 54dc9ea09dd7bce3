"""Tensor helpers shared by the models and the ops' plain versions."""

from __future__ import annotations

import functools

import torch


def top_k_stable(x, k, dim=-1):
    """``lax.top_k``: the k largest along ``dim``, ties toward the lower
    index (a stable descending sort; ``torch.topk`` promises no tie order,
    and bf16 RPN scores tie often)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def gather_rows(x, idx):
    """x (..., R, K), idx (..., D) -> (..., D, K)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


@functools.lru_cache(maxsize=32)
def constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small float32 tensor on ``device``, uploaded once: an upload on
    every step would make the host wait for the device mid-step. Callers
    must not modify it."""
    return torch.tensor(values, dtype=torch.float32, device=device)
