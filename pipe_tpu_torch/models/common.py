"""Shared pieces of the model families.

Counterpart of ``pipe_tpu/models/common.py``: the per-row cross-entropy that
the trainer's loss is built from. The stage-stacked ``PipelinedTransformer``
scaffolding is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["per_row_ce"]


def per_row_ce(logits: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row cross-entropy from logits (float32 accumulation, float64 for
    float64 logits).

    ``logits``: ``[rows, ..., vocab]``; ``targets``: integer ``[rows, ...]``.
    Without ``weights`` returns the mean CE over every non-row axis (or the
    bare CE when targets are scalar per row); with ``weights`` (same shape as
    targets) returns the weighted mean ``sum(w*ce)/max(sum(w), 1)``. Always
    ``[rows]``, float32 unless the logits are float64.
    """
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = logz - gold
    reduce_dims = tuple(range(1, ce.dim()))
    if weights is not None:
        w = weights.float()
        if not reduce_dims:
            return ce * w / torch.clamp(w, min=1.0)
        return (torch.sum(ce * w, dim=reduce_dims)
                / torch.clamp(torch.sum(w, dim=reduce_dims), min=1.0))
    if reduce_dims:
        return torch.mean(ce, dim=reduce_dims)
    return ce
