"""Shared pieces of the model families.

Counterpart of ``pipe_tpu/models/common.py``: the per-row cross-entropy that
the trainer's loss is built from, and :class:`PipelinedTransformer`, the
embed | k blocks per stage | head factorization that the generators run. Its
stage-stacked SPMD executor is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core.partition import StageCtx

__all__ = ["per_row_ce", "PipelinedTransformer"]


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


class PipelinedTransformer(nn.Module):
    """Base factorization: embed | ``layers_per_stage`` blocks per stage |
    head, holding the modules themselves (weights included).

    ``blocks`` is an ``nn.ModuleList`` of all ``n_layers`` blocks in layer
    order; stage ``s`` runs ``blocks[s * lps:(s + 1) * lps]``. ``head`` is
    the module registered under ``post_key``. Subclasses set ``post_key``
    and build the modules; ``input_key`` names the token leaf of a dict
    input.
    """

    input_key = "tokens"
    post_key = "head"

    def __init__(self, cfg, n_stages: int, embed: nn.Module,
                 blocks: Sequence[nn.Module], head: nn.Module):
        super().__init__()
        if n_stages < 1 or cfg.n_layers % n_stages:
            raise ValueError(
                f"n_layers={cfg.n_layers} must divide into "
                f"n_stages={n_stages} (use Pipe for uneven splits)")
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for a model of "
                             f"{cfg.n_layers} layers")
        self.cfg = cfg
        self.n_stages = n_stages
        self.layers_per_stage = cfg.n_layers // n_stages
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        # Registered under post_key (its state_dict prefix); add_module
        # would refuse the name "head", which the property below takes.
        self._modules[self.post_key] = head

    @property
    def head(self) -> nn.Module:
        return self._modules[self.post_key]

    def stage_blocks(self, s: int) -> nn.ModuleList:
        lps = self.layers_per_stage
        return self.blocks[s * lps:(s + 1) * lps]

    def pre_fn(self, x_mb, ctx: StageCtx = StageCtx()):
        leaf = x_mb[self.input_key] if isinstance(x_mb, dict) else x_mb
        return self.embed(leaf, ctx=ctx)

    def stage_fn(self, s: int, h, ctx: StageCtx = StageCtx()):
        """Stage ``s``'s blocks on ``h`` (``pipe_tpu`` passes the stage's
        params; here the stage index names the modules that hold them)."""
        for l, block in enumerate(self.stage_blocks(s)):
            h = block(h, ctx=ctx.fold(l))
        return h

    def post_fn(self, h, ctx: StageCtx = StageCtx()):
        return self.head(h, ctx=ctx)
