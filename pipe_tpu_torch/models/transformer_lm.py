"""The tutorial Transformer LM as a ``Sequential`` for ``Pipe``.

Counterpart of the ``Sequential`` path of ``pipe_tpu/models/transformer_lm.py``:
Encoder (embedding + positional encoding), N x ``TransformerEncoderLayer``,
Decoder (projection to vocab); emsize 2048, nhid 2048, nlayers 16, nhead 32,
dropout 0.2, bptt 128, batch-first. The stage-stacked ``PipelinedLM`` (SPMD
path) is not ported yet; :func:`pipelined_lm_balance` gives its cut as a
``Pipe`` balance over this ``Sequential``, which is how the trainer runs it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..ops.layers import (Decoder, Embedding, PositionalEncoding, Sequential,
                          TransformerEncoderLayer)
from ..utils.platform import DEFAULT_DEVICE, resolve_device

__all__ = ["LMConfig", "build_sequential", "cross_entropy",
           "pipelined_lm_balance"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Tutorial hyperparameters."""

    vocab: int = 28782          # WikiText-2 vocab size ballpark
    d_model: int = 2048         # emsize
    nhead: int = 32
    d_ff: int = 2048            # nhid
    n_layers: int = 16
    dropout: float = 0.2
    seq_len: int = 128          # bptt
    causal: bool = True
    compute_dtype: torch.dtype = torch.float32   # weights and activations
    attn_impl: str = "auto"                      # auto | xla | flash
    # Vocab block of pipe_tpu's streaming cross-entropy (ops/losses.py);
    # None is the dense decoder + per_row_ce path, the only one ported.
    loss_block: Optional[int] = None

    def __post_init__(self):
        if self.loss_block is not None:
            raise NotImplementedError(
                "LMConfig.loss_block (streaming cross-entropy, ops/losses.py) "
                "is not ported to pipe_tpu_torch yet (ROADMAP.md, queue A)")

    def tiny(self) -> "LMConfig":
        return dataclasses.replace(
            self, vocab=101, d_model=16, nhead=2, d_ff=32, n_layers=4,
            seq_len=16, dropout=0.0)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, float32 accumulation."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def pipelined_lm_balance(n_layers: int, n_stages: int) -> List[int]:
    """``PipelinedLM``'s cut as a ``Pipe`` balance over :func:`build_sequential`:
    embedding and positional encoding plus ``n_layers / n_stages`` blocks on
    stage 0, that many blocks on each middle stage, and that many plus the
    decoder on the last. One stage holds all ``n_layers + 3`` layers."""
    if n_stages <= 0 or n_layers % n_stages:
        raise ValueError(
            f"n_layers={n_layers} must divide into n_stages={n_stages} "
            f"(use Pipe for uneven splits)")
    per = n_layers // n_stages
    balance = [per] * n_stages
    balance[0] += 2
    balance[-1] += 1
    return balance


def build_sequential(cfg: LMConfig, *, device=DEFAULT_DEVICE,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequential:
    """Encoder + N blocks + Decoder as one ``Sequential`` on ``device``, with
    weights drawn from ``generator`` (a fresh one seeded 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(dtype=cfg.compute_dtype, device=dev)
    layers = [
        Embedding(cfg.vocab, cfg.d_model, scale=True, generator=generator,
                  **kw),
        PositionalEncoding(cfg.d_model, cfg.dropout,
                           max_len=max(5000, cfg.seq_len), **kw),
    ]
    for _ in range(cfg.n_layers):
        layers.append(TransformerEncoderLayer(
            cfg.d_model, cfg.nhead, cfg.d_ff, cfg.dropout, causal=cfg.causal,
            attn_impl=cfg.attn_impl, generator=generator, **kw))
    layers.append(Decoder(cfg.d_model, cfg.vocab, generator=generator, **kw))
    return Sequential(layers)
