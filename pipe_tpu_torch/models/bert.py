"""The BERT model family, pipelined.

Counterpart of ``pipe_tpu/models/bert.py`` (BASELINE.json config #4:
8-stage BERT-large pretraining, chunks=32, interleaved 1F1B). Word + learned
position embeddings, LayerNorm and dropout; post-LN bidirectional blocks
(the tutorial's :class:`~pipe_tpu_torch.ops.layers.TransformerEncoderLayer`
with ``causal=False`` and exact-erf GELU); a masked-LM head (dense, GELU,
LayerNorm, vocab projection). Pretraining is masked-LM only, as in
``pipe_tpu`` (no next-sentence head). The vocab projection is untied from
the word table, so the published shape (vocab 30,522, d_model 1,024, 24
layers) holds about 0.37B parameters.

The in-pipeline loss: ``x_mb = {"tokens": masked ids, "targets": original
ids, "mlm_weights": [rows, seq], 1.0 at the masked positions}``, a per-row
masked mean of the token cross-entropy, so only the selected ~15% count.
:func:`mask_tokens` draws the 80/10/10 corruption from an explicit
``torch.Generator``.

:func:`build_sequential` is the layer list for ``Pipe``;
:class:`PipelinedBERT` is embed | ``n_layers / n_virtual`` blocks per
virtual stage | head over the same modules, for ``ScheduledPipeline`` (24
layers over 8 stages x interleave 3 is config #4's composition). Every
constructor takes ``device=`` (the card by default) and a ``torch.Generator``
that draws the weights.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.partition import StageCtx
from ..ops.layers import (Dropout, LayerNorm, Linear, Sequential,
                          TransformerEncoderLayer, _generator)
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .common import PipelinedTransformer, per_row_ce

__all__ = ["BertConfig", "mask_tokens", "BertEmbed", "MLMHead",
           "build_sequential", "PipelinedBERT"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-large by default (24 layers, d=1024, 16 heads)."""

    vocab: int = 30522
    d_model: int = 1024
    nhead: int = 16
    d_ff: int = 4096
    n_layers: int = 24
    dropout: float = 0.1
    seq_len: int = 512
    mask_token_id: int = 103       # [MASK] in the WordPiece vocab
    compute_dtype: torch.dtype = torch.float32   # activations (weights: f32)
    attn_impl: str = "auto"                      # auto | xla | flash

    def tiny(self) -> "BertConfig":
        return dataclasses.replace(
            self, vocab=101, d_model=16, nhead=2, d_ff=64, n_layers=4,
            seq_len=16, dropout=0.0, mask_token_id=1)


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor,
                cfg: BertConfig, mask_rate: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT's 80/10/10 corruption: ``(masked_tokens, mlm_weights)``.

    Of the positions selected at ``mask_rate``, 80% become ``[MASK]``, 10% a
    random id and 10% stay; ``mlm_weights`` (float32) is 1.0 exactly at the
    selected positions. Three draws from ``generator``, on its device (the
    tokens' device)."""
    dev = tokens.device
    selected = torch.rand(tokens.shape, generator=generator,
                          device=dev) < mask_rate
    roll = torch.rand(tokens.shape, generator=generator, device=dev)
    random_ids = torch.randint(0, cfg.vocab, tokens.shape,
                               generator=generator, device=dev,
                               dtype=tokens.dtype)
    corrupted = torch.where(
        roll < 0.8, torch.full_like(tokens, cfg.mask_token_id),
        torch.where(roll < 0.9, random_ids, tokens))
    masked = torch.where(selected, corrupted, tokens)
    return masked, selected.to(torch.float32)


class BertEmbed(nn.Module):
    """Word + learned position embeddings (both N(0, 0.02²)), LayerNorm,
    dropout; the output is in the compute dtype."""

    def __init__(self, cfg: BertConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        self.cfg = cfg
        word = torch.empty((cfg.vocab, cfg.d_model), device=dev)
        pos = torch.empty((cfg.seq_len, cfg.d_model), device=dev)
        self.word = nn.Parameter(word.normal_(0.0, 0.02, generator=gen))
        self.pos = nn.Parameter(pos.normal_(0.0, 0.02, generator=gen))
        self.ln = LayerNorm(cfg.d_model, device=dev)
        self.drop = Dropout(cfg.dropout)

    def forward(self, tokens, ctx: StageCtx = StageCtx()):
        s = tokens.shape[-1]
        h = self.ln(F.embedding(tokens, self.word) + self.pos[:s], ctx=ctx)
        return self.drop(h, ctx=ctx).to(self.cfg.compute_dtype)


class MLMHead(nn.Module):
    """Dense + exact-erf GELU + LayerNorm, then the vocab projection, in
    the projection's dtype (float32 logits from bfloat16 hidden states, as
    ``pipe_tpu``'s head)."""

    def __init__(self, cfg: BertConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        self.cfg = cfg
        self.dense = Linear(cfg.d_model, cfg.d_model, device=dev,
                            generator=gen)
        self.ln = LayerNorm(cfg.d_model, device=dev)
        self.proj = Linear(cfg.d_model, cfg.vocab, device=dev, generator=gen)

    def forward(self, h, ctx: StageCtx = StageCtx()):
        h = h.to(self.proj.weight.dtype)
        h = F.gelu(self.dense(h, ctx=ctx), approximate="none")
        return self.proj(self.ln(h, ctx=ctx), ctx=ctx)


def _block(cfg: BertConfig, dev, gen) -> TransformerEncoderLayer:
    return TransformerEncoderLayer(
        cfg.d_model, cfg.nhead, cfg.d_ff, cfg.dropout, causal=False,
        activation="gelu", attn_impl=cfg.attn_impl, device=dev,
        generator=gen)


def build_sequential(cfg: BertConfig, *, device=DEFAULT_DEVICE,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequential:
    """Embed + ``n_layers`` blocks + MLM head as one ``Sequential`` on
    ``device``, with float32 weights drawn from ``generator`` (a fresh one
    seeded 0 if None) in layer order."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    layers: List[nn.Module] = [BertEmbed(cfg, device=dev, generator=gen)]
    layers += [_block(cfg, dev, gen) for _ in range(cfg.n_layers)]
    layers.append(MLMHead(cfg, device=dev, generator=gen))
    return Sequential(layers)


class PipelinedBERT(PipelinedTransformer):
    """embed | ``n_layers / n_virtual`` blocks per virtual stage | MLM head,
    over the modules :func:`build_sequential` builds (the same weights from
    the same generator), with the masked-mean loss :meth:`loss_post_fn`.
    Pass ``n_virtual = n_stages * interleave`` for an interleaved table."""

    def __init__(self, cfg: BertConfig, n_virtual: int = 1, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        layers = list(build_sequential(cfg, device=device,
                                       generator=generator))
        super().__init__(cfg, n_virtual, layers[0], layers[1:-1], layers[-1])

    def loss_post_fn(self, h, x_mb, ctx: StageCtx = StageCtx()):
        """Per-row masked mean of the MLM cross-entropy ``[mb_rows]``: the
        head's float32 logits against ``x_mb["targets"]``, weighted by
        ``x_mb["mlm_weights"]``."""
        return per_row_ce(self.head(h, ctx=ctx), x_mb["targets"],
                          weights=x_mb["mlm_weights"])
