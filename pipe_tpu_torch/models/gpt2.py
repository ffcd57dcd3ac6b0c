"""The GPT-2 model family, pipelined.

Counterpart of ``pipe_tpu/models/gpt2.py`` (BASELINE.json config #3: a
4-stage GPT-2-small, chunks=16, skip connection via ``@skippable``). Learned
token + position embeddings, pre-LN blocks with ``gelu_tanh`` (GPT-2's
``gelu_new``), a final LayerNorm and a vocab head. The head is untied from
the embedding table, as in ``pipe_tpu``: tied weights would be one parameter
owned by two pipeline stages, which ``Pipe`` refuses. So the published shape
(vocab 50,257, d_model 768, 12 layers) holds about 163.0M parameters, not
124M.

Two factorizations over the same modules:

* :func:`build_sequential`: the layer list for ``Pipe``. With
  ``embed_skip=True`` the embedding output is ``@skippable``-stashed at
  stage 0 and popped into the input of the head's LayerNorm: a cross-stage
  residual on the skip subsystem (the emulator's tracker, the table
  executors' skip lanes).
* :class:`PipelinedGPT2`: embed | ``n_layers / n_stages`` blocks per stage
  | head, for ``ScheduledPipeline`` and the generators.

Every constructor takes ``device=`` (the card by default) and a
``torch.Generator`` that draws the weights.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.partition import StageCtx
from ..extras.skip import pop, skippable, stash
from ..ops.layers import (Dropout, LayerNorm, Linear, PreLNBlock, Sequential,
                          _generator)
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .common import PipelinedTransformer, per_row_ce

__all__ = ["GPT2Config", "GPT2Embed", "GPT2Head", "build_sequential",
           "PipelinedGPT2"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2 small by default (12 layers, d=768, 12 heads)."""

    vocab: int = 50257
    d_model: int = 768
    nhead: int = 12
    d_ff: int = 3072               # 4 * d_model
    n_layers: int = 12
    dropout: float = 0.1
    seq_len: int = 1024
    compute_dtype: torch.dtype = torch.float32   # activations (weights: f32)
    attn_impl: str = "auto"                      # auto | xla | flash

    def tiny(self) -> "GPT2Config":
        return dataclasses.replace(
            self, vocab=101, d_model=16, nhead=2, d_ff=64, n_layers=4,
            seq_len=16, dropout=0.0)


class GPT2Embed(nn.Module):
    """Learned token + position embeddings (``wte`` N(0, 0.02²), ``wpe``
    N(0, 0.01²)) with embedding dropout; the output is in the compute
    dtype."""

    def __init__(self, cfg: GPT2Config, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        self.cfg = cfg
        self.drop = Dropout(cfg.dropout)
        wte = torch.empty((cfg.vocab, cfg.d_model), device=dev)
        wpe = torch.empty((cfg.seq_len, cfg.d_model), device=dev)
        self.wte = nn.Parameter(wte.normal_(0.0, 0.02, generator=gen))
        self.wpe = nn.Parameter(wpe.normal_(0.0, 0.01, generator=gen))

    def forward(self, tokens, ctx: StageCtx = StageCtx()):
        s = tokens.shape[-1]
        h = F.embedding(tokens, self.wte) + self.wpe[:s]
        return self.drop(h, ctx=ctx).to(self.cfg.compute_dtype)


class GPT2Head(nn.Module):
    """Final LayerNorm + (untied, bias-free) vocab projection, in the
    projection's dtype: float32 logits from bfloat16 hidden states, as
    ``pipe_tpu``'s head, and float64 ones from a float64 copy."""

    def __init__(self, cfg: GPT2Config, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.ln_f = LayerNorm(cfg.d_model, device=device)
        self.proj = Linear(cfg.d_model, cfg.vocab, use_bias=False,
                           device=device, generator=generator)

    def forward(self, h, ctx: StageCtx = StageCtx()):
        h = h.to(self.proj.weight.dtype)
        return self.proj(self.ln_f(h, ctx=ctx), ctx=ctx)


@skippable(stash=["gpt2_embed"])
class _StashEmbed(nn.Module):
    def forward(self, h, ctx: StageCtx = StageCtx()):
        stash("gpt2_embed", h)
        return h


@skippable(pop=["gpt2_embed"])
class _JoinEmbed(nn.Module):
    """Embedding shortcut: re-inject the stage-0 embedding right before the
    head."""

    def forward(self, h, ctx: StageCtx = StageCtx()):
        return h + pop("gpt2_embed").to(h.dtype)


def _block(cfg: GPT2Config, dev, gen) -> PreLNBlock:
    return PreLNBlock(cfg.d_model, cfg.nhead, cfg.d_ff, cfg.dropout,
                      causal=True, activation="gelu_tanh",
                      attn_impl=cfg.attn_impl, device=dev, generator=gen)


def build_sequential(cfg: GPT2Config, embed_skip: bool = False, *,
                     device=DEFAULT_DEVICE,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequential:
    """Embed (+ stash) + ``n_layers`` blocks (+ join) + head as one
    ``Sequential`` on ``device``, with float32 weights drawn from
    ``generator`` (a fresh one seeded 0 if None) in layer order."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    layers: List[nn.Module] = [GPT2Embed(cfg, device=dev, generator=gen)]
    if embed_skip:
        layers.append(_StashEmbed())
    layers += [_block(cfg, dev, gen) for _ in range(cfg.n_layers)]
    if embed_skip:
        layers.append(_JoinEmbed())
    layers.append(GPT2Head(cfg, device=dev, generator=gen))
    return Sequential(layers)


class PipelinedGPT2(PipelinedTransformer):
    """embed | ``n_layers / n_stages`` pre-LN blocks per stage | head, over
    the modules :func:`build_sequential` builds (the same weights from the
    same generator), with the in-pipeline loss :meth:`loss_post_fn`."""

    def __init__(self, cfg: GPT2Config, n_stages: int = 1, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        layers = list(build_sequential(cfg, device=device,
                                       generator=generator))
        super().__init__(cfg, n_stages, layers[0], layers[1:-1], layers[-1])

    def loss_post_fn(self, h, x_mb, ctx: StageCtx = StageCtx()):
        """Per-row mean token CE ``[mb_rows]`` of the head's float32 logits
        against ``x_mb["targets"]``: the in-pipeline loss contract."""
        return per_row_ce(self.head(h, ctx=ctx), x_mb["targets"])

    def embed_at(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """Embed tokens occupying positions ``[pos, pos + q)``, for
        incremental decoding (inference: no dropout). ``pos`` is a host
        integer (a window past ``wpe`` raises ``ValueError``; the generators
        guard it with :meth:`max_position`), or an int64 tensor ``[b]`` with
        one per row of ``tokens [b, q]`` (the serve engine's slots), clamped
        to ``[0, seq_len - q]`` as ``pipe_tpu``'s ``dynamic_slice_in_dim``
        clamps."""
        q = tokens.shape[-1]
        wpe = self.embed.wpe
        if isinstance(pos, torch.Tensor):
            rows = (pos.clamp(0, wpe.shape[0] - q)[:, None]
                    + torch.arange(q, device=pos.device))
            pe = wpe[rows]                                  # [b, q, d]
        elif not 0 <= pos <= wpe.shape[0] - q:
            raise ValueError(f"positions [{pos}, {pos + q}) are outside the "
                             f"positional table ({wpe.shape[0]} rows)")
        else:
            pe = wpe[pos:pos + q]
        h = F.embedding(tokens, self.embed.wte) + pe
        return h.to(self.cfg.compute_dtype)

    def max_position(self) -> int:
        """Positional capacity (``wpe`` rows): the inference guard."""
        return self.cfg.seq_len
