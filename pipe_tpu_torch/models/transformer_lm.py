"""The tutorial Transformer LM as a ``Sequential`` for ``Pipe``.

Counterpart of the ``Sequential`` path of ``pipe_tpu/models/transformer_lm.py``:
Encoder (embedding + positional encoding), N x ``TransformerEncoderLayer``,
Decoder (projection to vocab); emsize 2048, nhid 2048, nlayers 16, nhead 32,
dropout 0.2, bptt 128, batch-first. :class:`PipelinedLM` is the
embed | blocks | decoder factorization that the generators and the table
executor (``parallel/scheduled.py``) run, with the in-pipeline loss
:meth:`PipelinedLM.loss_post_fn`; its stage-stacked SPMD executor is not
ported yet. :func:`pipelined_lm_balance` gives its cut as a ``Pipe`` balance
over this ``Sequential``, which is how the trainer runs GPipe.

Mixed precision as in ``pipe_tpu``: the weights live in float32 whatever
``compute_dtype`` is; the embedding stage casts its output to the compute
dtype, the blocks cast their weights to it at use, and the decoder computes
float32 logits with its float32 weights. ``pipe_tpu``'s own
``build_sequential`` ignores ``compute_dtype``; here the ``Sequential`` is
also what the trainer runs in place of ``PipelinedLM``, so it follows
``PipelinedLM``'s casts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core.partition import StageCtx
from ..ops.layers import (Decoder, Embedding, PositionalEncoding, Sequential,
                          TransformerEncoderLayer)
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .common import PipelinedTransformer, per_row_ce

__all__ = ["LMConfig", "build_sequential", "cross_entropy",
           "pipelined_lm_balance", "PipelinedLM"]


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
    compute_dtype: torch.dtype = torch.float32   # activations (weights: f32)
    attn_impl: str = "auto"                      # auto | xla | flash
    # Vocab block of the streaming cross-entropy (ops/losses.py) that
    # loss_post_fn fuses the decoder into; None is the dense decoder +
    # per_row_ce path.
    loss_block: Optional[int] = None

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
    float32 weights drawn from ``generator`` (a fresh one seeded 0 if None);
    activations after the positional encoding are in ``cfg.compute_dtype``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev)
    layers = [
        Embedding(cfg.vocab, cfg.d_model, scale=True, generator=generator,
                  **kw),
        PositionalEncoding(cfg.d_model, cfg.dropout,
                           max_len=max(5000, cfg.seq_len),
                           compute_dtype=cfg.compute_dtype, **kw),
    ]
    for _ in range(cfg.n_layers):
        layers.append(TransformerEncoderLayer(
            cfg.d_model, cfg.nhead, cfg.d_ff, cfg.dropout, causal=cfg.causal,
            attn_impl=cfg.attn_impl, generator=generator, **kw))
    layers.append(Decoder(cfg.d_model, cfg.vocab, generator=generator, **kw))
    return Sequential(layers)


class PipelinedLM(PipelinedTransformer):
    """The tutorial LM as embed (embedding + positions) | ``n_layers``
    blocks | decoder, with ``layers_per_stage`` blocks per stage.

    Built as :func:`build_sequential` builds it (same weights from the same
    generator). Counterpart of ``pipe_tpu``'s ``PipelinedLM``; its
    stage-stacked executor is not ported yet.
    """

    post_key = "decoder"

    def __init__(self, cfg: LMConfig, n_stages: int = 1, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self._assemble(cfg, n_stages,
                       build_sequential(cfg, device=device,
                                        generator=generator))

    @classmethod
    def from_sequential(cls, cfg: LMConfig, seq: Sequential,
                        n_stages: int = 1) -> "PipelinedLM":
        """Wrap the module objects of a :func:`build_sequential`
        ``Sequential`` (or of a ``Pipe``'s layers), with no copy: a model
        that a ``Pipe`` or ``Trainer`` trained generates directly, and later
        training shows through. A port-only constructor: ``pipe_tpu`` keeps
        weights in param trees that both paths read, while here the weights
        live in the modules, so sharing the modules is what shares them."""
        model = cls.__new__(cls)
        model._assemble(cfg, n_stages, seq)
        return model

    def _assemble(self, cfg: LMConfig, n_stages: int, seq) -> None:
        layers = list(seq)
        kinds = ((Embedding, PositionalEncoding)
                 + (TransformerEncoderLayer,) * cfg.n_layers + (Decoder,))
        if len(layers) != len(kinds) or not all(
                isinstance(m, k) for m, k in zip(layers, kinds)):
            raise ValueError(
                f"not the tutorial LM of {cfg.n_layers} layers: embedding, "
                f"positions, {cfg.n_layers} TransformerEncoderLayers, decoder")
        PipelinedTransformer.__init__(self, cfg, n_stages, layers[0],
                                      layers[2:-1], layers[-1])
        self.posenc = layers[1]

    def pre_fn(self, x_mb, ctx: StageCtx = StageCtx()):
        tokens = x_mb[self.input_key] if isinstance(x_mb, dict) else x_mb
        h = self.embed(tokens, ctx=ctx)
        h = self.posenc(h, ctx=ctx.fold(1))
        return h.to(self.cfg.compute_dtype)

    def embed_at(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """Embed tokens at positions ``[pos, pos + q)``: ``pre_fn`` with a
        position offset, for incremental decoding (no dropout). ``pos`` is a
        host integer, or an int64 tensor ``[b]`` with one per row of
        ``tokens [b, q]``, clamped to the table as ``pipe_tpu``'s
        ``dynamic_slice`` clamps (a gather that reads nothing back)."""
        h = self.embed(tokens)
        q = tokens.shape[-1]
        pe = self.posenc.pe
        if isinstance(pos, torch.Tensor):
            rows = (pos.clamp(0, pe.shape[0] - q)[:, None]
                    + torch.arange(q, device=pos.device))
            pe = pe[rows]                                   # [b, q, d]
        else:
            pe = pe[pos:pos + q]
        return (h + pe).to(self.cfg.compute_dtype)

    def embed_tree(self, tokens: torch.Tensor, pos,
                   depths: torch.Tensor) -> torch.Tensor:
        """Embed draft-tree rows: row r of ``tokens [b, Q]`` sits at
        position ``pos + depths[r]`` (:meth:`embed_at` with a per-row
        position gather). ``pos`` is a host integer, or an int64 tensor
        ``[b]`` with one per row (the serve engine's slots), whose gather
        is clamped to the table (it reads nothing back)."""
        h = self.embed(tokens)
        pe = self.posenc.pe
        depths = torch.as_tensor(depths, device=h.device)
        if isinstance(pos, torch.Tensor):
            rows = (pos[:, None] + depths).clamp(0, pe.shape[0] - 1)
            pe = pe[rows]                                   # [b, Q, d]
        else:
            pe = pe.index_select(0, pos + depths)
        return (h + pe).to(self.cfg.compute_dtype)

    def max_position(self) -> int:
        """Positional capacity (sinusoid table rows): the inference guard."""
        return int(self.posenc.pe.shape[0])

    def post_fn(self, h, ctx: StageCtx = StageCtx()):
        return self.decoder(h.to(torch.float32), ctx=ctx)

    def loss_post_fn(self, h, x_mb, ctx: StageCtx = StageCtx()):
        """In-pipeline loss: the per-row mean token cross-entropy
        ``[mb_rows]`` of the decoder's float32 logits against
        ``x_mb["targets"]``, computed on the last stage so the ``[batch,
        seq, vocab]`` logits of the whole batch are never gathered.

        With ``cfg.loss_block`` the decoder and the loss fuse into the
        vocab-streamed cross-entropy (``ops/losses.py``), so not even one
        micro-batch's ``[mb, seq, vocab]`` logits are held."""
        if self.cfg.loss_block:
            from ..ops.losses import streaming_xent
            proj = self.decoder.proj
            ce = streaming_xent(h, proj.weight.t(), proj.bias,
                                x_mb["targets"], int(self.cfg.loss_block))
            return ce.mean(dim=-1)
        logits = self.decoder(h.to(torch.float32), ctx=ctx)
        return per_row_ce(logits, x_mb["targets"])
