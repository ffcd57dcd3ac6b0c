"""Transformer building blocks as ``nn.Module``s.

Counterpart of ``pipe_tpu/ops/layers.py``. Weights live in the modules; every
constructor takes an explicit ``device`` (default ``cuda``) and draws its
initial weights from an explicit ``torch.Generator`` with the same
distributions as ``pipe_tpu``. Every layer's ``forward`` takes the stage
context as ``ctx=`` (its seed drives dropout in training).

Attention runs the hand-written flash kernels (``ops/flash_attention.py``:
forward, dQ and dK/dV, with attention dropout inside) or the plain
einsum-softmax path, chosen by ``impl``. The projections and the feed-forward
stay ``torch`` matmuls.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.partition import StageCtx
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .flash_attention import flash_attention, supports

__all__ = [
    "Sequential", "Lambda", "Linear", "Embedding", "LayerNorm", "Dropout",
    "MultiHeadAttention", "TransformerEncoderLayer", "PreLNBlock",
    "PositionalEncoding", "Decoder", "dot_product_attention", "supports",
    "flash_auto_ok",
]


def _generator(generator: Optional[torch.Generator],
               device: torch.device) -> torch.Generator:
    """The caller's generator, or a fresh one seeded 0 on ``device``."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device} cannot initialise "
                         f"weights on {device}")
    return generator


def _uniform(shape, bound: float, dtype, device, generator) -> nn.Parameter:
    w = torch.empty(shape, dtype=dtype, device=device)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


class Lambda(nn.Module):
    """Wrap a parameterless function as a layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs, ctx: StageCtx = StageCtx()):
        return self.fn(*inputs)


class Sequential(nn.Module):
    """Ordered composition, the module ``Pipe`` takes. Slicing returns a
    ``Sequential`` over the same layer objects (and so the same weights)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(list(self.layers)[idx])
        return self.layers[idx]

    def forward(self, *inputs, ctx: StageCtx = StageCtx()):
        out = inputs
        for i, layer in enumerate(self.layers):
            r = layer(*out, ctx=ctx.fold(i))
            out = r if isinstance(r, tuple) else (r,)
        return out if len(out) > 1 else out[0]


class Linear(nn.Module):
    """``y = x W^T + b`` with ``weight [out, in]`` (``pipe_tpu`` keeps
    ``[in, out]``); weights and bias uniform in ``±1/sqrt(in)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, dtype=torch.float32, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        bound = 1.0 / math.sqrt(in_features)
        self.in_features = in_features
        self.features = features
        self.weight = _uniform((features, in_features), bound, dtype, dev, gen)
        self.bias = (_uniform((features,), bound, dtype, dev, gen)
                     if use_bias else None)

    def forward(self, x, ctx: StageCtx = StageCtx()):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Token embedding, N(0, 1) table, with the tutorial's sqrt(d_model)
    scaling."""

    def __init__(self, vocab: int, features: int, scale: bool = True, *,
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        self.vocab = vocab
        self.features = features
        self.scale = scale
        w = torch.empty((vocab, features), dtype=dtype, device=dev)
        w.normal_(generator=gen)
        self.weight = nn.Parameter(w)

    def forward(self, tokens, ctx: StageCtx = StageCtx()):
        y = F.embedding(tokens, self.weight)
        if self.scale:
            y = y * math.sqrt(self.features)
        return y


class LayerNorm(nn.Module):
    """Layer norm over the last dim: biased variance, eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5, *,
                 dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=dtype, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype, device=dev))

    def forward(self, x, ctx: StageCtx = StageCtx()):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def _dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Inverted dropout driven by the ctx seed: a recomputed forward gets the
    same seed and so the same mask. Off in eval and without a seed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, ctx: StageCtx = StageCtx()):
        if not ctx.train or self.rate <= 0.0 or ctx.seed is None:
            return x
        return _dropout(x, self.rate, ctx.seed)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None,
                          train: bool = False):
    """Softmax attention with float32 logits (float64 for float64 inputs)
    over ``[b, s, h, d]``: the plain path (``impl="xla"``), and the path
    under attention-weight dropout."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logits = logits / math.sqrt(d)
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((qlen, klen), dtype=torch.bool,
                                     device=q.device))
        logits = logits.masked_fill(~mask, -1e30)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if train and dropout_rate > 0.0 and dropout_seed is not None:
        weights = _dropout(weights, dropout_rate, dropout_seed)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_auto_ok(s: int, device: torch.device) -> bool:
    """Whether ``impl="auto"`` picks the flash kernel: on a CUDA device,
    whenever the kernel takes ``s``. Where plain attention is faster on the
    H100 is not measured yet (ROADMAP.md); the v5e crossover of ``pipe_tpu``
    does not carry over."""
    return torch.device(device).type == "cuda" and supports(s)


def _flash_route(impl: str, s: int, device: torch.device,
                 dropout_active: bool) -> bool:
    """Whether :class:`MultiHeadAttention` calls ``flash_attention``. On the
    card, active dropout does not change the choice: the kernels drop
    attention weights themselves. On the CPU, active dropout takes the plain
    path, as it does in the Pallas module's interpret mode."""
    if impl == "xla" or (dropout_active and device.type != "cuda"):
        return False
    if impl == "flash":
        return supports(s)
    return flash_auto_ok(s, device)


class MultiHeadAttention(nn.Module):
    """Self-attention over ``[batch, seq, d_model]``; heads are contiguous
    slices of the projections' outputs. ``impl``: ``flash`` (the kernel where
    it takes the shape), ``xla`` (plain einsum softmax) or ``auto``
    (:func:`flash_auto_ok`). Attention-weight dropout in training runs inside
    the kernels on the card, seeded by ``ctx.fold(1).seed``, and takes the
    plain path on the CPU."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 causal: bool = True, *, impl: str = "auto",
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % nhead:
            raise ValueError("nhead must divide d_model")
        if impl not in ("auto", "xla", "flash"):
            raise ValueError(f"impl must be auto|xla|flash, got {impl!r}")
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        self.d_model = d_model
        self.nhead = nhead
        self.head_dim = d_model // nhead
        self.dropout = dropout
        self.causal = causal
        self.impl = impl
        # Weights uniform in ±1/sqrt(d_model), biases zero, as pipe_tpu.
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.wq = Linear(d_model, d_model, **kw)
        self.wk = Linear(d_model, d_model, **kw)
        self.wv = Linear(d_model, d_model, **kw)
        self.wo = Linear(d_model, d_model, **kw)
        with torch.no_grad():
            for lin in (self.wq, self.wk, self.wv, self.wo):
                lin.bias.zero_()

    def forward(self, x, ctx: StageCtx = StageCtx()):
        b, s, _ = x.shape
        h, hd = self.nhead, self.head_dim
        q = self.wq(x).view(b, s, h, hd)
        k = self.wk(x).view(b, s, h, hd)
        v = self.wv(x).view(b, s, h, hd)
        dk = ctx.fold(1).seed if ctx.seed is not None else None
        dropout_active = self.dropout > 0.0 and ctx.train and dk is not None
        if _flash_route(self.impl, s, x.device, dropout_active):
            o = flash_attention(
                q, k, v, causal=self.causal,
                dropout_rate=self.dropout if dropout_active else 0.0,
                dropout_seed=dk if dropout_active else None)
        else:
            o = dot_product_attention(q, k, v, causal=self.causal,
                                      dropout_rate=self.dropout,
                                      dropout_seed=dk, train=ctx.train)
        return self.wo(o.reshape(b, s, self.d_model))


# "gelu" is the exact erf form (torch.nn.TransformerEncoderLayer's
# activation='gelu', BERT, ViT); "gelu_tanh" is the tanh approximation
# (GPT-2's gelu_new). Models pick the variant their reference uses.
_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


class _TransformerBlockBase(nn.Module):
    """Shared structure of the two block families (attn + FFN + 2 LN +
    dropout); subclasses supply ``forward`` (LN placement)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.0, causal: bool = True, *,
                 attn_impl: str = "auto", activation: str = "relu",
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)}, "
                f"got {activation!r}")
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        kw = dict(dtype=dtype, device=dev)
        self.attn = MultiHeadAttention(d_model, nhead, dropout, causal,
                                       impl=attn_impl, generator=gen, **kw)
        self.ff1 = Linear(d_model, dim_feedforward, generator=gen, **kw)
        self.ff2 = Linear(dim_feedforward, d_model, generator=gen, **kw)
        self.ln1 = LayerNorm(d_model, **kw)
        self.ln2 = LayerNorm(d_model, **kw)
        self.drop = Dropout(dropout)
        self.act = _ACTIVATIONS[activation]


class TransformerEncoderLayer(_TransformerBlockBase):
    """Post-LN block, the semantics of torch's default
    ``nn.TransformerEncoderLayer``: self-attn, add & norm, FFN, add & norm,
    dropout on each residual branch."""

    def forward(self, x, ctx: StageCtx = StageCtx()):
        a = self.attn(x, ctx=ctx.fold(0))
        a = self.drop(a, ctx=ctx.fold(1))
        x = self.ln1(x + a)
        h = self.act(self.ff1(x))
        h = self.drop(h, ctx=ctx.fold(2))
        h = self.ff2(h)
        h = self.drop(h, ctx=ctx.fold(3))
        return self.ln2(x + h)


class PreLNBlock(_TransformerBlockBase):
    """Pre-LN block (GPT-2 / ViT lineage): x + attn(ln1(x)), then
    x + ffn(ln2(x)), GELU by default."""

    def __init__(self, *args, activation: str = "gelu", **kwargs):
        super().__init__(*args, activation=activation, **kwargs)

    def forward(self, x, ctx: StageCtx = StageCtx()):
        a = self.attn(self.ln1(x), ctx=ctx.fold(0))
        x = x + self.drop(a, ctx=ctx.fold(1))
        h = self.act(self.ff1(self.ln2(x)))
        h = self.ff2(h)
        return x + self.drop(h, ctx=ctx.fold(2))


class PositionalEncoding(nn.Module):
    """Sinusoidal positions + dropout (the tutorial's table, built in numpy),
    batch-first ``[batch, seq, d]``."""

    def __init__(self, d_model: int, dropout: float = 0.0,
                 max_len: int = 5000, *, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.drop = Dropout(dropout)
        position = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
        pe = np.zeros((max_len, d_model), np.float32)
        pe[:, 0::2] = np.sin(position * div)
        pe[:, 1::2] = np.cos(position * div)
        self.register_buffer("pe", torch.as_tensor(pe, dtype=dtype, device=dev),
                             persistent=False)

    def forward(self, x, ctx: StageCtx = StageCtx()):
        s = x.shape[-2]
        return self.drop(x + self.pe[:s], ctx=ctx)


class Decoder(nn.Module):
    """Final projection to vocab logits."""

    def __init__(self, d_model: int, vocab: int, *, dtype=torch.float32,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Linear(d_model, vocab, dtype=dtype, device=device,
                           generator=generator)

    def forward(self, x, ctx: StageCtx = StageCtx()):
        return self.proj(x)
