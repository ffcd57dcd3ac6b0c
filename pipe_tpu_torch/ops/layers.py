"""Transformer building blocks as ``nn.Module``s.

Counterpart of ``pipe_tpu/ops/layers.py``. Weights live in the modules; every
constructor takes an explicit ``device`` (default ``cuda``) and draws its
initial weights from an explicit ``torch.Generator`` with the same
distributions as ``pipe_tpu``. Every layer's ``forward`` takes the stage
context as ``ctx=`` (its seed drives dropout in training).

Weights keep the dtype they were built in (float32 by default) and are cast
at use to the dtype of the activations they meet: a model built for bfloat16
compute holds float32 weights and computes in bfloat16, as ``pipe_tpu`` casts
its float32 params to the compute dtype at use.

Attention runs the hand-written flash kernels (``ops/flash_attention.py``:
forward, dQ and dK/dV, with attention dropout inside) or the plain
einsum-softmax path, chosen by ``impl``. The projections and the feed-forward
stay ``torch`` matmuls. Cached decoding (``decode``, ``make_cache``) is plain
einsum-softmax over the whole KV cache, as in ``pipe_tpu``; its position is a
host integer for the whole batch or an int64 tensor with one per row.
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
from .flash_attention import (_DTYPE_CODES, MAX_HEAD_DIM, flash_attention,
                              supports)

__all__ = [
    "Sequential", "Lambda", "Linear", "Embedding", "LayerNorm", "Dropout",
    "MultiHeadAttention", "TransformerEncoderLayer", "PreLNBlock",
    "PositionalEncoding", "Decoder", "dot_product_attention", "supports",
    "flash_auto_ok", "causal_table",
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
    ``[in, out]``); weights and bias uniform in ``±1/sqrt(in)``, cast to
    ``x``'s dtype at use."""

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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


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
    """Layer norm over the last dim: biased variance, eps 1e-5; gain and
    bias cast to ``x``'s dtype at use."""

    def __init__(self, features: int, eps: float = 1e-5, *,
                 dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=dtype, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype, device=dev))

    def forward(self, x, ctx: StageCtx = StageCtx()):
        return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


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


def flash_auto_ok(s: int, device: torch.device,
                  dtype: torch.dtype = torch.float32,
                  head_dim: int = MAX_HEAD_DIM) -> bool:
    """Whether ``impl="auto"`` picks the flash kernel: on a CUDA device,
    whenever the kernel takes the sequence length, the dtype (float32 or
    bfloat16) and the head dim (up to ``MAX_HEAD_DIM``); plain attention
    otherwise. Where plain attention is faster on the H100 is not measured
    yet (ROADMAP.md); the v5e crossover of ``pipe_tpu`` does not carry
    over."""
    return (torch.device(device).type == "cuda" and supports(s)
            and dtype in _DTYPE_CODES and head_dim <= MAX_HEAD_DIM)


def _flash_route(impl: str, s: int, device: torch.device,
                 dropout_active: bool, dtype: torch.dtype = torch.float32,
                 head_dim: int = MAX_HEAD_DIM) -> bool:
    """Whether :class:`MultiHeadAttention` calls ``flash_attention``. On the
    card, active dropout does not change the choice: the kernels drop
    attention weights themselves. On the CPU, active dropout takes the plain
    path, as it does in the Pallas module's interpret mode. ``impl="flash"``
    takes the kernel whenever it takes ``s`` (and raises on the card for a
    dtype or head dim it cannot take); ``auto`` falls back to plain
    attention there."""
    if impl == "xla" or (dropout_active and device.type != "cuda"):
        return False
    if impl == "flash":
        return supports(s)
    return flash_auto_ok(s, device, dtype, head_dim)


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
        if _flash_route(self.impl, s, x.device, dropout_active, q.dtype, hd):
            o = flash_attention(
                q, k, v, causal=self.causal,
                dropout_rate=self.dropout if dropout_active else 0.0,
                dropout_seed=dk if dropout_active else None)
        else:
            o = dot_product_attention(q, k, v, causal=self.causal,
                                      dropout_rate=self.dropout,
                                      dropout_seed=dk, train=ctx.train)
        return self.wo(o.reshape(b, s, self.d_model))

    def make_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """Zeroed KV cache for incremental decoding: ``{"k", "v"}`` of
        ``[batch, max_len, nhead, head_dim]`` on the weights' device, in
        ``dtype`` (default: the weights' dtype; callers that compute in
        another dtype pass it)."""
        w = next(self.parameters())
        shape = (batch, max_len, self.nhead, self.head_dim)
        dt = w.dtype if dtype is None else dtype
        return {"k": torch.zeros(shape, dtype=dt, device=w.device),
                "v": torch.zeros(shape, dtype=dt, device=w.device)}

    def decode(self, x, cache: dict, pos, tree=None, *,
               allowed: Optional[torch.Tensor] = None):
        """Incremental self-attention with a KV cache (inference only).

        ``x``: the new tokens' hidden states ``[b, q, d]`` at positions
        ``[pos, pos + q)`` (``q = 1`` per decode step, the prompt at prefill
        with ``pos = 0``); ``cache``: :meth:`make_cache`'s dict. Writes the
        new K/V rows at ``pos`` in place and attends each query over the
        whole cache with the rows after its own position masked to -1e30,
        which is the causal mask of ``forward`` restricted to the live
        prefix. Returns ``(out [b, q, d], cache)``.

        ``pos`` is a host integer for every row, or an int64 tensor ``[b]``
        with one per row (the serve engine's slots, whose positions differ
        and live on the device). A host-integer write past the cache raises
        ``ValueError``. The tensor form reads no value back to the host: it
        clamps each row's first written row to ``[0, max_len - q]``, as
        ``pipe_tpu``'s ``dynamic_update_slice`` clamps, so a slot past its
        cache (a dead serve slot) writes its last rows and its queries see
        the clamped rows' mask.

        ``tree`` (optional ``[q, q]`` bool, host-integer ``pos`` only):
        speculative tree verification. The q rows are draft-tree nodes; K/V
        still land at rows ``[pos, pos + q)``, but query row j attends the
        rows before ``pos`` plus the chunk rows r where ``tree[j, r]``.
        ``allowed`` (optional bool) is the mask itself, precomputed by a
        caller that decodes many steps: ``[q, max_len]`` rows of
        :func:`causal_table` for a host-integer ``pos``, ``[b, q, max_len]``
        (the table's rows gathered per row) for the tensor form.
        """
        if not self.causal:
            raise ValueError("KV-cache decode requires causal attention")
        b, q, _ = x.shape
        h, hd = self.nhead, self.head_dim
        ck, cv = cache["k"], cache["v"]
        max_len = ck.shape[1]
        qh = self.wq(x).view(b, q, h, hd)
        kh = self.wk(x).view(b, q, h, hd).to(ck.dtype)
        vh = self.wv(x).view(b, q, h, hd).to(cv.dtype)
        if isinstance(pos, torch.Tensor):
            if tree is not None:
                raise ValueError("tree verification takes a host-integer pos")
            rows = (pos.clamp(0, max_len - q)[:, None]
                    + torch.arange(q, device=x.device))           # [b, q]
            slot = torch.arange(b, device=x.device)[:, None].expand(b, q)
            ck.index_put_((slot, rows), kh)
            cv.index_put_((slot, rows), vh)
            if allowed is None:
                allowed = causal_table(max_len, x.device)[rows]
            allowed = allowed[:, None]                      # [b, 1, q, max_len]
        else:
            if pos < 0 or pos + q > max_len:
                raise ValueError(
                    f"decode writes cache rows [{pos}, {pos + q}) of a cache "
                    f"of {max_len} rows")
            ck[:, pos:pos + q] = kh
            cv[:, pos:pos + q] = vh
            if tree is not None:
                tree = torch.as_tensor(tree, dtype=torch.bool, device=x.device)
                rel = torch.arange(max_len, device=x.device) - pos
                within = tree[:, rel.clamp(0, q - 1)]        # [q, max_len]
                allowed = (rel < 0) | ((rel < q) & within)
            elif allowed is None:
                allowed = causal_table(max_len, x.device)[pos:pos + q]
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, ck).to(torch.float32)
        logits = logits / math.sqrt(hd)
        logits = torch.where(allowed, logits, -1e30)
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", weights, cv).reshape(
            b, q, self.d_model)
        return self.wo(o), cache


def causal_table(max_len: int, device) -> torch.Tensor:
    """``[max_len, max_len]`` bool, row i true at keys ``<= i``: row slices
    ``[pos:pos + q]`` (or rows gathered by a position tensor) are
    :meth:`MultiHeadAttention.decode`'s causal mask."""
    return torch.ones((max_len, max_len), dtype=torch.bool,
                      device=device).tril_()


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

    def decode(self, x, cache: dict, pos, tree=None, *,
               allowed: Optional[torch.Tensor] = None):
        """Incremental :meth:`forward` (inference: no dropout), attention
        served from the KV cache (:meth:`MultiHeadAttention.decode`)."""
        a, cache = self.attn.decode(x, cache, pos, tree, allowed=allowed)
        x = self.ln1(x + a)
        h = self.ff2(self.act(self.ff1(x)))
        return self.ln2(x + h), cache


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

    def decode(self, x, cache: dict, pos, tree=None, *,
               allowed: Optional[torch.Tensor] = None):
        """Incremental :meth:`forward` (inference: no dropout), attention
        served from the KV cache (:meth:`MultiHeadAttention.decode`)."""
        a, cache = self.attn.decode(self.ln1(x), cache, pos, tree,
                                    allowed=allowed)
        x = x + a
        return x + self.ff2(self.act(self.ff1(self.ln2(x)))), cache


class PositionalEncoding(nn.Module):
    """Sinusoidal positions + dropout (the tutorial's table, built in numpy),
    batch-first ``[batch, seq, d]``. The table is held in ``dtype``; the
    output is cast to ``compute_dtype`` when one is given (the LM's embed
    stage: ``pipe_tpu``'s ``pre_fn`` adds float32 positions, then casts to
    the compute dtype)."""

    def __init__(self, d_model: int, dropout: float = 0.0,
                 max_len: int = 5000, *, dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.compute_dtype = compute_dtype
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
        y = self.drop(x + self.pe[:s], ctx=ctx)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class Decoder(nn.Module):
    """Final projection to vocab logits, in the projection's dtype (float32
    logits from bfloat16 hidden states, as ``pipe_tpu``'s ``post_fn``)."""

    def __init__(self, d_model: int, vocab: int, *, dtype=torch.float32,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Linear(d_model, vocab, dtype=dtype, device=device,
                           generator=generator)

    def forward(self, x, ctx: StageCtx = StageCtx()):
        return self.proj(x.to(self.proj.weight.dtype))
