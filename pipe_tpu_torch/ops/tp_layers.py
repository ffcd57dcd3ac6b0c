"""Tensor-parallel transformer block (Megatron-style column/row sharding).

Counterpart of ``pipe_tpu/ops/tp_layers.py``. The block's parameters carry
per-leaf ``PartitionSpec``s over the mesh's ``model`` axis
(:func:`tp_block_specs`); a rank of a model line holds only its slice of the
sharded leaves, and the block body is written for local slices with exactly
TWO all-reduces over the model line per block (attention output projection
and FFN second matmul), the canonical column-then-row split:

* QKV projection: **column-parallel**, heads split over the model axis
  (``wqkv [d, 3, H, hd]`` sharded on the head dim), so each rank computes
  attention for its ``H / tp`` heads with no communication;
* attention output projection: **row-parallel**, local heads against the
  local slice of ``wo [H, hd, d]`` (sharded on dim 0), partial results
  summed over the model line;
* FFN: ``w1 [d, ff]`` column-sharded on dim 1, ``w2 [ff, d]`` row-sharded
  on dim 0, one all-reduce after ``w2``.

Biases on sharded dims (``bqkv``, ``b1``) are sharded with their weights;
output-side biases (``bo``, ``b2``) and the LayerNorm params are replicated
and applied after the all-reduce (once, not tp times).

Invariance: dropout acts only on REPLICATED activations (the two residual
dropouts, after the all-reduce), drawn from the same seed on every rank of a
model line and, on a data rank, for the whole micro-batch with its rows kept
(``StageCtx.rows``, ROADMAP.md C.16), so a tp=k step equals the
``tp_axis=None`` step of the same parameters up to reduction order.
Attention-probability dropout would act on head-sharded tensors, so this
block has none, as in ``pipe_tpu``.

Differentiation contract: :func:`tp_enter` (identity forward, all-reduce
backward) marks the entry into each parallel region and
:func:`tp_allreduce` (all-reduce forward, identity backward) its exit, so
every cotangent upstream of a block (LayerNorm params, the residual stream,
the previous stage, the embed) is identical across a model line, and the
executors never reduce a gradient over the model axis: sharded leaves'
gradients are local by construction, replicated leaves' are identical on
every rank of the line by these operators.

The functional forms take ``p``, the block's parameters as a nested dict of
tensors under ``pipe_tpu``'s leaf names (:meth:`TPBlock.tree`), and the
``mesh`` whose model line they all-reduce over (None: no all-reduce, the
``tp_axis=None`` math). The attention is einsums and a float32 softmax, as
in ``pipe_tpu``: this block launches no kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.partition import StageCtx, fold_seed
from ..parallel.mesh import MODEL_AXIS, PartitionSpec as P
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .layers import _dropout, causal_table

__all__ = ["TPBlock", "tp_block_apply", "tp_attention_decode",
           "tp_block_decode", "tp_block_specs", "tp_enter", "tp_allreduce",
           "tp_attention_sublayer", "tp_block_tapped", "tp_block_zs",
           "tp_block_wgrad", "TP_YS"]


def tp_block_specs() -> Dict[str, Any]:
    """Per-leaf ``PartitionSpec``s over the block's own dims (no stage dim):
    heads and ff sharded over ``model``, everything else replicated."""
    m = MODEL_AXIS
    return {
        "ln1": {"scale": P(), "bias": P()},
        "wqkv": P(None, None, m, None),
        "bqkv": P(None, m, None),
        "wo": P(m, None, None),
        "bo": P(),
        "ln2": {"scale": P(), "bias": P()},
        "w1": P(None, m),
        "b1": P(m),
        "w2": P(m, None),
        "b2": P(),
    }


def _line(mesh):
    """The mesh whose model line a block all-reduces over, or None (no
    mesh, no model axis, or a line of one)."""
    if mesh is None or getattr(mesh, "model_size", 1) == 1:
        return None
    return mesh


def _summed(t: torch.Tensor, mesh) -> torch.Tensor:
    out = t.detach().clone()
    mesh.all_reduce(out, MODEL_AXIS)
    return out


class _Enter(torch.autograd.Function):
    """Megatron's *f*: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, h, mesh):
        ctx.mesh = mesh
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh), None


class _AllReduce(torch.autograd.Function):
    """Megatron's *g*: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(h: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's *f* operator: identity forward, all-reduce over the model
    line backward. Applied to the PARALLEL-REGION inputs (the LayerNorm
    outputs feeding QKV and W1), not the block input: the residual stream
    stays outside the f ... all-reduce pair, or its (already replicated)
    cotangent would be counted tp times. Each rank's backward gives only its
    own heads' or features' share of ``d loss / d hn``; the all-reduce makes
    every cotangent upstream of it identical across the line."""
    mesh = _line(mesh)
    return h if mesh is None else _Enter.apply(h, mesh)


def tp_allreduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's *g* operator: the row-parallel sum over the model line
    forward, IDENTITY backward: the loss is symmetric across the line, the
    output cotangent is replicated, and each rank's ``d loss / d partial``
    is that cotangent unsummed (a summing backward would multiply every
    upstream gradient by tp)."""
    mesh = _line(mesh)
    return x if mesh is None else _AllReduce.apply(x, mesh)


def _layernorm(x, p, eps: float = 1e-5):
    """LayerNorm with population variance, ``pipe_tpu``'s ``_layernorm``."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _layernorm_tapped(x, p, eps: float = 1e-5):
    """LayerNorm returning its normalized input (the scale-grad tap)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return xhat * p["scale"] + p["bias"], xhat


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _seeds(ctx: StageCtx, dropout: float):
    """The two residual dropouts' seeds (attention, FFN), or Nones: off in
    eval, without a seed and at rate 0."""
    if not dropout or not ctx.train or ctx.seed is None:
        return None, None
    return fold_seed(ctx.seed, 0), fold_seed(ctx.seed, 1)


def _drop(x, rate: float, seed: Optional[int], rows):
    return x if seed is None else _dropout(x, rate, seed, rows)


def _attention(q, k, v, causal: bool, dtype):
    """Scores masked with -1e9, a float32 softmax: ``[rows, s, Hl, hd]``."""
    seq, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(hd)
    if causal:
        mask = causal_table(seq, q.device)
        scores = torch.where(mask, scores,
                             torch.tensor(-1e9, dtype=scores.dtype,
                                          device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def tp_attention_sublayer(p: Dict[str, Any], h: torch.Tensor, *,
                          causal: bool, dropout: float,
                          seed: Optional[int], rows=None,
                          mesh=None) -> torch.Tensor:
    """Pre-LN self-attention with column/row head sharding, with the
    residual add; ``seed``: the residual dropout's (None: none)."""
    hn = tp_enter(_layernorm(h, p["ln1"]), mesh)
    qkv = (torch.einsum("bsd,dthk->btshk", hn, p["wqkv"])
           + p["bqkv"][:, None])
    attn = _attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal, h.dtype)
    out = tp_allreduce(torch.einsum("bshk,hkd->bsd", attn, p["wo"]),
                       mesh) + p["bo"]
    return h + _drop(out, dropout, seed, rows)


def tp_block_apply(p: Dict[str, Any], h: torch.Tensor,
                   ctx: StageCtx = StageCtx(), *, dropout: float = 0.0,
                   causal: bool = True, mesh=None) -> torch.Tensor:
    """Pre-LN transformer block on LOCAL parameter slices; ``h [rows, seq,
    d]`` is replicated over the model line. ``mesh=None`` runs the
    unsharded math on whole parameters."""
    s1, s2 = _seeds(ctx, dropout)
    h = tp_attention_sublayer(p, h, causal=causal, dropout=dropout, seed=s1,
                              rows=ctx.rows, mesh=mesh)
    hn2 = tp_enter(_layernorm(h, p["ln2"]), mesh)
    inner = _gelu(hn2 @ p["w1"] + p["b1"])            # [rows, seq, ff_local]
    ff = tp_allreduce(inner @ p["w2"], mesh) + p["b2"]
    return h + _drop(ff, dropout, s2, ctx.rows)


def tp_attention_decode(p: Dict[str, Any], h: torch.Tensor, cache: dict,
                        pos: int, *, mesh=None,
                        allowed: Optional[torch.Tensor] = None):
    """Incremental :func:`tp_attention_sublayer` with a KV cache
    (inference), with the residual add. ``h``: the new tokens' ``[b, q,
    d]`` at positions ``[pos, pos + q)`` (a host integer), replicated over
    the model line; ``cache``: ``{"k", "v"}`` of ``[b, max_len, H_local,
    hd]``, sharded BY HEADS with the weights, written in place. Each query
    attends cache rows up to its own position (-1e30 past it; ``allowed``,
    ``[q, max_len]`` rows of ``causal_table``, may be given). One
    all-reduce. Returns ``(h, cache)``."""
    b, q, _ = h.shape
    hn = _layernorm(h, p["ln1"])
    qkv = (torch.einsum("bsd,dthk->btshk", hn, p["wqkv"])
           + p["bqkv"][:, None])
    qh, kh, vh = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    hd = qh.shape[-1]
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[1]
    if pos < 0 or pos + q > max_len:
        raise ValueError(f"decode writes cache rows [{pos}, {pos + q}) of a "
                         f"cache of {max_len} rows")
    ck[:, pos:pos + q] = kh.to(ck.dtype)
    cv[:, pos:pos + q] = vh.to(cv.dtype)
    if allowed is None:
        allowed = causal_table(max_len, h.device)[pos:pos + q]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, ck).float() / math.sqrt(hd)
    logits = torch.where(allowed, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(h.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, cv)
    out = tp_allreduce(torch.einsum("bshk,hkd->bsd", attn, p["wo"]),
                       mesh) + p["bo"]
    return h + out, cache


def tp_block_decode(p: Dict[str, Any], h: torch.Tensor, cache: dict,
                    pos: int, *, mesh=None,
                    allowed: Optional[torch.Tensor] = None):
    """Incremental :func:`tp_block_apply` with a KV cache (inference):
    cached TP attention, then the column/row FFN (the block's second
    all-reduce). Returns ``(h, cache)``."""
    h, cache = tp_attention_decode(p, h, cache, pos, mesh=mesh,
                                   allowed=allowed)
    hn2 = _layernorm(h, p["ln2"])
    inner = _gelu(hn2 @ p["w1"] + p["b1"])
    ff = tp_allreduce(inner @ p["w2"], mesh) + p["b2"]
    return h + ff, cache


# the keys of ``tp_block_tapped``'s ys, in the split's flat order
TP_YS = ("ln1", "qkv", "out", "ln2", "ff1", "ff2")


def tp_block_zs(h: torch.Tensor, p: Dict[str, Any]) -> Dict[str, Any]:
    """Zero injection points for :func:`tp_block_tapped`, shaped from the
    activation and the param tree (``pipe_tpu``'s ``tp_block_zs``)."""
    rows, seq, d = h.shape
    _, three, H, hd = p["wqkv"].shape
    ff = p["w1"].shape[1]

    def z(*shape):
        return torch.zeros(shape, dtype=h.dtype, device=h.device)

    return {"ln1": z(rows, seq, d), "qkv": z(rows, three, seq, H, hd),
            "out": z(rows, seq, d), "ln2": z(rows, seq, d),
            "ff1": z(rows, seq, ff), "ff2": z(rows, seq, d)}


def tp_block_tapped(p: Dict[str, Any], h: torch.Tensor,
                    ctx: StageCtx = StageCtx(), zs=None, *,
                    dropout: float = 0.0, causal: bool = True):
    """Split-backward form of :func:`tp_block_apply` (unsharded math): the
    same forward values, plus the outputs of every param-consuming op
    (``ys``, keyed as :func:`tp_block_zs`; ``zs`` added in when given, as
    ``pipe_tpu`` injects them) and their inputs (``taps``). With the params
    held constant (detached), the cotangents at ``ys`` are exactly what
    :func:`tp_block_wgrad` contracts with ``taps``: B carries no
    weight-gradient product. Returns ``(out, ys, taps)``."""
    s1, s2 = _seeds(ctx, dropout)

    def inj(name, t):
        return t if zs is None else t + zs[name]

    ys = {}
    ln1_out, xhat1 = _layernorm_tapped(h, p["ln1"])
    hn = ys["ln1"] = inj("ln1", ln1_out)
    qkv = ys["qkv"] = inj("qkv", torch.einsum("bsd,dthk->btshk", hn,
                                              p["wqkv"])
                          + p["bqkv"][:, None])
    attn = _attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal, h.dtype)
    out = ys["out"] = inj("out", torch.einsum("bshk,hkd->bsd", attn,
                                              p["wo"]) + p["bo"])
    h = h + _drop(out, dropout, s1, ctx.rows)
    ln2_out, xhat2 = _layernorm_tapped(h, p["ln2"])
    hn2 = ys["ln2"] = inj("ln2", ln2_out)
    pre_act = ys["ff1"] = inj("ff1", hn2 @ p["w1"] + p["b1"])
    act = _gelu(pre_act)
    ff = ys["ff2"] = inj("ff2", act @ p["w2"] + p["b2"])
    h_out = h + _drop(ff, dropout, s2, ctx.rows)
    taps = {"xhat1": xhat1, "hn": hn, "attn": attn, "xhat2": xhat2,
            "hn2": hn2, "act": act}
    return h_out, ys, taps


def tp_block_wgrad(taps: Dict[str, Any], gzs: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """Parameter gradients from (taps, per-op output cotangents): the W
    pass, nothing but the weight-gradient contractions."""
    def sum_b(a):
        return a.sum(dim=(0, 1))

    return {
        "ln1": {"scale": (taps["xhat1"] * gzs["ln1"]).sum(dim=(0, 1)),
                "bias": sum_b(gzs["ln1"])},
        "wqkv": torch.einsum("bsd,btshk->dthk", taps["hn"], gzs["qkv"]),
        "bqkv": gzs["qkv"].sum(dim=(0, 2)),
        "wo": torch.einsum("bshk,bsd->hkd", taps["attn"], gzs["out"]),
        "bo": sum_b(gzs["out"]),
        "ln2": {"scale": (taps["xhat2"] * gzs["ln2"]).sum(dim=(0, 1)),
                "bias": sum_b(gzs["ln2"])},
        "w1": torch.einsum("bsd,bsf->df", taps["hn2"], gzs["ff1"]),
        "b1": sum_b(gzs["ff1"]),
        "w2": torch.einsum("bsf,bsd->fd", taps["act"], gzs["ff2"]),
        "b2": sum_b(gzs["ff2"]),
    }


class _Norm(nn.Module):
    """A LayerNorm's two leaves under ``pipe_tpu``'s names."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class _CacheShim:
    """The ``block.attn.make_cache`` surface the generators call: caches of
    the heads this rank holds (the LOCAL head count)."""

    def __init__(self, block: "TPBlock"):
        self._block = block

    @property
    def nhead(self) -> int:
        return int(self._block.wqkv.shape[2])

    def make_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        w = self._block.wqkv
        shape = (batch, max_len, w.shape[2], w.shape[3])
        dt = w.dtype if dtype is None else dtype
        return {"k": torch.zeros(shape, dtype=dt, device=w.device),
                "v": torch.zeros(shape, dtype=dt, device=w.device)}


class TPBlock(nn.Module):
    """The tensor-parallel block as a module: its parameters keep
    ``pipe_tpu``'s leaf names and shapes (``ln1.{scale,bias}``, ``wqkv [d,
    3, H, hd]``, ``bqkv [3, H, hd]``, ``wo [H, hd, d]``, ``bo``,
    ``ln2.*``, ``w1 [d, ff]``, ``b1``, ``w2 [ff, d]``, ``b2``), drawn as
    ``pipe_tpu``'s ``tp_block_init`` draws them (normal, scaled by
    1/sqrt(fan-in); biases zero; LayerNorms one and zero), whole. A rank of
    a model line holds its slices of the sharded leaves once
    ``parallel.mesh.shard_params`` has cut them (``ScheduledPipeline(
    stage_param_specs=)`` and ``TPShardedGenerator`` do). ``tp_axis``:
    ``MODEL_AXIS``, whose line of ``mesh`` the block all-reduces over, or
    None (the unsharded yardstick). Weights are cast to the activation's
    dtype at use."""

    def __init__(self, d_model: int, nhead: int, d_ff: int,
                 dropout: float = 0.0, causal: bool = True, *,
                 tp_axis: Optional[str] = MODEL_AXIS, mesh=None,
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hd = d_model // nhead
        if hd * nhead != d_model:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"nhead={nhead}")
        if tp_axis not in (None, MODEL_AXIS):
            raise ValueError(f"tp_axis must be {MODEL_AXIS!r} or None, got "
                             f"{tp_axis!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.d_model, self.nhead, self.d_ff = d_model, nhead, d_ff
        self.dropout, self.causal = dropout, causal
        self.tp_axis = tp_axis
        self.mesh = mesh

        def normal(*shape, fan_in):
            w = torch.randn(shape, generator=generator, dtype=dtype,
                            device=dev)
            return nn.Parameter(w / math.sqrt(fan_in))

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))

        self.ln1 = _Norm(d_model, dtype, dev)
        self.wqkv = normal(d_model, 3, nhead, hd, fan_in=d_model)
        self.bqkv = zeros(3, nhead, hd)
        self.wo = normal(nhead, hd, d_model, fan_in=d_model)
        self.bo = zeros(d_model)
        self.ln2 = _Norm(d_model, dtype, dev)
        self.w1 = normal(d_model, d_ff, fan_in=d_model)
        self.b1 = zeros(d_ff)
        self.w2 = normal(d_ff, d_model, fan_in=d_ff)
        self.b2 = zeros(d_model)
        self.attn = _CacheShim(self)

    def tree(self, dtype=None, detach: bool = False) -> Dict[str, Any]:
        """The parameters as ``pipe_tpu``'s nested dict, cast to ``dtype``
        (and detached: the split's params-constant forward)."""
        def leaf(p):
            p = p.detach() if detach else p
            return p if dtype is None else p.to(dtype)

        return {
            "ln1": {"scale": leaf(self.ln1.scale),
                    "bias": leaf(self.ln1.bias)},
            "wqkv": leaf(self.wqkv), "bqkv": leaf(self.bqkv),
            "wo": leaf(self.wo), "bo": leaf(self.bo),
            "ln2": {"scale": leaf(self.ln2.scale),
                    "bias": leaf(self.ln2.bias)},
            "w1": leaf(self.w1), "b1": leaf(self.b1),
            "w2": leaf(self.w2), "b2": leaf(self.b2),
        }

    def model_line(self):
        """The mesh to all-reduce over, checked against the slices held: a
        line of ``tp`` ranks needs the heads cut ``tp`` ways, and whole
        heads need no line (else the partial sums would be wrong)."""
        line = _line(self.mesh) if self.tp_axis is not None else None
        tp = 1 if line is None else line.model_size
        held = int(self.wqkv.shape[2])
        if held * tp != self.nhead:
            raise ValueError(
                f"the block holds {held} of {self.nhead} heads over a model "
                f"line of {tp}: cut its sharded leaves with "
                f"parallel.mesh.shard_params (stage_param_specs) first")
        return line

    def forward(self, h, ctx: StageCtx = StageCtx()):
        return tp_block_apply(self.tree(h.dtype), h, ctx,
                              dropout=self.dropout, causal=self.causal,
                              mesh=self.model_line())

    def decode(self, h, cache: dict, pos, tree=None, *,
               allowed: Optional[torch.Tensor] = None):
        """Incremental apply with a KV cache of this rank's heads
        (inference): ``(h, cache)``."""
        if not self.causal:
            raise ValueError("KV-cache decode requires causal attention")
        if tree is not None or isinstance(pos, torch.Tensor):
            raise NotImplementedError(
                "the tensor-parallel block decodes at a host-integer "
                "position without a draft tree, as pipe_tpu's")
        return tp_block_decode(self.tree(h.dtype), h, cache, pos,
                               mesh=self.model_line(), allowed=allowed)

