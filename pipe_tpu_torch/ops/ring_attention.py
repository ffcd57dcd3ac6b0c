"""Ring attention: exact attention over a sequence sharded across ranks.

Counterpart of ``pipe_tpu/ops/ring_attention.py``. The sequence axis is
sharded over the mesh's context line (each rank holds ``seq / n`` query rows
and one K/V block); ``n`` ring steps let every rank attend to every block
with the streaming-softmax (flash) recurrence, the K/V block moving one hop
round the context ring between steps (``parallel.mesh.context_shift``,
JAX's ``ppermute``). Causal masking compares global positions: a rank's
queries start at ``idx * sq`` and the block that visits at step ``r`` was
born on rank ``idx - r``, so its keys start at ``(idx - r) * sk``.

JAX's version streams the softmax in XLA einsums and has no Pallas kernel;
so has this one (``torch.einsum``). It is differentiable: the shift is an
``autograd.Function`` whose backward shifts the cotangents the other way,
JAX's reversed ring. Blocks a causal query row cannot see are fully masked;
the recurrence keeps them exact and their gradients zero, as JAX's
``where(isfinite(...))`` guards do. ``n - 1`` shifts run where JAX's scan
runs ``n`` (its last one brings each block home unused).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.mesh import context_shift

__all__ = ["ring_attention", "blockwise_attention_reference"]

_NEG_INF = float("-inf")


def _block_attend(q, k, v, o, m, l, q_start: int, k_start: int,
                  causal: bool, scale: float):
    """One streaming-softmax accumulation over a visiting K/V block.

    q: [b, sq, h, d]; k/v: [b, sk, h, d]; o: [b, sq, h, d] float32;
    m, l: [b, h, sq] float32 running max and normalizer.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        qpos = q_start + torch.arange(sq, device=q.device)[:, None]
        kpos = k_start + torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, _NEG_INF)
    block_max = logits.amax(dim=-1)                            # [b, h, q]
    new_m = torch.maximum(m, block_max)
    # a fully masked row: new_m is -inf; make the shift a no-op then
    safe_m = torch.where(torch.isfinite(new_m), new_m,
                         torch.zeros_like(new_m))
    p = torch.exp(logits - safe_m[..., None])                  # 0 at -inf
    correction = torch.exp(m - safe_m)                         # 0 at -inf
    l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    o = o * correction.transpose(1, 2)[..., None] + pv
    return o, new_m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact multi-head attention with the sequence sharded over ``mesh``'s
    context line.

    ``q``/``k``/``v`` are this rank's shards ``[batch, seq_local, heads,
    head_dim]`` (context index ``i`` holds positions ``i * seq_local ..``);
    returns this rank's output shard in ``q``'s dtype. ``mesh`` None, or a
    mesh without a context axis: one shard, plain blockwise attention.
    Differentiable (the ring reverses in the backward).
    """
    n = 1 if mesh is None else mesh.context_size
    idx = 0 if mesh is None else mesh.context
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    q_start = idx * sq
    kb, vb = k, v
    for r in range(n):
        src = (idx - r) % n       # the rank the visiting block was born on
        o, m, l = _block_attend(q, kb, vb, o, m, l, q_start,
                                src * kb.shape[1], causal, scale)
        if r < n - 1:
            kb, vb = context_shift(mesh, kb, vb)
    return (o / l.clamp(min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)


def blockwise_attention_reference(q, k, v, *, causal: bool = True,
                                  scale: Optional[float] = None):
    """One-device oracle with the same semantics (float32 logits; causal
    rows aligned at the end when ``sq != sk``)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
