"""Streaming (vocab-blocked) softmax cross-entropy: the fused head and loss.

Counterpart of ``pipe_tpu/ops/losses.py``. The loss of the tutorial LM
otherwise holds ``[tokens, vocab]`` float32 logits per micro-batch just to
reduce them to one number per token. :func:`streaming_xent` computes the
same cross-entropy holding one ``[tokens, block]`` logit tile at a time: a
loop over vocab blocks carries the online logsumexp (running max and
rescaled sum of exponentials, the flash-attention recurrence on the vocab
axis) and picks up the target's logit when its block goes past.

The backward recomputes each tile (``softmax(tile) - onehot``) from the
saved logsumexp, as ``pipe_tpu``'s ``custom_vjp`` does, so what is kept from
the forward is O(tokens) numbers, not logits. The last block is padded with
zero weight columns and ``-inf`` biases (``_pad_blocks``): padded columns add
``exp(-inf) = 0`` to the sum and get no gradient. Accumulation is float32
throughout; a ``bfloat16`` ``h`` multiplies bf16 values exactly in float32.

It is plain torch (``torch.matmul`` per tile): ``pipe_tpu`` has no Pallas
kernel here, its tiles are XLA dots. It is a capacity knob, not a speed
knob: the recompute costs one more pass of head FLOPs.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["streaming_xent"]


def _pad_blocks(w: torch.Tensor, b: torch.Tensor, block: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``w [d, V]``, ``b [V]`` padded to whole blocks (zero columns, -inf
    biases); returns them with the block count."""
    d, V = w.shape
    nb = -(-V // block)
    pad = nb * block - V
    if pad:
        w = torch.cat([w, w.new_zeros(d, pad)], dim=1)
        b = torch.cat([b, b.new_full((pad,), float("-inf"))])
    return w, b, nb


def _tile(h32: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
          block: int, dtype: torch.dtype) -> torch.Tensor:
    """Float32 logits of vocab block ``k``: ``[*, s, block]``. The weight
    tile is rounded to ``h``'s dtype first, as ``pipe_tpu`` casts it."""
    w_blk = w[:, k * block:(k + 1) * block].to(dtype).float()
    return h32 @ w_blk + b[k * block:(k + 1) * block].float()


class _StreamingXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, b, targets, block):
        wp, bp, nb = _pad_blocks(w, b, block)
        h32 = h.float()
        tgt = targets.long()
        m = torch.full(tgt.shape, float("-inf"), device=h.device)
        s = torch.zeros(tgt.shape, device=h.device)
        gold = torch.zeros(tgt.shape, device=h.device)
        for k in range(nb):
            z = _tile(h32, wp, bp, k, block, h.dtype)
            m2 = torch.maximum(m, z.amax(dim=-1))
            s = s * torch.exp(m - m2) + torch.exp(z - m2[..., None]).sum(-1)
            local = tgt - k * block
            in_blk = (local >= 0) & (local < block)
            picked = torch.gather(z, -1, local.clamp(0, block - 1)[..., None])
            gold = torch.where(in_blk, picked[..., 0], gold)
            m = m2
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, b, tgt, lse)
        ctx.block = block
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        h, w, b, tgt, lse = ctx.saved_tensors
        block = ctx.block
        wp, bp, nb = _pad_blocks(w, b, block)
        d, V = w.shape
        h32 = h.float()
        g = g.float()
        dh = torch.zeros(h.shape[:-1] + (d,), device=h.device)
        dw = torch.empty(d, nb * block, device=h.device)
        db = torch.empty(nb * block, device=h.device)
        for k in range(nb):
            z = _tile(h32, wp, bp, k, block, h.dtype)
            p = torch.exp(z - lse[..., None])
            local = tgt - k * block
            in_blk = (local >= 0) & (local < block)
            onehot = torch.zeros_like(p).scatter_(
                -1, local.clamp(0, block - 1)[..., None],
                in_blk[..., None].float())
            dz = (p - onehot) * g[..., None]                # [*, s, block]
            w_blk = wp[:, k * block:(k + 1) * block].float()
            dh = dh + dz @ w_blk.t()
            dw[:, k * block:(k + 1) * block] = (
                h32.reshape(-1, d).t() @ dz.reshape(-1, block))
            db[k * block:(k + 1) * block] = dz.reshape(-1, block).sum(0)
        return (dh.to(h.dtype), dw[:, :V].to(w.dtype), db[:V].to(b.dtype),
                None, None)


def streaming_xent(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   targets: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """Per-token cross-entropy ``[*, s]`` of ``softmax(h @ w + b)`` against
    ``targets``, streamed over vocab blocks of ``block`` columns (the full
    logits are never held). ``h``: ``[*, s, d]``; ``w``: ``[d, V]`` (the
    port's ``Linear`` keeps ``[V, d]``: pass its ``weight.t()``); ``b``:
    ``[V]``; ``targets``: integer ``[*, s]``."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    return _StreamingXent.apply(h, w, b, targets, int(block))
