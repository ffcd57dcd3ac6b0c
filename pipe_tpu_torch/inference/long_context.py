"""Long-context decoding: the prompt's KV cache stays context-sharded.

Counterpart of ``pipe_tpu/inference/long_context.py``. A prompt too long
for one card is prefilled sharded over the mesh's context line, and its KV
cache is then the sharded object, so decoding attends across the shards:

* **prefill**: each rank embeds its shard of the prompt at its global
  offset, runs the blocks with ``ring_attention`` for the attention output
  and keeps its own K/V rows as its permanent share of the prompt cache (no
  gather: each rank owns ``1 / n_context`` of it);
* **first token**: from the logits of the last global position, which the
  last context rank holds;
* **decode**: the new token's query is replicated; every rank computes a
  streaming-softmax partial (numerator, normalizer, running max) over its
  prompt-cache shard, rank 0 adds the partial over the short, replicated
  decode-time cache, and one max and one sum all-reduce over the context
  line per layer per token merge the partials (the distributed flash
  combine). The FFN, the norms, the head and sampling are replicated
  compute on a ``[b, 1, d]`` activation.

Beam search (:meth:`ContextShardedGenerator.generate_with_scores`) runs the
``k`` beams of a row on the query axis against the same untiled prompt
shard: only the decode cache is tiled to ``b * k`` rows and reordered by
parent each step, as the one-device beam does.

Sampling uses the port's ``sample_logits`` with a ``torch.Generator``
seeded alike on every rank: every rank draws the same uniforms in the same
order as the one-device ``Generator`` does, so the ranks agree on every
token (the first is taken from the last context rank) and a seed gives the
one-device stream except where the logits' rounding differs. JAX's key
chain is not reproduced (ROADMAP.md C.24). As in ``pipe_tpu``, the
context-sharded generator has no EOS stop. The decode attention is plain:
this path launches no kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..models.long_context_lm import block_post_attention, block_qkv
from ..ops.ring_attention import ring_attention
from ..parallel.mesh import CONTEXT_AXIS
from .generate import (GenerationConfig, check_positions, head_logits,
                       sample_logits)

__all__ = ["ContextShardedGenerator"]

_NEG_INF = float("-inf")


def _partial_attend(q, k, v, scale: float):
    """Streaming-softmax partial of ``q`` over every key of ``k``.

    q: [b, Q, h, hd]; k/v: [b, S, h, hd]. Returns (o [b, Q, h, hd] float32,
    m [b, h, Q] float32, l [b, h, Q] float32): an unnormalized numerator
    with its own max and normalizer, mergeable with other partials.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return o, m, p.sum(dim=-1)


def _rescale(m, top):
    """``exp(m - top)`` with ``top`` made finite (0 where ``m`` is -inf)."""
    safe = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    return torch.exp(m - safe)


def _merge_partials(a, b):
    """Merge two partials locally (the flash combine)."""
    (o, m, l), (o2, m2, l2) = a, b
    top = torch.maximum(m, m2)
    a1, a2 = _rescale(m, top), _rescale(m2, top)
    o = o * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o, top, l * a1 + l2 * a2


def _global_combine(mesh, o, m, l):
    """The partials' max and sum over the context line, normalized: one max
    all-reduce and one sum all-reduce (numerator and normalizer in one
    buffer)."""
    top = m.clone()
    mesh.all_reduce(top, CONTEXT_AXIS, op="max")
    alpha = _rescale(m, top)
    num = o * alpha.transpose(1, 2)[..., None]
    den = l * alpha
    buf = torch.cat([num.reshape(-1), den.reshape(-1)])
    mesh.all_reduce(buf, CONTEXT_AXIS)
    num = buf[:num.numel()].view_as(num)
    den = buf[num.numel():].view_as(den)
    return num / den.clamp(min=1e-30).transpose(1, 2)[..., None]


class ContextShardedGenerator:
    """KV-cached decoding with the prompt cache sharded over the context
    line of ``mesh`` (one with a context axis). ``model``: the tutorial LM
    (a :class:`~pipe_tpu_torch.models.long_context_lm.ContextParallelLM`,
    or any ``PipelinedLM``: its blocks run with the ring's attention here;
    float or ``quantize_params``' int8 blocks) holding every weight on this
    rank's device. Every rank of the line calls
    :meth:`generate` with the whole prompt; the prompt length must divide
    by the context axis' size. Every rank returns the tokens."""

    def __init__(self, mesh, model,
                 gen_cfg: GenerationConfig = GenerationConfig()):
        if mesh is None or CONTEXT_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {CONTEXT_AXIS!r} axis")
        self.mesh = mesh
        self.model = model
        self.gen_cfg = gen_cfg
        self.n_ctx = mesh.n_context

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _check(self, prompt) -> torch.Tensor:
        if not isinstance(prompt, torch.Tensor):
            prompt = torch.from_numpy(np.array(prompt))
        b, s_global = prompt.shape
        if s_global % self.n_ctx:
            raise ValueError(
                f"prompt length {s_global} must divide over {self.n_ctx} "
                f"context shards")
        check_positions(self.model, s_global, self.gen_cfg.max_new_tokens)
        return prompt.to(device=self.device, dtype=torch.int64)

    def _prefill(self, prompt: torch.Tensor):
        """Ring-attention prefill of this rank's shard: ``(h [b, s_local,
        d], [(k, v)] per layer)``, the K/V rows kept in the compute
        dtype."""
        m, mesh = self.model, self.mesh
        cd = m.cfg.compute_dtype
        s_local = prompt.shape[1] // self.n_ctx
        local = prompt[:, mesh.context * s_local:(mesh.context + 1) * s_local]
        h = m.embed_at(local, mesh.context * s_local)
        cache = []
        for blk in m.blocks:
            q, k, v = block_qkv(blk, h)
            a = ring_attention(q, k, v, mesh, causal=m.cfg.causal)
            cache.append((k.to(cd), v.to(cd)))
            h = block_post_attention(blk, h, a)
        return h, cache

    def _from_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last context rank's ``t`` on every rank (a masked sum)."""
        t = t if self.mesh.context == self.n_ctx - 1 else torch.zeros_like(t)
        t = t.clone()
        self.mesh.all_reduce(t, CONTEXT_AXIS)
        return t

    def _decode_layers(self, h, cache, dcache, t: int, beams: int = 1):
        """One token per row through every block: K/V written into row
        ``t`` of the decode cache; each query attends over its row's
        prompt shard and (on context rank 0) the decode cache's first
        ``t + 1`` rows, merged over the line. The ``beams`` beams of a row
        (``b * beams`` rows) ride the query axis of its untiled prompt
        shard."""
        cfg = self.model.cfg
        cd = cfg.compute_dtype
        nh, hd = cfg.nhead, cfg.d_model // cfg.nhead
        scale = 1.0 / math.sqrt(hd)
        for blk, (pk, pv), (dk, dv) in zip(self.model.blocks, cache, dcache):
            q, k, v = block_qkv(blk, h)
            dk[:, t] = k[:, 0].to(cd)
            dv[:, t] = v[:, 0].to(cd)
            bk = q.shape[0]
            o, m, l = _partial_attend(q.reshape(bk // beams, beams, nh, hd),
                                      pk, pv, scale)
            part = (o.reshape(bk, 1, nh, hd),
                    m.transpose(1, 2).reshape(bk, nh, 1),
                    l.transpose(1, 2).reshape(bk, nh, 1))
            if self.mesh.context == 0:
                part = _merge_partials(part, _partial_attend(
                    q, dk[:, :t + 1], dv[:, :t + 1], scale))
            a = _global_combine(self.mesh, *part)
            h = block_post_attention(blk, h, a.to(cd))
        return h

    def _decode_cache(self, rows: int):
        cfg = self.model.cfg
        nh, hd = cfg.nhead, cfg.d_model // cfg.nhead
        shape = (rows, self.gen_cfg.max_new_tokens, nh, hd)
        return [(torch.zeros(shape, dtype=cfg.compute_dtype,
                             device=self.device),
                 torch.zeros(shape, dtype=cfg.compute_dtype,
                             device=self.device))
                for _ in self.model.blocks]

    def _generate(self, prompt: torch.Tensor, gen: torch.Generator):
        m, cfg = self.model, self.gen_cfg
        b, s_global = prompt.shape
        n = cfg.max_new_tokens
        h, cache = self._prefill(prompt)
        tok = sample_logits(head_logits(m, h[:, -1]), cfg, gen)
        tok = self._from_last(tok)
        out = torch.empty((b, n), dtype=torch.int64, device=self.device)
        out[:, 0] = tok
        dcache = self._decode_cache(b)
        for t in range(n - 1):
            h = self._decode_layers(m.embed_at(tok[:, None], s_global + t),
                                    cache, dcache, t)
            tok = sample_logits(head_logits(m, h[:, 0]), cfg, gen)
            out[:, t + 1] = tok
        return out

    def _generate_beam(self, prompt: torch.Tensor):
        """Context-sharded beam search, sum-of-log-probs scoring: ``(tokens
        [b, max_new], scores [b])`` of the best beam."""
        m, cfg = self.model, self.gen_cfg
        k, n = cfg.num_beams, cfg.max_new_tokens
        b, s_global = prompt.shape
        dev = self.device
        h, cache = self._prefill(prompt)
        logp = torch.log_softmax(head_logits(m, h[:, -1]), dim=-1)
        scores, tok = torch.topk(logp, k, dim=-1)               # [b, k]
        scores, tok = self._from_last(scores), self._from_last(tok)
        out = torch.zeros((b, k, n), dtype=torch.int64, device=dev)
        out[:, :, 0] = tok
        dcache = self._decode_cache(b * k)
        rows = torch.arange(b, device=dev)[:, None] * k
        for t in range(n - 1):
            h = self._decode_layers(
                m.embed_at(tok.reshape(b * k, 1), s_global + t), cache,
                dcache, t, beams=k)
            logp = torch.log_softmax(head_logits(m, h[:, 0]), dim=-1)
            vocab = logp.shape[-1]
            total = scores[:, :, None] + logp.reshape(b, k, vocab)
            scores, idx = torch.topk(total.reshape(b, k * vocab), k, dim=-1)
            parent = idx // vocab
            tok = idx % vocab
            flat = (rows + parent).reshape(-1)
            dcache = [(dk.index_select(0, flat), dv.index_select(0, flat))
                      for dk, dv in dcache]
            out = torch.take_along_dim(out, parent[:, :, None], dim=1)
            out[:, :, t + 1] = tok
        best = torch.argmax(scores, dim=1)
        pick = torch.arange(b, device=dev)
        return out[pick, best], scores[pick, best]

    # --- public ---

    def generate(self, prompt, *, seed: int = 0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """``[b, max_new_tokens]`` int64 continuations of ``prompt [b,
        s_global]`` (the whole prompt, on every rank of the line). Sampling
        draws from ``generator`` or a new one seeded with ``seed`` (alike
        on every rank). ``num_beams > 1`` runs the context-sharded beam
        search (deterministic)."""
        if self.gen_cfg.num_beams > 1:
            return self.generate_with_scores(prompt)[0]
        prompt = self._check(prompt)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            return self._generate(prompt, generator)

    def generate_with_scores(self, prompt):
        """Context-sharded beam search: ``(tokens [b, max_new], scores
        [b])``, the one-device ``Generator.generate_with_scores``
        contract."""
        if self.gen_cfg.num_beams < 2:
            raise ValueError("generate_with_scores requires num_beams >= 2")
        prompt = self._check(prompt)
        with torch.inference_mode():
            return self._generate_beam(prompt)
