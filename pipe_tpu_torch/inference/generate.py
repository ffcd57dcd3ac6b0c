"""Autoregressive generation with KV caches over the pipelined LM families.

Counterpart of ``pipe_tpu/inference/generate.py``. Prefill fills every
layer's KV cache in one batched pass over the prompt; then each step embeds
one token per row, runs every block's cached ``decode`` (O(1) new work per
layer) and samples the next token. The caches are allocated at ``prompt +
max_new_tokens`` rows up front and masked to the live prefix, as in
``pipe_tpu``; the decode attention is plain einsum-softmax there and here,
so generation launches no flash kernel.

Sampling: greedy (``temperature=0``, the first maximum, as ``jnp.argmax``),
temperature softmax, optional top-k (ties at the k-th value survive), drawn
by Gumbel-max from an explicit ``torch.Generator``, once per step in step
order: the same seed gives the same tokens. ``pipe_tpu``'s key chain cannot
be reproduced, so sampled tokens are held to the port's own reproducibility
and to the distribution, not to JAX's bits.

The serve engine draws instead from :func:`keyed_uniform`: one uniform per
(request seed, step, vocab index) from a counter-based Philox4x32-10, so a
slot's tokens do not depend on what the other slots hold, and the draw can
be captured in a CUDA graph. Served sampled tokens are held to that form's
own reproducibility and to the distribution, not to this generator's
stream.

The decode loop reads nothing back to the host: tokens and the EOS ``done``
mask stay on the device, positions are the loop's own host integers, and
the causal mask table is built once per call. Eager PyTorch compiles nothing
per shape, so ``pipe_tpu``'s per-shape program-cache warning has no
counterpart. Each call records its wall time and tokens into the telemetry
registry (``obs/telemetry.py``) when it is enabled, as ``pipe_tpu`` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..obs.telemetry import get_registry
from ..ops.flash_attention import philox4x32
from ..ops.layers import causal_table
from .quant import QuantLinear

__all__ = ["GenerationConfig", "Generator", "check_positions",
           "head_logits", "keyed_uniform", "sample_logits", "seed_word",
           "sequence_lengths"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0     # 0 = greedy (argmax)
    top_k: Optional[int] = None  # None = full distribution
    # >1: beam search (deterministic, sum-of-log-probs scoring; temperature
    # and top_k are ignored). KV caches are gathered by parent beam each step.
    num_beams: int = 1
    # Stop token: a row that emits it emits pad_token_id from the next step
    # on (the loop still runs max_new_tokens steps). None = no early stop.
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    # Serving knobs, checked here and read by the serving slice (the one-shot
    # generators ignore them): kv_block_size (a power of two) switches slots to
    # the paged KV pool, prefix_cache gates shared-prefix block reuse, and
    # spec_tokens sets the speculative-decode width.
    kv_block_size: Optional[int] = None
    prefix_cache: bool = True
    spec_tokens: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {self.num_beams}")
        if self.eos_token_id is not None and self.eos_token_id < 0:
            raise ValueError(
                f"eos_token_id must be >= 0, got {self.eos_token_id}")
        if self.pad_token_id < 0:
            raise ValueError(
                f"pad_token_id must be >= 0, got {self.pad_token_id}")
        if self.kv_block_size is not None and (
                self.kv_block_size < 1
                or (self.kv_block_size & (self.kv_block_size - 1)) != 0):
            raise ValueError(
                f"kv_block_size must be a positive power of two (block "
                f"indexing is a shift+mask in the decode step), got "
                f"{self.kv_block_size}")
        if self.num_beams > 1 and self.eos_token_id is not None:
            raise ValueError(
                "eos_token_id with beam search is not implemented — "
                "EOS-aware beam pruning needs per-hypothesis length "
                "normalization; use num_beams=1 for early stopping")
        if self.spec_tokens is not None and self.spec_tokens < 2:
            raise ValueError(
                f"spec_tokens must be >= 2 (one draft token plus its "
                f"correction), got {self.spec_tokens}")
        if self.spec_tokens is not None and self.num_beams > 1:
            raise ValueError(
                "spec_tokens is a slot-decode lane; beam search has no "
                "speculative form (num_beams must be 1)")

    def check_kv_headroom(self, bucket_max_len: int,
                          block_size: Optional[int] = None,
                          spec_overshoot: int = 0) -> None:
        """Paged serving with length buckets: reject a block size that does
        not divide the per-slot KV span ``bucket_max_len + max_new_tokens
        (+ speculative headroom)``, whose last block would waste its tail
        rows on every slot. With ``spec_tokens`` the verify chunk writes
        past the last emitted row, so the span is the speculative one."""
        bs = block_size if block_size is not None else self.kv_block_size
        if bs is None:
            return
        span = int(bucket_max_len) + self.max_new_tokens + spec_overshoot
        waste = -span % bs
        if waste:
            spec = (f" + speculative headroom {spec_overshoot}"
                    if spec_overshoot else "")
            raise ValueError(
                f"kv_block_size={bs} does not divide the KV headroom "
                f"bucket_max_len + max_new_tokens{spec} = "
                f"{bucket_max_len} + {self.max_new_tokens}"
                f"{' + ' + str(spec_overshoot) if spec_overshoot else ''}"
                f" = {span}: every slot's last "
                f"block would waste {waste} of {bs} rows "
                f"({waste / bs:.0%} of a block) as unwritable padding; "
                f"pick a block size dividing {span} or adjust "
                f"max_new_tokens by {waste}")

    def check_decode_headroom(self, prefix_len: int, max_new_tokens: int,
                              bucket_max_len: int,
                              spec_overshoot: int = 0) -> None:
        """Decode-only serving: an imported prefix plus the request's
        ``max_new_tokens`` must fit the slot span ``bucket_max_len +
        max_new_tokens (+ speculative headroom)`` sized at construction;
        reject the overflow here, naming it."""
        span = int(bucket_max_len) + self.max_new_tokens + spec_overshoot
        need = int(prefix_len) + int(max_new_tokens) + spec_overshoot
        if need > span:
            spec = (f" + speculative headroom {spec_overshoot}"
                    if spec_overshoot else "")
            raise ValueError(
                f"decode-only: imported prefix {prefix_len} + "
                f"max_new_tokens {max_new_tokens}{spec} = {need} rows "
                f"exceeds the decode slot span bucket_max_len + "
                f"max_new_tokens{spec} = {bucket_max_len} + "
                f"{self.max_new_tokens}"
                f"{' + ' + str(spec_overshoot) if spec_overshoot else ''}"
                f" = {span} by {need - span} rows; shorten the prefix, "
                f"lower the request's max_new_tokens, or size the "
                f"decode replica's buckets for the prefill fleet's "
                f"output lengths")


def check_positions(model, prompt_len: int, max_new_tokens: int) -> None:
    """Fail loudly when decode would run past the positional table; models
    give their capacity through ``max_position()``."""
    mp = getattr(model, "max_position", None)
    limit = mp() if callable(mp) else None
    if limit is not None and prompt_len + max_new_tokens > limit:
        raise ValueError(
            f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
            f"exceeds the positional table ({limit} positions)")


def head_logits(model, h: torch.Tensor) -> torch.Tensor:
    """The model head on hidden states, float32 logits: weights (int8 ones
    dequantized) and ``h`` in float32. A head with a final LayerNorm
    (GPT-2's ``ln_f``) applies it before the projection, as ``pipe_tpu``'s
    ``head.apply`` does."""
    head = model.head
    h = h.to(torch.float32)
    ln = getattr(head, "ln_f", None)
    if ln is not None:
        h = F.layer_norm(h, h.shape[-1:], ln.weight.to(torch.float32),
                         ln.bias.to(torch.float32), ln.eps)
    proj = head.proj
    w = (proj.leaf.dequant(torch.float32) if isinstance(proj, QuantLinear)
         else proj.weight.to(torch.float32))
    bias = None if proj.bias is None else proj.bias.to(torch.float32)
    return F.linear(h, w, bias)


def sample_logits(logits: torch.Tensor, cfg: GenerationConfig,
                  generator: Optional[torch.Generator] = None, *,
                  uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token ids ``[b]`` (int64) from ``logits [b, vocab]`` (float32
    math). Sampling draws one uniform per logit from ``generator``, or takes
    them from ``uniform`` (``[b, vocab]`` in (0, 1), e.g.
    :func:`keyed_uniform`), then picks by Gumbel-max."""
    logits = logits.to(torch.float32)
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k is not None:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, -1e30)
    if uniform is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    else:
        u = uniform
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1)


_MASK32 = 0xFFFFFFFF
# Philox counter word 3 of the sampling draws; the attention-dropout mask
# (``ops/flash_attention.py``) uses 0 there, so the two never share a word.
_SAMPLE_STREAM = 1


def seed_word(seed: int) -> int:
    """A request seed (any integer) as the int64 whose 64 bits are the seed
    modulo 2**64: the form :func:`keyed_uniform` takes in a tensor."""
    return ((int(seed) % (1 << 64)) ^ (1 << 63)) - (1 << 63)


def keyed_uniform(seeds: torch.Tensor, steps: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """``[b, vocab]`` float64 uniforms in (0, 1), one per (row's seed, row's
    step, vocab index) and a function of those alone: word 0 of
    Philox4x32-10 at counter ``(vocab index, step, 0, 1)`` under the key
    ``(seed low 32 bits, seed high 32 bits)``, plus a half, over 2**32.
    ``seeds`` (int64, :func:`seed_word`) and ``steps`` (int64) are ``[b]``
    device tensors, so the draw reads nothing back to the host."""
    v = torch.arange(vocab, dtype=torch.int64, device=seeds.device)[None]
    step = (steps & _MASK32)[:, None]
    zero = torch.zeros_like(step)
    w0 = philox4x32(v, step, zero, zero + _SAMPLE_STREAM,
                    (seeds & _MASK32)[:, None],
                    ((seeds >> 32) & _MASK32)[:, None])[0]
    return (w0.to(torch.float64) + 0.5) * (1.0 / (1 << 32))


def sequence_lengths(tokens, eos_token_id: Optional[int]) -> torch.Tensor:
    """Per-row generated length of ``tokens [..., max_new]``: the index of
    the first EOS plus one (the EOS counts as emitted), or the full width
    for rows that never stopped, and always the width with no EOS."""
    toks = torch.as_tensor(tokens)
    width = toks.shape[-1]
    if eos_token_id is None:
        return torch.full(toks.shape[:-1], width, dtype=torch.int64,
                          device=toks.device)
    hit = toks == eos_token_id
    first = torch.argmax(hit.to(torch.uint8), dim=-1)
    return torch.where(hit.any(dim=-1), first + 1, width)


class Generator:
    """KV-cached sampling over a ``PipelinedTransformer`` LM (``embed_at``,
    causal ``block.decode`` for every block, the head).

    The weights are the model's own: a :func:`~.quant.quantize_params` copy
    generates int8 weight-only. Generation runs on the model's device (the
    prompt is moved there), under ``torch.inference_mode``.

    ``layer_scan`` is accepted for ``pipe_tpu``'s signature and changes
    nothing: eager PyTorch has no scan, so both values run the same per-layer
    loop with per-layer caches written in place. ``layer_scan=False`` with
    beam search is refused, as in ``pipe_tpu``.

    With the telemetry registry enabled, each call waits for the device and
    records ``serve.generate_sec`` (``serve.beam_sec`` for beam search),
    ``serve.tokens`` and ``serve.tokens_per_sec``. ``phase_timing=True``
    also times a prefill-only pass per call and records
    ``serve.prefill_sec`` and ``serve.decode_sec`` (the call's time less
    the prefill's); it runs the prefill once more, so it is for profiling.
    """

    def __init__(self, model, gen_cfg: GenerationConfig = GenerationConfig(),
                 *, layer_scan: bool = True, phase_timing: bool = False):
        if not hasattr(model, "embed_at"):
            raise TypeError(
                f"{type(model).__name__} has no embed_at; KV-cache "
                "generation needs position-offset embedding")
        if not layer_scan and gen_cfg.num_beams > 1:
            raise ValueError(
                "layer_scan=False is not implemented for beam search "
                "(the beam path's cache-gather dominates its traffic; "
                "use the default scan path)")
        self.model = model
        self.gen_cfg = gen_cfg
        self.phase_timing = phase_timing

    # --- internals ---

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _observe(self, name: str, prompt: torch.Tensor, t0: float) -> float:
        """Record one finished call (the device waited for) into the
        registry: its seconds under ``name``, and the tokens it made."""
        reg = get_registry()
        self._sync()
        dt = time.perf_counter() - t0
        reg.histogram(name).observe(dt)
        tokens = prompt.shape[0] * self.gen_cfg.max_new_tokens
        reg.counter("serve.tokens").inc(tokens)
        if dt > 0:
            reg.gauge("serve.tokens_per_sec").set(tokens / dt)
        return dt

    def _observe_phases(self, prompt: torch.Tensor, e2e_sec: float) -> None:
        """Time a prefill-only pass (the prompt's pass and the first
        token's logits) and split the call's time into prefill and
        decode."""
        reg = get_registry()
        p = prompt.shape[1]
        total = p + self.gen_cfg.max_new_tokens
        t0 = time.perf_counter()
        with torch.inference_mode():
            h, _ = self._prefill(prompt, total,
                                 causal_table(total, prompt.device))
            head_logits(self.model, h[:, -1])
        self._sync()
        pf = time.perf_counter() - t0
        reg.histogram("serve.prefill_sec").observe(pf)
        reg.histogram("serve.decode_sec").observe(max(e2e_sec - pf, 0.0))

    def _prompt(self, prompt) -> torch.Tensor:
        if not isinstance(prompt, torch.Tensor):
            prompt = torch.from_numpy(np.array(prompt))
        if prompt.dim() != 2:
            raise ValueError(f"prompt must be [batch, prompt_len], got "
                             f"shape {tuple(prompt.shape)}")
        return prompt.to(device=self.device, dtype=torch.int64)

    def _prefill(self, prompt: torch.Tensor, max_len: int, allowed):
        """One batched causal pass over the prompt: writes rows
        ``[0, prompt_len)`` of every layer's cache. Returns (h, caches)."""
        m = self.model
        cd = m.cfg.compute_dtype
        b, p = prompt.shape
        caches = [blk.attn.make_cache(b, max_len, dtype=cd)
                  for blk in m.blocks]
        h = m.embed_at(prompt, 0)
        for l, blk in enumerate(m.blocks):
            h, caches[l] = blk.decode(h, caches[l], 0, allowed=allowed[:p])
        return h, caches

    def _run_layers(self, h, caches, pos: int, allowed):
        for l, blk in enumerate(self.model.blocks):
            h, caches[l] = blk.decode(h, caches[l], pos,
                                      allowed=allowed[pos:pos + 1])
        return h

    def _generate(self, prompt: torch.Tensor, gen: torch.Generator):
        m, cfg = self.model, self.gen_cfg
        b, p = prompt.shape
        n = cfg.max_new_tokens
        allowed = causal_table(p + n, prompt.device)
        h, caches = self._prefill(prompt, p + n, allowed)
        tok = sample_logits(head_logits(m, h[:, -1]), cfg, gen)
        out = torch.empty((b, n), dtype=torch.int64, device=prompt.device)
        out[:, 0] = tok
        eos = cfg.eos_token_id
        done = None if eos is None else tok == eos
        for t in range(1, n):
            pos = p + t - 1
            h = self._run_layers(m.embed_at(tok[:, None], pos), caches, pos,
                                 allowed)
            tok = sample_logits(head_logits(m, h[:, 0]), cfg, gen)
            if done is not None:
                # a finished row emits pad from the step after its EOS
                tok = torch.where(done, cfg.pad_token_id, tok)
                done = done | (tok == eos)
            out[:, t] = tok
        return out

    def _generate_beam(self, prompt: torch.Tensor):
        """Beam search, sum-of-log-probs scoring: the caches are repeated
        ``k`` times after prefill and gathered by parent beam every step.
        Returns ``(tokens [b, max_new], scores [b])`` of the best beam.
        ``torch.topk`` does not promise ``lax.top_k``'s lower-index-first
        order among exactly equal scores, so beams can differ from
        ``pipe_tpu``'s where two candidates tie exactly."""
        m, cfg = self.model, self.gen_cfg
        k, n = cfg.num_beams, cfg.max_new_tokens
        b, p = prompt.shape
        dev = prompt.device
        allowed = causal_table(p + n, dev)
        h, caches = self._prefill(prompt, p + n, allowed)
        logp = torch.log_softmax(head_logits(m, h[:, -1]), dim=-1)
        scores, tok = torch.topk(logp, k, dim=-1)                  # [b, k]
        caches = [{name: c.repeat_interleave(k, dim=0)
                   for name, c in cache.items()} for cache in caches]
        out = torch.zeros((b, k, n), dtype=torch.int64, device=dev)
        out[:, :, 0] = tok
        rows = torch.arange(b, device=dev)[:, None] * k
        for t in range(n - 1):
            pos = p + t
            h = self._run_layers(m.embed_at(tok.reshape(b * k, 1), pos),
                                 caches, pos, allowed)
            logp = torch.log_softmax(head_logits(m, h[:, 0]), dim=-1)
            vocab = logp.shape[-1]
            total = scores[:, :, None] + logp.reshape(b, k, vocab)
            scores, idx = torch.topk(total.reshape(b, k * vocab), k, dim=-1)
            parent = idx // vocab
            tok = idx % vocab
            flat_parent = (rows + parent).reshape(-1)
            caches = [{name: c.index_select(0, flat_parent)
                       for name, c in cache.items()} for cache in caches]
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
        prompt_len]`` token ids. Sampling draws from ``generator`` (on the
        model's device), or from a new one seeded with ``seed``. With
        ``num_beams > 1`` runs beam search (deterministic; no draws)."""
        prompt = self._prompt(prompt)
        check_positions(self.model, prompt.shape[1],
                        self.gen_cfg.max_new_tokens)
        if self.gen_cfg.num_beams > 1:
            return self.generate_with_scores(prompt)[0]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._generate(prompt, generator)
        if get_registry().enabled:
            dt = self._observe("serve.generate_sec", prompt, t0)
            if self.phase_timing:
                self._observe_phases(prompt, dt)
        return out

    def generate_with_scores(self, prompt):
        """Beam search: ``(tokens [b, max_new], scores [b])``, the best
        beam's tokens and its total log-probability."""
        if self.gen_cfg.num_beams < 2:
            raise ValueError("generate_with_scores requires num_beams >= 2")
        prompt = self._prompt(prompt)
        check_positions(self.model, prompt.shape[1],
                        self.gen_cfg.max_new_tokens)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._generate_beam(prompt)
        if get_registry().enabled:
            self._observe("serve.beam_sec", prompt, t0)
        return out

    def generate_with_lengths(self, prompt, *, seed: int = 0,
                              generator: Optional[torch.Generator] = None):
        """``(tokens [b, max_new], lengths [b])``: each row's generated
        length up to and including its first EOS, or ``max_new_tokens``
        (always, with ``eos_token_id=None``). Rows past their length hold
        pad."""
        out = self.generate(prompt, seed=seed, generator=generator)
        return out, sequence_lengths(out, self.gen_cfg.eos_token_id)
