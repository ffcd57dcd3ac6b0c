"""Pipelined autoregressive decoding over stage-sharded weights.

Counterpart of ``pipe_tpu/inference/pipelined.py``. A model whose weights
are pipeline-sharded (each rank of a stage ring holds only its stage's
blocks, the embedding on stage 0 and the head on stage n-1) cannot use the
one-device :class:`~.generate.Generator`: every token must traverse every
stage. This module pipelines the *requests* instead: the batch is split
into ``n_stages`` groups that chase each other round the stage ring, one
hop per cycle, so in steady state every stage decodes a different group's
token each cycle.

The wavefront is ``pipe_tpu``'s: at cycle ``c`` stage ``s`` works group
``(c - s) mod n``. A prefill first walks each group's prompt round the ring
once (``q = prompt_len``), writing cache rows ``[0, p)``; stage n-1 samples
the group's first token and sends it over the wrap edge to stage 0, which
embeds it when that group's next step begins. Each decode step then runs
one token per row through the same ring.

The port is host-driven: one process per stage (``parallel/mesh.py``),
each running the cycles of its own stage. A rank skips its fill and drain
cycles on the host instead of writing into a sacrificial cache region: a
cycle is valid on stage ``s`` when ``0 <= c - s < n * steps``, and every
rank evaluates that rule for its neighbours too, so a hop carries a message
exactly when its sender's cycle was valid (:meth:`Mesh.ring_shift`, no
length header: a message's shape is the program's). Beam search rides the
surviving beams' parent indices round the ring with the activations, and
each stage reorders its own cache rows by them before the group's next
step (``_device_program_beam``). EOS masking and sampling happen on stage
n-1: sampled draws take, per step, one ``[batch, vocab]`` uniform tensor
from the stage's ``torch.Generator`` and each group its rows of it, which
is the one-device ``Generator``'s stream. The decode attention is plain,
as in ``pipe_tpu``: the ring launches no kernel.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..obs.telemetry import get_registry
from ..ops.layers import causal_table
from .generate import (GenerationConfig, check_positions, head_logits,
                       sample_logits, sequence_lengths)

__all__ = ["PipelinedGenerator", "stage_modules", "stage_blocks",
           "localize_stage"]

# ring_shift tags of the two phases (a message of k tensors takes tag..tag+k)
_TAG_PREFILL, _TAG_DECODE = 100, 200


def stage_modules(model, stage: int, n_stages: int) -> List[torch.nn.Module]:
    """What stage ``stage`` of an ``n_stages`` ring runs of ``model`` (a
    ``PipelinedTransformer``): its ``n_layers / n_stages`` blocks, the
    embedding modules on stage 0 and the head on stage n-1."""
    n_layers = len(model.blocks)
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not divide into "
                         f"{n_stages} ring stages")
    lps = n_layers // n_stages
    keep = list(model.blocks[stage * lps:(stage + 1) * lps])
    if stage == 0:
        keep += [m for name, m in model.named_children()
                 if name not in ("blocks", model.post_key)]
    if stage == n_stages - 1:
        keep.append(model.head)
    return keep


def stage_blocks(model, stage: int, n_stages: int) -> List[torch.nn.Module]:
    """Stage ``stage``'s blocks of ``model``, once it is checked that this
    rank holds everything the stage runs (:func:`stage_modules`) off the
    ``meta`` device."""
    if any(p.device.type == "meta"
           for m in stage_modules(model, stage, n_stages)
           for p in m.parameters()):
        raise ValueError(
            f"stage {stage} of the ring needs its blocks (and the embedding "
            f"on stage 0, the head on stage n-1) on this rank; some sit on "
            f"the meta device (another rank's layout?)")
    lps = len(model.blocks) // n_stages
    return list(model.blocks[stage * lps:(stage + 1) * lps])


def localize_stage(model, mesh, device=None):
    """Keep only this rank's stage of ``model`` (:func:`stage_modules`) on
    ``device`` (default: the mesh's); the rest to the ``meta`` device. In
    place; returns ``model``."""
    from ..parallel.mesh import localize
    return localize(model, stage_modules(model, mesh.stage, mesh.n_stages),
                    device if device is not None else mesh.device)


class PipelinedGenerator:
    """Ring-pipelined KV-cache sampling over a mesh's stage ring.

    ``mesh`` is this rank's :class:`~..parallel.mesh.Mesh`; ``model`` a
    ``PipelinedTransformer`` LM with ``embed_at``, of which this rank reads
    only its stage (:func:`stage_modules`; the rest may sit on ``meta``,
    :func:`localize_stage`): ``pipe_tpu``'s stage-stacked params sharded
    over ``stage``, as ``convert.load_ring_stage`` carries them in. Every
    rank of the pipeline calls each method with the same prompt; every rank
    gets the tokens. The batch must divide into ``n_stages`` groups: rows
    ``[g*rpg, (g+1)*rpg)`` form ring group ``g``.
    """

    def __init__(self, mesh, model,
                 gen_cfg: GenerationConfig = GenerationConfig()):
        if not hasattr(model, "embed_at"):
            raise TypeError(
                f"{type(model).__name__} has no embed_at; KV-cache "
                "generation needs position-offset embedding")
        self.mesh = mesh
        self.model = model
        self.gen_cfg = gen_cfg
        self.n_stages = mesh.n_stages
        self.stage = mesh.stage
        self.blocks = stage_blocks(model, self.stage, self.n_stages)
        self.device = next(self.blocks[0].parameters()).device
        self._shapes = set()

    # --- internals ---

    def _check(self, prompt) -> torch.Tensor:
        if not isinstance(prompt, torch.Tensor):
            prompt = torch.from_numpy(np.array(prompt))
        if prompt.dim() != 2:
            raise ValueError(f"prompt must be [batch, prompt_len], got "
                             f"shape {tuple(prompt.shape)}")
        b, p = prompt.shape
        n = self.n_stages
        if b % n:
            raise ValueError(f"batch {b} must divide into {n} ring groups")
        check_positions(self.model, p, self.gen_cfg.max_new_tokens)
        return prompt.to(device=self.device, dtype=torch.int64)

    def _count_program(self, key) -> None:
        """``pipe_tpu``'s program-cache counters: a miss per new (kind,
        prompt length, rows per group), a hit after. Eager PyTorch compiles
        nothing, so they count shapes."""
        reg = get_registry()
        if key in self._shapes:
            reg.counter("serve.pipelined.program_cache_hits").inc()
        else:
            reg.counter("serve.pipelined.program_cache_misses").inc()
            self._shapes.add(key)

    def _observe(self, name: str, b: int, t0: float) -> None:
        reg = get_registry()
        if not reg.enabled:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        reg.histogram(name).observe(dt)
        tokens = b * self.gen_cfg.max_new_tokens
        reg.counter("serve.pipelined.tokens").inc(tokens)
        if dt > 0:
            reg.gauge("serve.pipelined.tokens_per_sec").set(tokens / dt)

    def _run_blocks(self, h, caches, rows: slice, pos: int, allowed):
        """This stage's blocks on ``h`` against the cache rows ``rows``
        (one group's), writing their K/V rows at ``pos`` in place."""
        for blk, cache in zip(self.blocks, caches):
            h, _ = blk.decode(h, {k: c[rows] for k, c in cache.items()},
                              pos, allowed=allowed)
        return h

    def _shift(self, c: int, steps: int, send, recv, tag: int) -> bool:
        """The hop at the end of cycle ``c`` of a phase of ``steps`` steps:
        ``send`` goes on when this stage's cycle was valid, ``recv`` is
        filled when the previous stage's was. Returns the latter."""
        n, s = self.n_stages, self.stage
        mine = 0 <= c - s < n * steps
        prev = (s - 1) % n
        theirs = 0 <= c - prev < n * steps
        self.mesh.ring_shift(send if mine else None,
                             recv if theirs else None, tag=tag)
        return theirs

    def _prefill(self, prompt, caches, rows, allowed, on_last):
        """Each group's prompt round the ring once (cycles ``0 .. 2n-2``);
        stage n-1 calls ``on_last(g, h_last)`` for the group's first token
        and returns the wrap message; stage 0 gets ``(g, message)`` back in
        the list it returns."""
        n, s = self.n_stages, self.stage
        m = self.model
        p = prompt.shape[1]
        rpg = prompt.shape[0] // n
        h_in = torch.empty((rpg, p, m.cfg.d_model),
                           dtype=m.cfg.compute_dtype, device=self.device)
        wrap = self._wrap_like(rpg)
        recv = wrap if s == 0 else [h_in]
        got = []
        for c in range(2 * n - 1):
            g = c - s
            send = None
            if 0 <= g < n:
                h = m.embed_at(prompt[rows(g)], 0) if s == 0 else h_in
                h = self._run_blocks(h, caches, rows(g), 0, allowed[:p])
                send = on_last(g, h[:, -1]) if s == n - 1 else [h]
            if self._shift(c, 1, send, recv, _TAG_PREFILL) and s == 0:
                got.append(((c - (n - 1)) % n, [t.clone() for t in wrap]))
        return got

    def _wrap_like(self, rpg: int) -> List[torch.Tensor]:
        """The wrap edge's message shapes: the group's tokens (and, beam,
        their parents)."""
        k = self.gen_cfg.num_beams
        ids = dict(dtype=torch.int64, device=self.device)
        if k == 1:
            return [torch.zeros(rpg, **ids)]
        return [torch.zeros(rpg * k, **ids), torch.zeros(rpg * k, **ids)]

    def _draws(self, gen: torch.Generator, b: int, vocab: int):
        """One step's uniforms for the whole batch, as ``Generator`` draws
        them (``sample_logits`` with a generator)."""
        u = torch.rand((b, vocab), generator=gen, device=self.device)
        return u.clamp_(min=torch.finfo(u.dtype).tiny)

    def _generate(self, prompt: torch.Tensor, gen: torch.Generator):
        m, cfg = self.model, self.gen_cfg
        n, s = self.n_stages, self.stage
        b, p = prompt.shape
        rpg = b // n
        new = cfg.max_new_tokens
        total = p + new
        dev = self.device
        cd = m.cfg.compute_dtype
        allowed = causal_table(total, dev)
        caches = [blk.attn.make_cache(b, total, dtype=cd)
                  for blk in self.blocks]

        def rows(g):
            return slice(g * rpg, (g + 1) * rpg)

        sampling = cfg.temperature != 0.0
        eos = cfg.eos_token_id
        out = torch.zeros((b, new), dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        u = [None]

        def sample(g, h_last):
            logits = head_logits(m, h_last)
            if sampling and g == 0:
                u[0] = self._draws(gen, b, logits.shape[-1])
            return sample_logits(logits, cfg,
                                 uniform=u[0][rows(g)] if sampling else None)

        def first(g, h_last):
            tok = sample(g, h_last)
            out[rows(g), 0] = tok
            if eos is not None:
                done[rows(g)] = tok == eos
            return [tok]

        tok_tab = torch.zeros(b, dtype=torch.int64, device=dev)
        for g, (tok,) in self._prefill(prompt, caches, rows, allowed, first):
            tok_tab[rows(g)] = tok

        T = new - 1
        h_in = torch.empty((rpg, 1, m.cfg.d_model), dtype=cd, device=dev)
        wrap = self._wrap_like(rpg)
        for c in range(n * T + n - 1 if T else 0):
            raw = c - s
            send = None
            if 0 <= raw < n * T:
                g, t = raw % n, raw // n
                pos = p + t
                h = (m.embed_at(tok_tab[rows(g)][:, None], pos) if s == 0
                     else h_in)
                h = self._run_blocks(h, caches, rows(g), pos,
                                     allowed[pos:pos + 1])
                if s == n - 1:
                    tok = sample(g, h[:, 0])
                    if eos is not None:
                        # a finished row emits pad from the step after its
                        # EOS, and pad is what its next step embeds
                        tok = torch.where(done[rows(g)], cfg.pad_token_id,
                                          tok)
                        done[rows(g)] |= tok == eos
                    out[rows(g), t + 1] = tok
                    send = [tok]
                else:
                    send = [h]
            recv = wrap if s == 0 else [h_in]
            if self._shift(c, T, send, recv, _TAG_DECODE) and s == 0:
                tok_tab[rows((c - (n - 1)) % n)] = wrap[0]
        return self._from_last(out if s == n - 1 else None)

    def _generate_beam(self, prompt: torch.Tensor):
        """Beam search over the ring: sum-of-log-probs scoring, the parents
        riding the ring with the activations (``pipe_tpu``'s
        ``_device_program_beam``), each stage's cache rows of a group
        reordered by them before the group's next step. Returns ``(tokens
        [b, max_new], scores [b])`` of each row's best beam."""
        m, cfg = self.model, self.gen_cfg
        n, s = self.n_stages, self.stage
        k, new = cfg.num_beams, cfg.max_new_tokens
        b, p = prompt.shape
        rpg = b // n
        total = p + new
        dev = self.device
        cd = m.cfg.compute_dtype
        allowed = causal_table(total, dev)
        caches = [blk.attn.make_cache(b, total, dtype=cd)
                  for blk in self.blocks]

        def rows(g):
            return slice(g * rpg, (g + 1) * rpg)

        def beams(g):
            return slice(g * rpg * k, (g + 1) * rpg * k)

        out = torch.zeros((b, k, new), dtype=torch.int64, device=dev)
        scores = torch.zeros((b, k), dtype=torch.float32, device=dev)

        def first(g, h_last):
            logp = torch.log_softmax(head_logits(m, h_last), dim=-1)
            sc, tok = torch.topk(logp, k, dim=-1)                # [rpg, k]
            scores[rows(g)] = sc
            out[rows(g), :, 0] = tok
            flat = tok.reshape(-1)
            return [flat, torch.zeros_like(flat)]

        tok_tab = torch.zeros(b * k, dtype=torch.int64, device=dev)
        par_tab = torch.zeros(b * k, dtype=torch.int64, device=dev)
        for g, (tok, _) in self._prefill(prompt, caches, rows, allowed,
                                         first):
            tok_tab[beams(g)] = tok
        # tile the caches rpg -> rpg*k per group (flat = row*k + beam)
        caches = [{name: c.repeat_interleave(k, dim=0)
                   for name, c in cache.items()} for cache in caches]
        ident = torch.arange(rpg * k, device=dev) % k
        base = (torch.arange(rpg * k, device=dev) // k) * k

        T = new - 1
        h_in = torch.empty((rpg * k, 1, m.cfg.d_model), dtype=cd, device=dev)
        par_in = torch.zeros(rpg * k, dtype=torch.int64, device=dev)
        wrap = self._wrap_like(rpg)
        for c in range(n * T + n - 1 if T else 0):
            raw = c - s
            send = None
            if 0 <= raw < n * T:
                g, t = raw % n, raw // n
                pos = p + t
                if t == 0:
                    parent = ident
                else:
                    parent = par_tab[beams(g)] if s == 0 else par_in
                flat_parent = base + parent
                for cache in caches:
                    for cbuf in cache.values():
                        slab = cbuf[beams(g)]
                        slab.copy_(slab.index_select(0, flat_parent))
                h = (m.embed_at(tok_tab[beams(g)][:, None], pos) if s == 0
                     else h_in)
                h = self._run_blocks(h, caches, beams(g), pos,
                                     allowed[pos:pos + 1])
                if s == n - 1:
                    logp = torch.log_softmax(head_logits(m, h[:, 0]), dim=-1)
                    vocab = logp.shape[-1]
                    tot = scores[rows(g)][:, :, None] + logp.reshape(
                        rpg, k, vocab)
                    sc, idx = torch.topk(tot.reshape(rpg, k * vocab), k,
                                         dim=-1)
                    par_new, tok_new = idx // vocab, idx % vocab
                    scores[rows(g)] = sc
                    og = torch.take_along_dim(out[rows(g)],
                                              par_new[:, :, None], dim=1)
                    og[:, :, t + 1] = tok_new
                    out[rows(g)] = og
                    send = [tok_new.reshape(-1), par_new.reshape(-1)]
                else:
                    send = [h, parent.clone()]
            recv = wrap if s == 0 else [h_in, par_in]
            if self._shift(c, T, send, recv, _TAG_DECODE) and s == 0:
                g_in = (c - (n - 1)) % n
                tok_tab[beams(g_in)] = wrap[0]
                par_tab[beams(g_in)] = wrap[1]
        best_tok = best_sc = None
        if s == n - 1:
            best = torch.argmax(scores, dim=1)
            pick = torch.arange(b, device=dev)
            best_tok, best_sc = out[pick, best], scores[pick, best]
        return (self._from_last(best_tok), self._from_last(best_sc))

    def _from_last(self, t: Optional[torch.Tensor]) -> torch.Tensor:
        """Stage n-1's result on every rank of the pipeline."""
        return self.mesh.broadcast_from(t, self.n_stages - 1)

    # --- public ---

    def generate(self, prompt, *, seed: int = 0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """``[b, max_new_tokens]`` int64 continuations of ``prompt [b,
        prompt_len]``; rows ``[g*rpg, (g+1)*rpg)`` form ring group ``g``.
        Sampling draws on stage n-1 from ``generator`` (on its device), or
        from a new one seeded with ``seed``. ``num_beams > 1`` runs
        ring-pipelined beam search (deterministic; no draws)."""
        if self.gen_cfg.num_beams > 1:
            return self.generate_with_scores(prompt)[0]
        prompt = self._check(prompt)
        b, p = prompt.shape
        self._count_program(("greedy", p, b // self.n_stages))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._generate(prompt, generator)
        self._observe("serve.pipelined.generate_sec", b, t0)
        return out

    def generate_with_lengths(self, prompt, *, seed: int = 0,
                              generator: Optional[torch.Generator] = None):
        """``(tokens [b, max_new], lengths [b])``: lengths run up to and
        including the first EOS (or ``max_new_tokens`` without one)."""
        out = self.generate(prompt, seed=seed, generator=generator)
        return out, sequence_lengths(out, self.gen_cfg.eos_token_id)

    def generate_with_scores(self, prompt):
        """Ring-pipelined beam search: ``(tokens [b, max_new], scores
        [b])``, each row's best beam and its total log-probability, the
        one-device ``Generator.generate_with_scores`` contract."""
        if self.gen_cfg.num_beams < 2:
            raise ValueError("generate_with_scores requires num_beams >= 2")
        prompt = self._check(prompt)
        b, p = prompt.shape
        self._count_program(("beam", p, b // self.n_stages))
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._generate_beam(prompt)
        self._observe("serve.pipelined.beam_sec", b, t0)
        return out
