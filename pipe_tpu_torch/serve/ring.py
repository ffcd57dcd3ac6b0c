"""Continuous batching over the stage ring: slots = ring groups.

Counterpart of ``pipe_tpu/serve/ring.py``.
:class:`~..inference.pipelined.PipelinedGenerator` keeps every stage busy
by chasing ``n_stages`` request groups round the ring, but decodes one
fixed batch to completion. This backend keeps the ring continuously full:
each of the ``n_stages`` slots is a ring group (one request) that is
retired and re-admitted on its own, mid-flight, without touching the other
groups' in-flight state.

The decode carries the ring across ticks. One tick is ``revolutions *
n_stages`` cycles of the generator's wavefront (stage ``s`` at cycle ``c``
works group ``(c - s) mod n``) over a global cycle counter ``c0``; what is
in flight between ticks (the activation each stage received last, the
token on the wrap edge, each stage's per-group positions) stays where it
is. Admission is a table write: prefill walks the new prompt through the
stages (one serial ring pass, writing cache rows ``[0, p)``), stage n-1
samples the first token and sends it over the wrap edge, and every rank
arms ``admit[g] = c0 + g``, the cycle at which stage 0 next meets group
``g``. Stage ``s`` treats group ``g`` as valid from ``admit[g] + s`` on, so
the new request's wavefront threads between the live groups'.

Host-driven, one process per stage (``parallel/mesh.py``). ``pipe_tpu`` has
one controller; here the ranks must agree on every call, and the engine's
decisions read wall clocks (deadlines, the watchdog), so the ranks cannot
each decide for themselves. The rank of stage 0 drives: a
:class:`~.engine.ServeEngine` runs there over this backend, and each
``prefill``, ``decode`` and ``release`` first broadcasts a tick plan of
int64 words (:meth:`Mesh.broadcast_plan`) that the other ranks' follower
loop (:meth:`RingSlotBackend.follow`) runs on the same backend;
:meth:`RingSlotBackend.close` ends it. Every rank keeps the same host
tables (``c0``, ``admit``, the paged pool's ``KvPool``, which needs no ring
awareness: one table entry addresses the same block id in every stage's
shard). A cycle is valid on stage ``s`` when the group is live, not done
and its wavefront has reached the stage; a rank skips invalid cycles on the
host instead of writing into a sacrificial region, and a hop carries a
message exactly when its sender's cycle was valid, which every rank
evaluates from the same tables (:meth:`Mesh.ring_shift`). Tokens reach the
driver on a broadcast from stage n-1 at the end of each call (each
revolution, in the resident loop, whose ``done`` must be replicated, as
``pipe_tpu`` psums it).

Sampled draws are the serve engine's keyed draws (C.6): stage n-1 draws
``keyed_uniform(seed, step)`` for the request's seed and its step, so a
ring-served stream equals the one-device engine's, sampled too.

Modes, each ``pipe_tpu``'s: **slab** KV (one ``[n_groups, max_len]`` slab
per layer of the stage) prefilled per bucket; **paged** KV (``kv_block_size``:
each stage holds pool rows for its own layers, prefilled in fixed chunks,
copy-on-write forks); the **resident** loop (``resident_revolutions``
revolutions a launch with a replicated done mask, early exit when a live
group goes done, the engine's deadline horizon as ``r_max``); and the
**speculative** lane (``spec_tokens=K``, resident only): stage 0 drafts
(n-gram from the group's history, or the truncated draft over stage 0's
own layers and the tied embedding) and injects a ``K``-row chunk, the
middle stages run their layers on it, stage n-1 verifies (the keyed draws
at ``step .. step + K - 1``), accepts the matching prefix plus one
correction, and its verdict rides the wrap edge back to stage 0, which
applies it before the group's next injection. Refused as ``pipe_tpu``
refuses them: beams, tree drafts, ``spec_adaptive``, int8 KV and host
offload on the ring pool, spec without the resident loop. The decode
attention is plain: the ring launches no kernel.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..inference.draft import DraftSource, resolve_draft
from ..inference.generate import (GenerationConfig, head_logits,
                                  keyed_uniform, sample_logits, seed_word)
from ..inference.pipelined import stage_blocks
from ..obs.telemetry import get_registry
from ..ops.layers import causal_table
from .buckets import BucketSpec
from .engine import resolve_resident
from .kvpool import (KvPool, copy_block, flat_row_index, gather_block_cache,
                     scatter_block_rows, storage_for)

__all__ = ["RingSlotBackend", "drive_ring"]

_REBASE = 1 << 20   # keep the cycle counter far from overflow

# the tick plan's first word
_STOP, _PREFILL, _DECODE, _RESIDENT, _RELEASE = range(5)
# ring_shift tags per message kind (a message of k tensors takes tag..tag+k)
_TAG_PREFILL, _TAG_DECODE, _TAG_SPEC = 300, 400, 500


class RingSlotBackend:
    """``n_stages`` decode slots riding the stage ring, one request per
    group. ``mesh`` is this rank's mesh; ``model`` a ``PipelinedTransformer``
    LM of which this rank reads only its stage
    (:func:`~..inference.pipelined.stage_modules`): the weights where they
    lie. Every rank of the pipeline builds it with the same arguments; the
    rank of stage 0 drives (``ServeEngine`` over it), the others run
    :meth:`follow`."""

    def __init__(self, mesh, model, *, max_len: int,
                 gen: GenerationConfig = GenerationConfig(),
                 buckets: Optional[BucketSpec] = None,
                 revolutions: int = 1, shape_cache_warn: int = 8,
                 kv_block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 prefill_chunk: int = 16,
                 kv_dtype: Optional[str] = None,
                 kv_offload: bool = False,
                 kv_offload_blocks: Optional[int] = None,
                 resident="auto", resident_revolutions: int = 8,
                 spec_tokens: Optional[int] = None,
                 draft="ngram", draft_stages: int = 1,
                 spec_branches: Optional[int] = None,
                 spec_adaptive: bool = False):
        if not hasattr(model, "embed_at"):
            raise TypeError(
                f"{type(model).__name__} has no embed_at; KV-cache "
                "generation needs position-offset embedding")
        if gen.num_beams != 1:
            raise ValueError(
                "the serve engine decodes greedy/sampled slots; beam "
                "search has no incremental slot form (num_beams must be 1)")
        if revolutions < 1:
            raise ValueError(
                f"revolutions must be >= 1, got {revolutions}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.mesh = mesh
        self.model = model
        self.gen = gen
        self.buckets = buckets
        self.max_len = max_len
        self.n = n = mesh.n_stages
        self.stage = mesh.stage
        self.num_slots = n
        self.decode_chunk = revolutions   # tokens per slot per tick
        self.shape_cache_warn = shape_cache_warn
        self.blocks = stage_blocks(model, self.stage, n)
        self._lps = lps = len(self.blocks)
        self.device = next(self.blocks[0].parameters()).device
        if resident not in ("auto", True, False):
            raise ValueError(
                f"resident must be 'auto', True or False, got {resident!r}")
        self.resident = resolve_resident(resident, self.device)
        if resident_revolutions < 1:
            raise ValueError(
                f"resident_revolutions must be >= 1, got "
                f"{resident_revolutions}")
        self.resident_revolutions = resident_revolutions
        # the engine's deadline horizon speaks in "resident chunks"; for
        # the ring one chunk is one revolution
        self.resident_chunks = resident_revolutions
        spec = spec_tokens if spec_tokens is not None else gen.spec_tokens
        if spec is not None and spec < 2:
            raise ValueError(f"spec_tokens must be >= 2, got {spec}")
        if spec is not None and not self.resident:
            raise ValueError(
                "spec_tokens needs the resident loop (the draft/verify "
                "wavefront IS the resident revolution); pass "
                "resident=True")
        self.spec_tokens = spec
        # resident readout stride: 1 token per revolution, or a K-token
        # row per spec round
        self.decode_width = spec if spec is not None else 1
        if spec is not None:
            self._drafter = draft if isinstance(draft, DraftSource) \
                else resolve_draft(
                    draft, n_stages=n, layers_per_stage=lps,
                    draft_stages=draft_stages,
                    spec_branches=spec_branches)
            if self._drafter.branches > 1:
                raise ValueError(
                    "tree draft is single-device only: the ring verify "
                    "chunk is the linear K-row wavefront message (pick "
                    "draft='ngram' or 'truncated')")
            if self._drafter.name == "truncated" and draft_stages != 1:
                raise ValueError(
                    f"ring truncated draft needs draft_stages=1 (only "
                    f"stage 0's layers are resident where the draft "
                    f"runs), got {draft_stages}")
            if spec_adaptive:
                raise ValueError(
                    "spec_adaptive is single-device only: the ring's "
                    "in-flight wavefront carry is K-shaped, so a rung "
                    "switch would orphan every in-flight round")
            self._spec_overshoot = spec - 1
            self._spec_acc_total = 0
            self._spec_draft_total = 0
        else:
            if not (draft == "ngram" and draft_stages == 1
                    and spec_branches is None and not spec_adaptive):
                raise ValueError(
                    "draft/draft_stages/spec_branches/spec_adaptive "
                    "configure the speculative lane; set "
                    "gen.spec_tokens")
            self._drafter = None
            self._spec_overshoot = 0

        m, dev = model, self.device
        cd = m.cfg.compute_dtype
        ids = dict(dtype=torch.int64, device=dev)
        kbs = kv_block_size if kv_block_size is not None \
            else gen.kv_block_size
        self.paged = kbs is not None
        with torch.no_grad():
            proto = self.blocks[0].attn.make_cache(1, max_len, dtype=cd)
        if self.paged:
            # paged KV over the ring: every stage holds the pool rows for
            # ITS layers ([lps, num_blocks, bs, ...] per rank). The block
            # table is layer- and stage-agnostic -- one table entry
            # addresses the same physical block id in each shard -- so the
            # host-side KvPool needs no ring awareness at all.
            if kv_dtype is not None:
                raise NotImplementedError(
                    "int8 KV blocks are single-device only for now; the "
                    "ring pool stores the compute dtype")
            if kv_offload:
                raise NotImplementedError(
                    "kv_offload is single-device only for now: spilling "
                    "a block means a host read of every stage's shard "
                    "of it, which the ring's sharded pool layout does "
                    "not expose yet")
            if buckets is not None:
                gen.check_kv_headroom(buckets.max_len, kbs,
                                      self._spec_overshoot)
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            self.prefill_chunk = prefill_chunk
            mb = -(-max_len // kbs)
            nb = kv_pool_blocks if kv_pool_blocks is not None \
                else n * mb + 1
            self.pool = KvPool(
                num_blocks=nb, block_size=kbs, num_slots=n,
                max_len=max_len, prefix_cache=gen.prefix_cache,
                gather_slack_rows=prefill_chunk)
            self._pool_kv = storage_for(proto, lps, nb, kbs)
            self._tables = torch.zeros((n, self.pool.table_width), **ids)
            # decode views span the slot's reserved blocks (the one-device
            # engine's view width); a prefill chunk's the whole table row
            self._rows = self.pool.max_blocks * kbs
            ext = (self.pool.table_width - 1) * kbs
            self._table_ext = causal_table(ext, dev)
        else:
            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype needs the paged pool (set kv_block_size); "
                    "the slab path stores KV in the compute dtype")
            if kv_offload:
                raise ValueError(
                    "kv_offload needs the paged pool (set kv_block_size); "
                    "the slab path has no block-level eviction to spill")
            self.pool = None
            self._rows = max_len
            self._slab = [blk.attn.make_cache(n, max_len, dtype=cd)
                          for blk in self.blocks]
        self.kv_offload = False
        self._table = causal_table(self._rows, dev)

        # host tables, the same on every rank (the admission and cycle
        # counters) or this stage's own (positions; stage n-1's draw
        # seeds and steps; stage 0's inject tokens, spec tokens, history)
        self._c0 = 0
        self._admit = np.zeros(n, np.int64)
        self._tok_inject = np.zeros(n, np.int64)
        self._pos = np.zeros(n, np.int64)
        self._seed = np.zeros(n, np.int64)
        self._step = np.zeros(n, np.int64)
        d = m.cfg.d_model
        # the carry in flight between calls: what this stage received last
        # (an activation, or on stage 0 the wrap edge's token or verdict)
        if spec is None:
            self._h_in = torch.zeros((1, 1, d), dtype=cd, device=dev)
            self._tok_ring = torch.zeros(1, **ids)
        else:
            self._tok = np.zeros(n, np.int64)
            self._hist = np.full((n, max_len + spec), gen.pad_token_id,
                                 np.int64)
            self._h_in = torch.zeros((1, spec, d), dtype=cd, device=dev)
            self._ints_in = torch.zeros(2 + spec, dtype=torch.int64)
            self._comp_in = torch.zeros(2 + spec, dtype=torch.int64)
            self._comp_ok = False
        self._plan_len = 5 + max(max_len, 2 * n)
        # decode calls and the cycles they ran (cycles per tick)
        self.decode_calls = 0
        self.cycles_run = 0
        self._closed = False
        self._seen = set()

    # -- roles -------------------------------------------------------------

    @property
    def is_driver(self) -> bool:
        """The rank of stage 0 drives the ring (the engine runs there)."""
        return self.stage == 0

    def _tell(self, words) -> None:
        if not self.is_driver:
            raise RuntimeError(
                "only the rank of stage 0 drives the ring backend; the "
                "others run follow()")
        if self._closed:
            raise RuntimeError("the ring backend is closed")
        self.mesh.broadcast_plan(np.asarray(words, np.int64),
                                 self._plan_len)

    def follow(self) -> int:
        """A follower rank's loop: run each tick plan the driver broadcasts
        until it closes the ring. Returns the number of plans run."""
        if self.is_driver:
            raise RuntimeError("stage 0 drives the ring; follow() is for "
                               "the other ranks")
        n, count = self.n, 0
        while True:
            w = self.mesh.broadcast_plan(None, self._plan_len)
            op = int(w[0])
            if op == _STOP:
                self._closed = True
                return count
            count += 1
            with torch.no_grad():
                if op == _PREFILL:
                    slot, word, max_new, plen = (int(v) for v in w[1:5])
                    prompt = [int(v) for v in w[5:5 + plen]]
                    adm = (self.pool.admit(slot, prompt, max_new,
                                           chunk=self.prefill_chunk)
                           if self.paged else None)
                    self._prefill(slot, prompt, word, adm)
                elif op == _DECODE:
                    self._decode(w[1:1 + n] != 0)
                elif op == _RESIDENT:
                    r_max = int(w[1])
                    self._resident(w[2:2 + n] != 0, w[2 + n:2 + 2 * n],
                                   r_max)
                elif op == _RELEASE:
                    self._release(int(w[1]))
                else:
                    raise RuntimeError(f"unknown ring plan op {op}")

    def close(self) -> None:
        """The driver ends the followers' loops (idempotent)."""
        if self.is_driver and not self._closed:
            self.mesh.broadcast_plan(np.asarray([_STOP], np.int64),
                                     self._plan_len)
            self._closed = True

    # -- validation --------------------------------------------------------

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        bucket = (self.buckets.bucket_for(prompt_len)
                  if self.buckets is not None and not self.paged
                  else prompt_len)
        if self.paged and self.pool.demand_for(
                prompt_len, max_new_tokens) > self.pool.allocatable:
            raise ValueError(
                f"request needs "
                f"{self.pool.demand_for(prompt_len, max_new_tokens)} KV "
                f"blocks but the whole pool holds "
                f"{self.pool.allocatable}; raise kv_pool_blocks or "
                f"shorten the request")
        if prompt_len + max_new_tokens + self._spec_overshoot \
                > self.max_len:
            extra = (f" + speculative headroom {self._spec_overshoot}"
                     if self._spec_overshoot else "")
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens "
                f"{max_new_tokens}{extra} exceeds the slot cache "
                f"({self.max_len} rows); raise max_len or shorten the "
                f"request")
        if bucket > self.max_len:
            raise ValueError(
                f"prompt bucket {bucket} exceeds the slot cache "
                f"({self.max_len} rows); raise max_len")
        if max_new_tokens > self.gen.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the engine cap "
                f"({self.gen.max_new_tokens})")
        mp = getattr(self.model, "max_position", None)
        limit = mp() if callable(mp) else None
        need = max(bucket, prompt_len + max_new_tokens
                   + max(self.decode_chunk - 1, self._spec_overshoot))
        if limit is not None and need > limit:
            raise ValueError(
                f"request needs position {need} but the positional "
                f"table has {limit}")

    # -- shared pieces -----------------------------------------------------

    def _first(self, key: str) -> bool:
        """True the first time ``key`` runs on this backend: ``pipe_tpu``
        counts a trace there, eager PyTorch its first run."""
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    def _views(self, g: int) -> List[dict]:
        """Per-layer caches of group ``g`` that this stage's blocks decode
        on: views into its slab rows, or its block rows gathered from the
        pool through its table row."""
        if not self.paged:
            return [{k: c[g:g + 1] for k, c in cache.items()}
                    for cache in self._slab]
        trow = self._tables[g, :self.pool.max_blocks + 1]
        cd = self.model.cfg.compute_dtype
        return [gather_block_cache({k: a[l] for k, a in self._pool_kv.items()},
                                   trow, block_size=self.pool.block_size,
                                   compute_dtype=cd)
                for l in range(self._lps)]

    def _run(self, h: torch.Tensor, views: List[dict], pos: int
             ) -> torch.Tensor:
        """This stage's blocks on ``h [1, q, d]`` at positions ``[pos, pos +
        q)``, clamped into the views (a finished group overshooting in a
        tick writes its last rows, as the one-device engine clamps)."""
        q = h.shape[1]
        p = min(pos, self._rows - q)
        allowed = self._table[p:p + q]
        for blk, cache in zip(self.blocks, views):
            h, _ = blk.decode(h, cache, p, allowed=allowed)
        return h

    def _writeback(self, g: int, views: List[dict], pos: int, q: int
                   ) -> None:
        """Paged: the ``q`` rows the views got at ``pos`` back into the
        pool through the group's full table row (positions past its
        reserved blocks, and a released group's every row, land in the
        sacrificial block). A no-op for the slab, written in place."""
        if not self.paged:
            return
        p = min(pos, self._rows - q)
        positions = torch.arange(pos, pos + q, device=self.device)
        ridx = flat_row_index(self._tables[g], positions,
                              self.pool.block_size)
        for l, cache in enumerate(views):
            scatter_block_rows({k: a[l] for k, a in self._pool_kv.items()},
                               ridx, {k: cache[k][0, p:p + q]
                                      for k in ("k", "v")})

    def _sample(self, logits: torch.Tensor, g: int, steps) -> torch.Tensor:
        """Stage n-1's picks for group ``g`` from ``logits [q, V]``: the
        keyed draws of its request's seed at ``steps`` (one per row)."""
        u = None
        if self.gen.temperature != 0.0:
            st = torch.as_tensor(np.asarray(steps, np.int64),
                                 device=self.device)
            seeds = torch.full_like(st, int(self._seed[g]))
            u = keyed_uniform(seeds, st, logits.shape[-1])
        return sample_logits(logits, self.gen, uniform=u)

    def _valid(self, s: int, c: int, live, done) -> bool:
        g = (c - s) % self.n
        return bool(live[g]) and not bool(done[g]) \
            and c >= self._admit[g] + s

    def _advance(self, cycles: int) -> None:
        self.decode_calls += 1
        self.cycles_run += cycles
        self._c0 += cycles
        if self._c0 > _REBASE:
            shift = self._c0
            self._c0 = 0
            self._admit = np.maximum(self._admit - shift, -_REBASE)

    # -- prefill -------------------------------------------------------------

    def prefill(self, slot: int, prompt: Sequence[int], seed: int,
                max_new_tokens: Optional[int] = None) -> int:
        """Fill group ``slot``'s KV rows on every stage from ``prompt`` and
        return the first sampled token (it arrives on the wrap edge). The
        in-flight decode carry is untouched: live groups never notice an
        admission. Paged: the pool admission runs here first (a refusal
        raises before any rank moves), then on the followers."""
        max_new = (max_new_tokens if max_new_tokens is not None
                   else self.gen.max_new_tokens)
        word = seed_word(seed)
        prompt = [int(t) for t in prompt]
        adm = (self.pool.admit(slot, prompt, max_new,
                               chunk=self.prefill_chunk)
               if self.paged else None)
        try:
            self._tell([_PREFILL, slot, word, max_new, len(prompt)]
                       + prompt)
        except Exception:
            if adm is not None:
                self.pool.release(slot, failed=True)
            raise
        with torch.no_grad():
            return self._prefill(slot, prompt, word, adm)

    def _prefill(self, slot: int, prompt: List[int], word: int, adm
                 ) -> Optional[int]:
        n, s = self.n, self.stage
        self._seed[slot] = word
        try:
            h_last = (self._prefill_paged(slot, prompt, adm) if self.paged
                      else self._prefill_slab(slot, prompt))
            tok = torch.zeros(1, dtype=torch.int64, device=self.device)
            send = None
            if s == n - 1:
                tok = self._sample(head_logits(self.model, h_last), slot,
                                   [0])
                send = [tok]
            if n > 1:       # the first token over the wrap edge to stage 0
                self.mesh.ring_shift(send, [tok] if s == 0 else None,
                                     tag=_TAG_PREFILL)
        except Exception:
            if adm is not None:
                self.pool.release(slot, failed=True)
            raise
        plen = len(prompt)
        self._admit[slot] = self._c0 + slot
        self._pos[slot] = plen
        self._step[slot] = 1
        if self.paged:
            self._tables[slot].copy_(torch.from_numpy(
                adm.table.astype(np.int64)))
        if s != 0:
            return None
        tok0 = int(tok[0])
        self._tok_inject[slot] = tok0
        if self.spec_tokens is not None:
            self._tok[slot] = tok0
            row = np.full(self._hist.shape[1], self.gen.pad_token_id,
                          np.int64)
            row[:plen] = prompt
            row[plen] = tok0
            self._hist[slot] = row
        return tok0

    def _hop_in(self, shape) -> Optional[torch.Tensor]:
        """The activation the previous stage sends on a serial pass."""
        if self.stage == 0:
            return None
        h = torch.empty(shape, dtype=self.model.cfg.compute_dtype,
                        device=self.device)
        self.mesh.ring_shift(None, [h], tag=_TAG_PREFILL)
        return h

    def _hop_out(self, h: torch.Tensor) -> None:
        if self.stage != self.n - 1:
            self.mesh.ring_shift([h], None, tag=_TAG_PREFILL)

    def _prefill_slab(self, slot: int, prompt: List[int]) -> torch.Tensor:
        """One serial ring pass of the bucket-padded prompt: each stage runs
        its layers on fresh rows of the group's slab (the previous
        occupant's rows are gone, not merely masked). Returns stage n-1's
        hidden state at the true last position."""
        reg = get_registry()
        if self.buckets is not None:
            padded, p = self.buckets.pad(prompt, self.gen.pad_token_id)
        else:
            padded, p = list(prompt), len(prompt)
        B = len(padded)
        if self._first(f"prefill{B}"):
            reg.counter("serve.ring.prefill_traces").inc()
            reg.counter("serve.engine.prefill_program_misses").inc()
            n_pre = sum(1 for k in self._seen if k.startswith("prefill"))
            reg.gauge("serve.engine.prefill_programs").set(n_pre)
            if self.buckets is None and n_pre == self.shape_cache_warn + 1 \
                    and self.is_driver:
                warnings.warn(
                    f"ring serve backend prefilled {n_pre} distinct prompt "
                    f"shapes with bucketing DISABLED -- every new prompt "
                    f"length is a new shape. Pass a BucketSpec to cap "
                    f"them.", RuntimeWarning, stacklevel=4)
        else:
            reg.counter("serve.engine.prefill_program_hits").inc()
        m = self.model
        h = self._hop_in((1, B, m.cfg.d_model))
        if h is None:
            h = m.embed_at(torch.tensor([padded], dtype=torch.int64,
                                        device=self.device), 0)
        allowed = self._table[:B]
        for blk, cache in zip(self.blocks, self._slab):
            rows = {k: torch.zeros_like(c[:1]) for k, c in cache.items()}
            h, _ = blk.decode(h, rows, 0, allowed=allowed)
            for k, c in cache.items():
                c[slot].copy_(rows[k][0])
        self._hop_out(h)
        return h[0, p - 1:p]

    def _prefill_paged(self, slot: int, prompt: List[int], adm
                       ) -> torch.Tensor:
        """Run the admission's COW forks on this stage's shard, then stream
        the prompt's recompute tail through fixed ``[1, C]`` chunks, each
        walked round the ring once: every layer attends over the slot's
        gathered rows (earlier chunks' included) and scatters its C new
        rows back through the table row. Returns stage n-1's hidden state
        at the true last position (in the last chunk)."""
        reg = get_registry()
        if adm.cow_forks and self._first("fork"):
            reg.counter("serve.kv.fork_traces").inc()
        for src, dst in adm.cow_forks:
            copy_block(self._pool_kv, src, dst)
        if self._first("chunk"):
            reg.counter("serve.ring.prefill_chunk_traces").inc()
        m = self.model
        cd = m.cfg.compute_dtype
        bs, C = self.pool.block_size, self.prefill_chunk
        plen = len(prompt)
        trow = torch.from_numpy(adm.table.astype(np.int64)).to(self.device)
        pad = self.gen.pad_token_id
        h_last = None
        for t0 in range(adm.resume_from, plen, C):
            h = self._hop_in((1, C, m.cfg.d_model))
            if h is None:
                toks = prompt[t0:t0 + C]
                toks = toks + [pad] * (C - len(toks))
                h = m.embed_at(torch.tensor([toks], dtype=torch.int64,
                                            device=self.device), t0)
            positions = torch.arange(t0, t0 + C, device=self.device)
            ridx = flat_row_index(trow, positions, bs)
            allowed = self._table_ext[t0:t0 + C]
            for l, blk in enumerate(self.blocks):
                pool_l = {k: a[l] for k, a in self._pool_kv.items()}
                cache = gather_block_cache(pool_l, trow, block_size=bs,
                                           compute_dtype=cd)
                h, c2 = blk.decode(h, cache, t0, allowed=allowed)
                scatter_block_rows(pool_l, ridx, {
                    k: c2[k][0, t0:t0 + C] for k in ("k", "v")})
            self._hop_out(h)
            idx = min(max(plen - 1 - t0, 0), C - 1)
            h_last = h[0, idx:idx + 1]
        return h_last

    # -- decode ------------------------------------------------------------

    def decode(self, live: np.ndarray,
               budgets: Optional[np.ndarray] = None,
               r_max: Optional[int] = None):
        """One tick = ``revolutions`` tokens per live slot. Returns
        ``(tokens [S, R], valid [S, R])``; validity accounts for admission
        wavefronts still filling the ring.

        With ``budgets`` on a resident backend the call runs the RESIDENT
        loop: up to ``r_max`` revolutions with a replicated done mask and
        early exit. Without ``budgets`` the single-launch path runs even
        when ``resident=True``: the parity reference. Speculative slots
        are resident-only, so spec mode requires ``budgets``."""
        if self.spec_tokens is not None and budgets is None:
            raise ValueError(
                "ring speculative decode is resident-only: pass "
                "budgets so the K-token wavefront can done-mask on "
                "device")
        live = np.asarray(live).astype(bool)
        n = self.n
        if self.resident and budgets is not None:
            R = self.resident_revolutions
            rm = R if r_max is None else max(1, min(int(r_max), R))
            budgets = np.asarray(budgets, np.int64)
            self._tell([_RESIDENT, rm] + live.astype(np.int64).tolist()
                       + budgets.tolist())
            with torch.no_grad():
                return self._resident(live, budgets, rm)
        self._tell([_DECODE] + live.astype(np.int64).tolist())
        with torch.no_grad():
            return self._decode(live)

    def _cycle(self, c: int, live, done) -> Optional[tuple]:
        """One decode cycle on this stage (q = 1): group ``(c - s) mod n``
        if valid here, then the hop. Stage n-1 returns ``(group, token)``
        for a token it sampled, every other case None."""
        n, s = self.n, self.stage
        g = (c - s) % n
        send, got = None, None
        if self._valid(s, c, live, done):
            pos = int(self._pos[g])
            views = self._views(g)
            if s == 0:
                if c == self._admit[g]:
                    tok = torch.tensor([int(self._tok_inject[g])],
                                       device=self.device)
                else:
                    tok = self._tok_ring
                h = self.model.embed_at(tok[:, None], pos)
            else:
                h = self._h_in
            h = self._run(h, views, pos)
            self._writeback(g, views, pos, 1)
            self._pos[g] = pos + 1
            if s == n - 1:
                tok = self._sample(head_logits(self.model, h[:, 0]), g,
                                   [int(self._step[g])])
                self._step[g] += 1
                got = (g, tok)
                send = [tok]
            else:
                send = [h]
        recv = [self._tok_ring] if s == 0 else [self._h_in]
        prev_ok = self._valid((s - 1) % n, c, live, done)
        self.mesh.ring_shift(send, recv if prev_ok else None,
                             tag=_TAG_DECODE)
        return got

    def _gather_last(self, values: Optional[np.ndarray], size: int
                     ) -> np.ndarray:
        """Stage n-1's int64 words on every rank of the pipeline."""
        return self.mesh.broadcast_plan(values, size, stage=self.n - 1)

    def _decode(self, live):
        reg = get_registry()
        if self._first("decode"):
            reg.counter("serve.ring.decode_traces").inc()
        n, R, s = self.n, self.decode_chunk, self.stage
        none = np.zeros(n, bool)
        toks = torch.zeros((n, R), dtype=torch.int64, device=self.device)
        flags = np.zeros((n, R), np.int64)
        for i in range(n * R):
            got = self._cycle(self._c0 + i, live, none)
            if got is not None:
                g, tok = got
                toks[g, i // n] = tok[0]
                flags[g, i // n] = 1
        mine = (np.concatenate([toks.cpu().numpy().reshape(-1),
                                flags.reshape(-1)])
                if s == n - 1 else None)
        words = self._gather_last(mine, 2 * n * R)
        self._advance(n * R)
        return (words[:n * R].reshape(n, R),
                words[n * R:].reshape(n, R).astype(bool))

    def _resident(self, live, budget, r_max: int):
        """One resident launch: up to ``r_max`` revolutions of the
        wavefront, each ending in a broadcast of stage n-1's tokens and
        emission flags so every rank advances the same ``done`` and
        budget (``pipe_tpu`` psums them); exits early when any live group
        goes done. Done groups freeze: their cycles are invalid."""
        if self.spec_tokens is not None:
            return self._resident_spec(live, budget, r_max)
        reg = get_registry()
        if self._first("resident"):
            reg.counter("serve.ring.resident_traces").inc()
        n, s, R = self.n, self.stage, self.resident_revolutions
        eos = self.gen.eos_token_id
        budget = np.array(budget, np.int64)
        done = ~live | (budget <= 0)
        toks = np.zeros((n, R), np.int64)
        flags = np.zeros((n, R), bool)
        r = 0
        while r < r_max and not (live & done).any():
            rev_tok = torch.zeros(n, dtype=torch.int64, device=self.device)
            rev_emit = np.zeros(n, np.int64)
            for j in range(n):
                got = self._cycle(self._c0 + r * n + j, live, done)
                if got is not None:
                    rev_tok[got[0]] = got[1][0]
                    rev_emit[got[0]] = 1
            mine = (np.concatenate([rev_tok.cpu().numpy(), rev_emit])
                    if s == n - 1 else None)
            words = self._gather_last(mine, 2 * n)
            rt, re_ = words[:n], words[n:]
            toks[:, r], flags[:, r] = rt, re_ > 0
            budget -= re_
            done = done | (budget <= 0)
            if eos is not None:
                done = done | ((rt == eos) & (re_ > 0))
            r += 1
        if r < r_max and self.is_driver:
            reg.counter("serve.engine.device_exits").inc()
        self._advance(n * r)
        return toks[:, :r], flags[:, :r] & live[:, None]

    # -- the speculative lane ----------------------------------------------

    def _draft(self, g: int, views: List[dict]) -> List[int]:
        """Stage 0's ``K - 1`` draft tokens for group ``g``: the n-gram
        lookup in its history, or a greedy roll of stage 0's own layers
        (the model's strict prefix) with the tied-embedding head, whose
        K/V rows at ``pos .. pos + K - 2`` the verify chunk rewrites."""
        K = self.spec_tokens
        tok, pos = int(self._tok[g]), int(self._pos[g])
        if self._drafter.name == "ngram":
            row = self._hist[g]
            H = row.shape[0]
            hit = np.nonzero((row == tok) & (np.arange(H) < pos))[0]
            start = min(int(hit[-1]) + 1 if hit.size else 0, H - (K - 1))
            return row[start:start + K - 1].tolist()
        m = self.model
        table = m.embed.weight.to(torch.float32)
        cur, outs = tok, []
        for i in range(K - 1):
            h = m.embed_at(torch.tensor([[cur]], device=self.device),
                           pos + i)
            h = self._run(h, views, pos + i)
            cur = int(torch.argmax(h[0, 0].to(torch.float32) @ table.T))
            outs.append(cur)
        return outs

    def _spec_cycle(self, c: int, live, done, done_now, budget,
                    rev_tok, rev_emit) -> None:
        """One spec cycle on this stage (module docstring): stage 0 applies
        the verdict the wrap edge delivered and injects the group's next
        K-row chunk, the middle stages run it, stage n-1 verifies and sends
        the verdict. A message's int words: chunk ``(valid, pos0, x[K])``,
        verdict ``(valid, n_emit, t[K])``."""
        n, s, K = self.n, self.stage, self.spec_tokens
        eos = self.gen.eos_token_id
        m = self.model
        g = (c - s) % n
        valid = self._valid(s, c, live, done)
        h = None
        ints = None
        if s == 0 and self._comp_ok and int(self._comp_in[0]) \
                and live[g] and not done[g] and c - n >= self._admit[g]:
            # the verdict for the round injected n cycles ago (a verdict
            # still in flight for a retired or re-admitted group is stale)
            napp = int(self._comp_in[1])
            tseq = self._comp_in[2:2 + K].numpy().copy()
            pos = int(self._pos[g])
            self._tok[g] = tseq[napp - 1]
            self._hist[g, pos + 1:pos + 1 + napp] = tseq[:napp]
            self._pos[g] = pos + napp
            rev_tok[g], rev_emit[g] = tseq, napp
            if budget[g] - napp <= 0 or (
                    eos is not None and (tseq[:napp] == eos).any()):
                done_now[g] = True
        if valid and s == 0:
            ints = torch.zeros(2 + K, dtype=torch.int64)
            if not done_now[g]:
                pos = int(self._pos[g])
                views = self._views(g)
                x = [int(self._tok[g])] + self._draft(g, views)
                h = self._run(m.embed_at(torch.tensor(
                    [x], device=self.device), pos), views, pos)
                self._writeback(g, views, pos, K)
                ints[0], ints[1] = 1, pos
                ints[2:] = torch.tensor(x)
            else:
                h = torch.zeros_like(self._h_in)
        elif valid:
            ints = self._ints_in.clone()
            h = self._h_in
            if int(ints[0]):
                pos = int(ints[1])
                views = self._views(g)
                h = self._run(h, views, pos)
                self._writeback(g, views, pos, K)
        send = None
        if valid and s == n - 1:
            comp = torch.zeros(2 + K, dtype=torch.int64)
            if int(ints[0]):
                logits = head_logits(m, h[0])                   # [K, V]
                st = int(self._step[g])
                t = self._sample(logits, g, range(st, st + K)).cpu()
                x = ints[2:]
                lead = torch.cumprod((x[1:] == t[:K - 1]).long(), dim=0)
                ne = 1 + int(lead.sum())
                self._step[g] = st + ne
                comp[0], comp[1] = 1, ne
                comp[2:] = t
            send = [comp]
        elif valid:
            send = [h, ints]
        prev_ok = self._valid((s - 1) % n, c, live, done)
        recv = [self._comp_in] if s == 0 else [self._h_in, self._ints_in]
        self.mesh.ring_shift(send, recv if prev_ok else None, tag=_TAG_SPEC)
        if s == 0:
            self._comp_ok = prev_ok

    def _resident_spec(self, live, budget, r_max: int):
        """The resident spec launch: one draft/verify round per group per
        revolution, pipelined as the K-row wavefront; stage 0 records each
        applied verdict and broadcasts the revolution's tokens and accepted
        counts, so every rank advances ``done`` and budgets alike. The
        readout is ``[S, r*K]`` tokens valid where the round's count
        covers them."""
        reg = get_registry()
        if self._first("resident"):
            reg.counter("serve.ring.resident_traces").inc()
        n, s, R, K = self.n, self.stage, self.resident_revolutions, \
            self.spec_tokens
        eos = self.gen.eos_token_id
        budget = np.array(budget, np.int64)
        done = ~live | (budget <= 0)
        toks = np.full((n, R * K), self.gen.pad_token_id, np.int64)
        counts = np.zeros((n, R), np.int64)
        ar = np.arange(K)
        r = 0
        while r < r_max and not (live & done).any():
            rev_tok = np.zeros((n, K), np.int64)
            rev_emit = np.zeros(n, np.int64)
            done_now = done.copy()
            for j in range(n):
                self._spec_cycle(self._c0 + r * n + j, live, done, done_now,
                                 budget, rev_tok, rev_emit)
            mine = (np.concatenate([rev_tok.reshape(-1), rev_emit])
                    if s == 0 else None)
            words = self.mesh.broadcast_plan(mine, n * K + n, stage=0)
            rt, re_ = words[:n * K].reshape(n, K), words[n * K:]
            toks[:, r * K:(r + 1) * K] = rt
            counts[:, r] = re_
            budget -= re_
            done = done | (budget <= 0)
            if eos is not None:
                done = done | ((rt == eos) & (ar[None] < re_[:, None])).any(1)
            r += 1
        self._advance(n * r)
        counts, toks = counts[:, :r], toks[:, :r * K]
        valid = (ar[None, None, :] < counts[:, :, None]).reshape(n, r * K)
        valid &= live[:, None]
        if self.is_driver:
            if r < r_max:
                reg.counter("serve.engine.device_exits").inc()
            self._spec_telemetry(reg, live, counts)
        return toks, valid

    def _spec_telemetry(self, reg, live, counts) -> None:
        """``pipe_tpu``'s spec surface (no EWMA: the ring has no adaptive
        ladder)."""
        K = self.spec_tokens
        lc = counts[live]
        rounds = int((lc > 0).sum())
        emitted_n = int(lc.sum())
        reg.counter("serve.engine.spec_rounds").inc(rounds)
        reg.counter("serve.engine.spec_emitted").inc(emitted_n)
        self._spec_acc_total += max(emitted_n - rounds, 0)
        self._spec_draft_total += rounds * (K - 1)
        if self._spec_draft_total:
            reg.gauge("serve.spec.acceptance_rate").set(
                self._spec_acc_total / self._spec_draft_total)
        reg.gauge("serve.spec.draft_cost_frac").set(
            self._drafter.draft_cost_frac(K, self.n * self._lps))
        hist_m = reg.histogram("serve.spec.accept_len")
        for v in lc[lc > 0]:
            hist_m.observe(float(v))

    # -- the engine's hooks ------------------------------------------------

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        """Block-availability admission gate (always True for the slab --
        its reservation is the slot itself)."""
        if not self.paged:
            return True
        return self.pool.can_admit(prompt_len, max_new_tokens, prompt,
                                   chunk=self.prefill_chunk)

    def release(self, slot: int) -> None:
        """Engine retirement hook: return the group's blocks to the pool on
        every rank and zero its table row (a no-op for the slab -- the next
        prefill rewrites the rows)."""
        if self.paged:
            self._tell([_RELEASE, slot])
            self._release(slot)

    def _release(self, slot: int) -> None:
        self.pool.release(slot)
        self._tables[slot].zero_()

    def program_stats(self) -> dict:
        if self.paged:
            return {"prefill_programs": 1,
                    "decode_chunk": self.decode_chunk, "kv": "paged"}
        return {"prefill_programs": sum(1 for k in self._seen
                                        if k.startswith("prefill")),
                "decode_chunk": self.decode_chunk, "kv": "slab"}


def drive_ring(backend: RingSlotBackend, fn):
    """Run ``fn(backend)`` on the driving rank (stage 0) and close the ring
    after it; run the follower loop on every other rank. Returns ``fn``'s
    result there, None elsewhere. Every rank of the pipeline calls it."""
    if not backend.is_driver:
        backend.follow()
        return None
    out = fn(backend)
    backend.close()
    return out
