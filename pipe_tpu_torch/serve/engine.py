"""Slot-based continuous batching: a dynamic request stream through ONE
decode step, captured once in a CUDA graph on the card.

Counterpart of the single-device slab path of ``pipe_tpu/serve/engine.py``.
The engine owns ``S`` decode slots, each a row of every layer's KV cache
plus a (token, position, seed, draw step) quadruple on the device. A host
**tick** is:

1. reap requests that died waiting (deadline/cancel) and retire running
   slots whose deadline passed or that were cancelled;
2. admit waiting requests into free slots — a prefill per prompt-length
   bucket (:class:`~.buckets.BucketSpec`) writes the slot's cache rows and
   samples the first token (TTFT is measured here);
3. run the **one** decode step for all S slots — finished/empty slots
   decode garbage into rows the next prefill overwrites — and retire slots
   on EOS / per-request ``max_new_tokens``.

Where ``pipe_tpu`` compiles the decode step once (``jax.jit``), the port
captures it once in a ``torch.cuda.CUDAGraph`` on the card and replays it
every tick: the host writes the static input buffers (token, position,
seed, step) with ``copy_`` at prefill and reads the ``[S, K]`` token output
back. The capture increments ``serve.engine.decode_traces``;
``tests/test_torch_serve.py`` and ``chip_smoke.py`` hold it at 1 across
staggered mixed-length traffic, the port's form of ``pipe_tpu``'s
zero-recompile pin. A capture or replay error raises: there is no eager
fallback on the card. On the CPU the same step runs eagerly (the first run
counts as its trace), as ``jax.jit`` on the CPU runs the compiled program.
``cuda_graph=False`` runs it eagerly on the card too: the reference the
graph is held to.

Token equality: a slot's tokens do not depend on what the other slots do.
Positions are per row (``MultiHeadAttention.decode`` with a position
tensor; a dead slot's position is clamped to the cache, with no host
check), and sampled draws are keyed by (request seed, step, vocab index)
(:func:`~..inference.generate.keyed_uniform`), not drawn from a stream. S
slots run as S-row GEMMs, which need not give batch-1 bits, so greedy
tokens equal a one-shot batch-1 ``Generator`` wherever the logits' top-2
margin is wider than rounding (the margin-gated law of the generator's
tests).

``decode_chunk > 1`` runs K decode steps per tick inside the one step (one
host round trip per K tokens). A slot finishing mid-chunk wastes at most
K-1 slot-steps before the host sees it.

Prefill runs eagerly, one prompt at a time. Not ported yet, each refused
with ``NotImplementedError`` naming its ROADMAP.md item: the paged KV pool
(``kv_block_size``, ``kv_dtype``, ``kv_offload``), the resident loop
(``resident=True``), the speculative lane (``spec_tokens``, ``draft``), the
watchdog, chaos and disaggregated phases, and the fleet's KV handoff.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..inference.generate import (GenerationConfig, head_logits,
                                  keyed_uniform, sample_logits, seed_word)
from ..obs.events import NULL_EVENT_LOG, REQUEST
from ..obs.telemetry import get_registry, host_overhead_per_token
from ..ops.layers import causal_table
from .buckets import BucketSpec
from .queue import QueueFull, Request, RequestQueue, Response

__all__ = ["SingleDeviceSlotBackend", "ServeEngine", "EngineDraining"]

_PAGED = "A.6, serve/kvpool.py: the paged KV pool"
_RESIDENT = "A.6, the resident loop"
_SPEC = "A.6, inference/draft.py and the speculative lane"
_FLEET = "A.7, fleet handoff"

# (argument, its default, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("kv_block_size", None, _PAGED),
    ("kv_pool_blocks", None, _PAGED),
    ("prefill_chunk", 16, _PAGED),
    ("kv_dtype", None, _PAGED),
    ("kv_offload", False, _PAGED),
    ("kv_offload_blocks", None, _PAGED),
    ("resident_chunks", 8, _RESIDENT),
    ("spec_tokens", None, _SPEC),
    ("draft", "ngram", _SPEC),
    ("draft_stages", 1, _SPEC),
    ("spec_branches", None, _SPEC),
    ("spec_adaptive", False, _SPEC),
)


class EngineDraining(RuntimeError):
    """Raised by ``submit`` after :meth:`ServeEngine.drain`: the engine
    is finishing its live slots and admits nothing new (the graceful-
    shutdown signal — see ``apps/serve.py``'s SIGTERM handler)."""


class _Slot:
    """Host-side state of one running request."""

    __slots__ = ("req", "tokens", "ttft")

    def __init__(self, req: Request, first_token: int, ttft: float):
        self.req = req
        self.tokens: List[int] = [first_token]
        self.ttft = ttft


class SingleDeviceSlotBackend:
    """S decode slots over one device's weights: the model's own (an int8
    :func:`~..inference.quant.quantize_params` copy serves int8 weights),
    on the model's device. The KV memory is one slab per layer,
    ``[S, max_len, heads, head_dim]`` in the compute dtype.
    """

    def __init__(self, model, *, num_slots: int, max_len: int,
                 gen: GenerationConfig = GenerationConfig(),
                 buckets: Optional[BucketSpec] = None,
                 decode_chunk: int = 1, shape_cache_warn: int = 8,
                 kv_block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 prefill_chunk: int = 16,
                 kv_dtype: Optional[str] = None,
                 kv_offload: bool = False,
                 kv_offload_blocks: Optional[int] = None,
                 resident="auto", resident_chunks: int = 8,
                 spec_tokens: Optional[int] = None,
                 draft="ngram", draft_stages: int = 1,
                 spec_branches: Optional[int] = None,
                 spec_adaptive: bool = False,
                 cuda_graph: bool = True):
        args = locals()
        if not hasattr(model, "embed_at"):
            raise TypeError(
                f"{type(model).__name__} has no embed_at; KV-cache "
                "generation needs position-offset embedding")
        for name, default, item in _NOT_PORTED:
            if args[name] != default:
                raise NotImplementedError(
                    f"SingleDeviceSlotBackend({name}={args[name]!r}) is not "
                    f"ported to pipe_tpu_torch yet (ROADMAP.md {item})")
        if gen.kv_block_size is not None:
            raise NotImplementedError(
                f"GenerationConfig.kv_block_size is not ported to "
                f"pipe_tpu_torch yet (ROADMAP.md {_PAGED})")
        if gen.spec_tokens is not None:
            raise NotImplementedError(
                f"GenerationConfig.spec_tokens is not ported to "
                f"pipe_tpu_torch yet (ROADMAP.md {_SPEC})")
        if resident not in ("auto", True, False):
            raise ValueError(
                f"resident must be 'auto', True or False, got {resident!r}")
        if resident is True:
            raise NotImplementedError(
                f"resident=True is not ported to pipe_tpu_torch yet "
                f"(ROADMAP.md {_RESIDENT}); 'auto' serves one chunk a tick")
        if gen.num_beams != 1:
            raise ValueError(
                "the serve engine decodes greedy/sampled slots; beam "
                "search has no incremental slot form (num_beams must be 1)")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1, got {decode_chunk}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.model = model
        self.gen = gen
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = buckets
        self.decode_chunk = decode_chunk
        self.decode_width = decode_chunk
        self.shape_cache_warn = shape_cache_warn
        self.paged = False
        self.pool = None
        self.resident = False
        self.device = next(model.parameters()).device
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"

        dev = self.device
        cd = model.cfg.compute_dtype
        with torch.no_grad():
            caches = [blk.attn.make_cache(num_slots, max_len, dtype=cd)
                      for blk in model.blocks]
        ids = dict(dtype=torch.int64, device=dev)
        # The decode step's static buffers: what the captured graph reads
        # and writes. Host writes go through copy_/index writes into them.
        self._state = {
            "caches": caches,
            "table": causal_table(max_len, dev),
            "tok": torch.zeros(num_slots, **ids),
            "pos": torch.zeros(num_slots, **ids),
            "seed": torch.zeros(num_slots, **ids),
            "step": torch.zeros(num_slots, **ids),
            "out": torch.zeros((num_slots, decode_chunk), **ids),
        }
        self._prefill_shapes = set()
        self._decode_ready = False
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    # -- validation --------------------------------------------------------

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        """Admission-control shape checks — reject at submit, not at
        prefill, so a bad request never costs a slot. A live slot's last
        decode writes row ``prompt_len + max_new_tokens - 2``, inside the
        cache."""
        bucket = (self.buckets.bucket_for(prompt_len)
                  if self.buckets is not None else prompt_len)
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds the slot cache "
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
        if limit is not None and max(bucket,
                                     prompt_len + max_new_tokens) > limit:
            raise ValueError(
                f"request needs position {max(bucket, prompt_len + max_new_tokens)} "
                f"but the positional table has {limit}")

    # -- device work -------------------------------------------------------

    def _draws(self, seed: torch.Tensor, step: torch.Tensor,
               vocab: int) -> Optional[torch.Tensor]:
        if self.gen.temperature == 0.0:
            return None
        return keyed_uniform(seed, step, vocab)

    def _prefill_slot(self, slot: int, padded: List[int], p: int,
                      seed: int) -> torch.Tensor:
        """The bucket-length prefill: the right-padded prompt through every
        block's ``decode`` into the slot's slab, zeroed first (the previous
        occupant's rows are gone, not merely masked), then the first token
        from the logits at the true last position (draw step 0)."""
        m, st = self.model, self._state
        x = torch.tensor([padded], dtype=torch.int64, device=self.device)
        h = m.embed_at(x, 0)                               # [1, B, d]
        allowed = st["table"][:len(padded)]
        for blk, cache in zip(m.blocks, st["caches"]):
            rows = {name: c[slot:slot + 1] for name, c in cache.items()}
            for c in rows.values():
                c.zero_()
            h, _ = blk.decode(h, rows, 0, allowed=allowed)
        logits = head_logits(m, h[:, p - 1])              # [1, V]
        word = torch.tensor([seed_word(seed)], dtype=torch.int64,
                            device=self.device)
        tok = sample_logits(
            logits, self.gen,
            uniform=self._draws(word, torch.zeros_like(word),
                                logits.shape[-1]))
        st["tok"][slot] = tok[0]
        st["pos"][slot] = p
        st["seed"][slot] = word[0]
        st["step"][slot] = 1
        return tok[0]

    def _decode_body(self, st: dict) -> None:
        """THE decode step: ``decode_chunk`` tokens for all S slots, on the
        buffers of ``st`` in place. Reads nothing back to the host, so it
        can be captured: positions gather the mask rows and the positional
        table, K/V rows are written by index, EOS masking is a ``where``.
        A slot's position stops at the cache's last row (a dead slot
        decodes garbage there; a live one never gets that far)."""
        m, gen = self.model, self.gen
        eos = gen.eos_token_id
        tok, pos = st["tok"], st["pos"]
        done = None if eos is None else tok == eos
        for k in range(self.decode_chunk):
            allowed = st["table"][pos][:, None]           # [S, 1, max_len]
            h = m.embed_at(tok[:, None], pos)             # [S, 1, d]
            for blk, cache in zip(m.blocks, st["caches"]):
                h, _ = blk.decode(h, cache, pos, allowed=allowed)
            logits = head_logits(m, h[:, 0])             # [S, V]
            nxt = sample_logits(
                logits, gen,
                uniform=self._draws(st["seed"], st["step"],
                                    logits.shape[-1]))
            if done is not None:
                # a finished slot emits pad from the step after its EOS
                nxt = torch.where(done, gen.pad_token_id, nxt)
                done = done | (nxt == eos)
            st["out"][:, k].copy_(nxt)
            tok.copy_(nxt)
            pos.add_(1).clamp_(max=self.max_len - 1)
            st["step"].add_(1)

    def _capture(self) -> None:
        """Capture the decode step into a CUDA graph. The warm-up run that
        capture needs (cuBLAS handles, the allocator) goes to a copy of
        the state on a side stream, so the live slots are not touched;
        capture itself runs nothing."""
        st = self._state
        scratch = dict(st, caches=[{n: c.clone() for n, c in cache.items()}
                                   for cache in st["caches"]],
                       **{n: st[n].clone()
                          for n in ("tok", "pos", "seed", "step", "out")})
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_body(scratch)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._decode_body(st)
        self._graph = graph

    # -- backend API -------------------------------------------------------

    def prefill(self, slot: int, prompt: Sequence[int], seed: int,
                max_new_tokens: Optional[int] = None) -> int:
        """Fill slot ``slot``'s cache rows from ``prompt`` and return the
        first sampled token. Blocking — the returned int IS the TTFT
        moment. One shape per prompt-length bucket, counted as
        ``pipe_tpu`` counts its per-bucket programs. ``max_new_tokens``
        is accepted for the paged pool's reservation; the slab ignores
        it."""
        reg = get_registry()
        if self.buckets is not None:
            padded, p = self.buckets.pad(prompt, self.gen.pad_token_id)
        else:
            padded, p = list(prompt), len(prompt)
        B = len(padded)
        if B not in self._prefill_shapes:
            self._prefill_shapes.add(B)
            reg.counter("serve.engine.prefill_traces").inc()
            reg.counter("serve.engine.prefill_program_misses").inc()
            reg.gauge("serve.engine.prefill_programs").set(
                len(self._prefill_shapes))
            if self.buckets is None and \
                    len(self._prefill_shapes) == self.shape_cache_warn + 1:
                warnings.warn(
                    f"serve engine prefilled {len(self._prefill_shapes)} "
                    f"distinct prompt shapes with bucketing DISABLED — "
                    f"every new prompt length is a new shape. Pass a "
                    f"BucketSpec to cap them.", RuntimeWarning,
                    stacklevel=3)
        else:
            reg.counter("serve.engine.prefill_program_hits").inc()
        with torch.no_grad():
            return int(self._prefill_slot(slot, padded, p, seed))

    def decode(self, live: np.ndarray):
        """One decode chunk for all slots. Returns ``(tokens [S, K],
        valid [S, K])`` — dead slots compute garbage (their rows are
        rewritten at the next prefill); ``valid`` masks them out."""
        with torch.no_grad():
            if not self._decode_ready:
                get_registry().counter("serve.engine.decode_traces").inc()
                if self.cuda_graph:
                    self._capture()
                self._decode_ready = True
            if self._graph is not None:
                self._graph.replay()
            else:
                self._decode_body(self._state)
            toks = self._state["out"].cpu().numpy()
        valid = np.broadcast_to(
            np.asarray(live, bool)[:, None], toks.shape)
        return toks, valid

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        """Block-availability admission gate: always True for the slab —
        its reservation is the slot itself."""
        return True

    def release(self, slot: int) -> None:
        """Engine retirement hook: a no-op for the slab — the next prefill
        rewrites the rows."""

    def program_stats(self) -> dict:
        return {"prefill_programs": len(self._prefill_shapes),
                "decode_chunk": self.decode_chunk, "kv": "slab",
                "decode_graph": self._graph is not None}

    def export_prefix_payload(self, prompt: Sequence[int],
                              codec: str = "int8") -> Optional[dict]:
        raise NotImplementedError(
            f"export_prefix_payload is not ported to pipe_tpu_torch yet "
            f"(ROADMAP.md {_FLEET})")

    def import_prefix_payload(self, payload: dict) -> int:
        raise NotImplementedError(
            f"import_prefix_payload is not ported to pipe_tpu_torch yet "
            f"(ROADMAP.md {_FLEET})")


class ServeEngine:
    """The continuous-batching scheduler over a slot backend.

    ``backend`` is a :class:`SingleDeviceSlotBackend`; the engine itself is
    pure host-side bookkeeping (single-threaded tick loop — call ``tick``
    from one thread). ``queue`` defaults to a fresh bounded
    :class:`~.queue.RequestQueue`; pass your own to share a front door or
    to inject a test clock.

    A backend exception is contained, never fatal: a failed prefill retires
    only the offending request (``status="error"``, the slot goes back to
    the free list, ``resilience.slot_errors`` counts it); a failed decode
    skips the tick with all slot state intact, and only after
    ``decode_error_limit`` consecutive failures are the live slots retired
    as errors (batched decode cannot attribute the fault to one slot).
    ``watchdog``, ``chaos`` and the disaggregated ``phase`` values are not
    ported yet (ROADMAP.md A.7) and raise ``NotImplementedError``.
    """

    def __init__(self, backend, queue: Optional[RequestQueue] = None,
                 *, event_log=None,
                 clock: Optional[Callable[[], float]] = None,
                 watchdog=None, chaos=None, decode_error_limit: int = 3,
                 phase: str = "mixed"):
        if phase not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"phase must be 'mixed', 'prefill' or 'decode', got "
                f"{phase!r}")
        for name, value, default in (("watchdog", watchdog, None),
                                     ("chaos", chaos, None),
                                     ("phase", phase, "mixed")):
            if value != default:
                raise NotImplementedError(
                    f"ServeEngine({name}={value!r}) is not ported to "
                    f"pipe_tpu_torch yet (ROADMAP.md A.7, resilience/* "
                    f"and fleet/*)")
        self.phase = phase
        self.backend = backend
        if queue is None:
            queue = RequestQueue(clock=clock or time.monotonic)
        elif clock is not None and clock is not queue.clock:
            raise ValueError(
                "pass the clock on the queue (engine adopts queue.clock)")
        if decode_error_limit < 1:
            raise ValueError(
                f"decode_error_limit must be >= 1, got {decode_error_limit}")
        self.queue = queue
        self.clock = queue.clock
        self.events = event_log if event_log is not None else NULL_EVENT_LOG
        self.decode_error_limit = decode_error_limit
        self._slots: List[Optional[_Slot]] = [None] * backend.num_slots
        self._free = list(range(backend.num_slots - 1, -1, -1))
        self._responses = {}
        self._tick_index = 0
        self._decode_errors = 0
        self._draining = False

    # -- front door --------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None, seed: int = 0,
               priority: int = 0,
               timeout_s: Optional[float] = None) -> Request:
        """Validate + enqueue. Raises ``ValueError`` on an unservable
        request (too long for the buckets/cache/positions) and
        :class:`~.queue.QueueFull` under backpressure."""
        reg = get_registry()
        if self._draining:
            raise EngineDraining(
                "engine is draining: live requests are finishing and no "
                "new work is admitted")
        if max_new_tokens is None:
            max_new_tokens = self.backend.gen.max_new_tokens
        self.backend.validate(len(prompt), max_new_tokens)
        try:
            req = self.queue.submit(prompt, max_new_tokens=max_new_tokens,
                                    seed=seed, priority=priority,
                                    timeout_s=timeout_s)
        except QueueFull:
            reg.counter("serve.engine.rejected").inc()
            raise
        reg.counter("serve.engine.submitted").inc()
        reg.gauge("serve.engine.queue_depth").set(self.queue.depth)
        return req

    def place(self, req: Request) -> Request:
        """Router placement: admit an EXISTING :class:`~.queue.Request`
        into this engine's queue, preserving its id, arrival and
        deadline (no new deadline credit) and counting the placement in
        ``req.attempts``. Raises like ``submit``
        (:class:`EngineDraining`, ``ValueError``,
        :class:`~.queue.QueueFull`)."""
        reg = get_registry()
        if self._draining:
            raise EngineDraining(
                "engine is draining: live requests are finishing and no "
                "new work is admitted")
        self.backend.validate(len(req.prompt), req.max_new_tokens)
        self.queue.requeue(req)
        req.attempts += 1
        reg.counter("serve.engine.placed").inc()
        reg.gauge("serve.engine.queue_depth").set(self.queue.depth)
        return req

    def cancel(self, request_id: int) -> bool:
        return self.queue.cancel(request_id)

    def response(self, request_id: int) -> Optional[Response]:
        return self._responses.get(request_id)

    @property
    def live_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def idle(self) -> bool:
        return self.live_slots == 0 and self.queue.depth == 0

    # -- graceful drain ------------------------------------------------------

    def drain(self) -> None:
        """Enter graceful shutdown: ``submit`` starts raising
        :class:`EngineDraining`, the next tick sheds everything still
        queued (``status="shed"``, ``finish_reason="drain"``), and live
        slots run to completion. Idempotent."""
        if not self._draining:
            self._draining = True
            self.events.event("resilience", action="drain",
                              live=self.live_slots, queued=self.queue.depth)

    def evict_queued(self) -> List[Request]:
        """Remove and return this engine's queued requests INTACT — no
        terminal record, no status change — so a router can re-place
        them on another replica. Live slots are untouched. Contrast
        :meth:`drain`, which sheds queued work terminally
        (``finish_reason="drain"``)."""
        evicted = self.queue.evict_all()
        if evicted:
            reg = get_registry()
            reg.counter("serve.engine.evicted").inc(len(evicted))
            reg.gauge("serve.engine.queue_depth").set(self.queue.depth)
            self.events.event("resilience", action="evict_queued",
                              count=len(evicted))
        return evicted

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """True once a drain finished: nothing queued, nothing live."""
        return self._draining and self.idle

    # -- retirement --------------------------------------------------------

    def _record(self, resp: Response, bucket: Optional[int],
                req: Optional[Request] = None) -> None:
        self._responses[resp.request_id] = resp
        self.queue.forget(resp.request_id)
        reg = get_registry()
        reg.counter("serve.engine.retired").inc()
        reg.histogram("serve.engine.e2e_sec").observe(resp.latency)
        if resp.status == "timeout":
            reg.counter("serve.engine.timed_out").inc()
        elif resp.status == "cancelled":
            reg.counter("serve.engine.cancelled").inc()
        elif resp.status == "error":
            reg.counter("serve.engine.errors").inc()
        elif resp.status == "shed":
            reg.counter("serve.engine.shed").inc()
        self.events.event(
            REQUEST, request=resp.request_id, status=resp.status,
            finish_reason=resp.finish_reason, prompt_len=resp.prompt_len,
            bucket=bucket, tokens=len(resp.tokens), ttft=resp.ttft,
            latency=resp.latency, stage="terminal",
            trace=getattr(req, "trace_id", None),
            attempts=getattr(req, "attempts", 0))

    def _finish_queued(self, req: Request, reason: str,
                       now: float) -> Response:
        status = "cancelled" if reason == "cancelled" else "timeout"
        resp = Response(request_id=req.id, tokens=[], status=status,
                        finish_reason=reason, prompt_len=len(req.prompt),
                        ttft=None, latency=now - req.submitted_at)
        self._record(resp, None, req)
        return resp

    def _shed_queued(self, req: Request, reason: str,
                     now: float) -> Response:
        """Queued request pushed back out unserved (drain):
        ``status="shed"``."""
        resp = Response(request_id=req.id, tokens=[], status="shed",
                        finish_reason=reason, prompt_len=len(req.prompt),
                        ttft=None, latency=now - req.submitted_at)
        self._record(resp, None, req)
        return resp

    def _fail_queued(self, req: Request, exc: Exception,
                     now: float) -> Response:
        """Admission failed in the backend (prefill raised): the request
        dies ``status="error"`` — the slot was returned to the free list
        and every other request keeps serving."""
        get_registry().counter("resilience.slot_errors").inc()
        self.events.event("resilience", action="slot_error",
                          request=req.id, where="prefill",
                          error=type(exc).__name__)
        resp = Response(request_id=req.id, tokens=[], status="error",
                        finish_reason="backend_error",
                        prompt_len=len(req.prompt),
                        ttft=None, latency=now - req.submitted_at)
        self._record(resp, None, req)
        return resp

    def _retire(self, slot: int, status: str, reason: str,
                now: float) -> Response:
        st = self._slots[slot]
        self._slots[slot] = None
        self._free.append(slot)
        self.backend.release(slot)
        req = st.req
        bucket = (self.backend.buckets.bucket_for(len(req.prompt))
                  if self.backend.buckets is not None else len(req.prompt))
        resp = Response(request_id=req.id, tokens=list(st.tokens),
                        status=status, finish_reason=reason,
                        prompt_len=len(req.prompt), ttft=st.ttft,
                        latency=now - req.submitted_at)
        self._record(resp, bucket, req)
        return resp

    # -- the tick ----------------------------------------------------------

    def tick(self) -> List[Response]:
        """One scheduler step: sweep deadlines/cancellations, admit into
        free slots, run one decode chunk, retire. Returns the requests
        that reached a terminal state during this tick."""
        reg = get_registry()
        tick_idx = self._tick_index
        self._tick_index += 1
        t_start = self.clock()
        now = t_start
        finished: List[Response] = []
        eos = self.backend.gen.eos_token_id

        # 0) drain — everything still queued goes back to its caller
        if self._draining and self.queue.depth:
            for req in self.queue.shed_lowest(self.queue.depth):
                finished.append(self._shed_queued(req, "drain", now))

        # 1) deaths — queued first (never cost a slot), then running
        for req, reason in self.queue.reap(now):
            finished.append(self._finish_queued(req, reason, now))
        for slot in range(self.backend.num_slots):
            st = self._slots[slot]
            if st is None:
                continue
            if st.req.cancelled:
                finished.append(
                    self._retire(slot, "cancelled", "cancelled", now))
            elif st.req.deadline is not None and now >= st.req.deadline:
                finished.append(
                    self._retire(slot, "timeout", "deadline", now))

        # 2) admissions — prefill straight into the freed slots; a
        # backend failure here is attributable to ONE request: fail it,
        # free the slot, keep admitting. The scan asks the backend whether
        # each request can seat now (always, for the slab); a parked head
        # keeps its place while the next request in pop order may go.
        device_sec = 0.0                    # prefill + decode launches
        head_blocked_counted = False
        while self._free and not self._draining:
            candidates = self.queue.admission_order()
            if not candidates:
                break
            req = None
            for cand in candidates:
                if self.backend.can_admit(len(cand.prompt),
                                          cand.max_new_tokens, cand.prompt):
                    req = cand
                    break
                if cand is candidates[0] and not head_blocked_counted:
                    head_blocked_counted = True
                    reg.counter("serve.kv.admission_blocked").inc()
                    self.events.event("serve", action="admission_blocked",
                                      request=cand.id,
                                      depth=self.queue.depth)
            if req is None:
                break                       # nothing admissible: park all
            if req is not candidates[0]:
                reg.counter("serve.engine.admission_skipped").inc()
                self.events.event("serve", action="admission_skipped",
                                  request=req.id,
                                  parked=candidates[0].id,
                                  depth=self.queue.depth)
            self.queue.take(req.id)
            slot = self._free.pop()
            t_pre = self.clock()
            try:
                tok0 = self.backend.prefill(
                    slot, req.prompt, req.seed,
                    max_new_tokens=req.max_new_tokens)
            except Exception as e:           # noqa: BLE001 — containment
                self._free.append(slot)
                finished.append(self._fail_queued(req, e, self.clock()))
                continue
            device_sec += self.clock() - t_pre
            t_first = self.clock()
            st = _Slot(req, tok0, ttft=t_first - req.submitted_at)
            self._slots[slot] = st
            reg.counter("serve.engine.admitted").inc()
            reg.histogram("serve.engine.ttft_sec").observe(st.ttft)
            self.events.event(REQUEST, request=req.id, stage="prefill",
                              trace=req.trace_id, slot=slot, ttft=st.ttft,
                              attempts=req.attempts,
                              prompt_len=len(req.prompt))
            if eos is not None and tok0 == eos:
                finished.append(self._retire(slot, "ok", "eos", t_first))
            elif req.max_new_tokens == 1:
                finished.append(self._retire(slot, "ok", "length", t_first))

        # 3) decode — one fixed-shape chunk for every slot. A failure is
        # NOT attributable (all slots share the step): skip the tick with
        # slot state intact, and only a run of consecutive failures
        # retires the live set.
        live = np.array([s is not None for s in self._slots])
        if live.any():
            t0 = self.clock()
            try:
                reg.counter("serve.engine.host_syncs").inc()
                toks, valid = self.backend.decode(live)
            except Exception as e:           # noqa: BLE001 — containment
                self._on_decode_error(reg, e, tick_idx, finished)
            else:
                self._decode_errors = 0
                t1 = self.clock()
                device_sec += t1 - t0
                emitted = 0
                for slot in range(self.backend.num_slots):
                    st = self._slots[slot]
                    if st is None:
                        continue
                    for k in range(toks.shape[1]):
                        if not valid[slot, k]:
                            continue
                        t = int(toks[slot, k])
                        st.tokens.append(t)
                        emitted += 1
                        if eos is not None and t == eos:
                            finished.append(
                                self._retire(slot, "ok", "eos", t1))
                            break
                        if len(st.tokens) >= st.req.max_new_tokens:
                            finished.append(
                                self._retire(slot, "ok", "length", t1))
                            break
                if emitted:
                    reg.counter("serve.engine.tokens").inc(emitted)
                    reg.histogram("serve.engine.token_sec").observe(
                        (t1 - t0) / emitted)

        reg.gauge("serve.engine.queue_depth").set(self.queue.depth)
        reg.gauge("serve.engine.slot_occupancy").set(
            self.live_slots / self.backend.num_slots)
        dur = self.clock() - t_start
        # everything in the tick that was NOT a device call (prefill or
        # decode) is host overhead
        reg.timer("serve.engine.host_sec").observe(
            max(dur - device_sec, 0.0))
        reg.gauge("serve.engine.host_overhead_per_token").set(
            host_overhead_per_token(reg))
        reg.gauge("resilience.tick_sec").set(dur)
        return finished

    def _on_decode_error(self, reg, exc: Exception, tick_idx: int,
                         finished: List[Response]) -> None:
        self._decode_errors += 1
        reg.counter("resilience.decode_errors").inc()
        self.events.event("resilience", action="decode_error",
                          tick=tick_idx, consecutive=self._decode_errors,
                          error=type(exc).__name__)
        if self._decode_errors < self.decode_error_limit:
            return                           # skip the tick; state intact
        now = self.clock()
        for slot in range(self.backend.num_slots):
            if self._slots[slot] is not None:
                reg.counter("resilience.slot_errors").inc()
                finished.append(
                    self._retire(slot, "error", "backend_error", now))
        self._decode_errors = 0

    # -- convenience loops -------------------------------------------------

    def run_until_idle(self, max_ticks: int = 1_000_000) -> List[Response]:
        """Tick until every queued/running request retired."""
        finished: List[Response] = []
        for _ in range(max_ticks):
            if self.idle:
                return finished
            finished.extend(self.tick())
        raise RuntimeError(
            f"engine not idle after {max_ticks} ticks "
            f"(live={self.live_slots}, queued={self.queue.depth})")

    def serve(self, prompts: Sequence[Sequence[int]], *,
              max_new_tokens: Optional[int] = None,
              seeds: Optional[Sequence[int]] = None) -> List[Response]:
        """Batch convenience: submit all, drain, return responses in
        submit order. Oversubscription beyond queue capacity is drained
        incrementally (submit waits on ticks, not on QueueFull)."""
        ids = {}
        i = 0
        while i < len(prompts) or not self.idle:
            while i < len(prompts):
                try:
                    req = self.submit(
                        prompts[i], max_new_tokens=max_new_tokens,
                        seed=seeds[i] if seeds is not None else 0)
                except QueueFull:
                    break
                ids[i] = req.id
                i += 1
            self.tick()
        return [self._responses[ids[j]] for j in range(len(prompts))]
