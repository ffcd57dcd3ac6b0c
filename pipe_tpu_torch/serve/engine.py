"""Slot-based continuous batching: a dynamic request stream through fixed
device programs, each captured once in a CUDA graph on the card.

Counterpart of the single-device path of ``pipe_tpu/serve/engine.py``. The
engine owns ``S`` decode slots, each a row of every layer's KV memory plus a
(token, position, seed, draw step) quadruple on the device. A host **tick**
is:

1. reap requests that died waiting (deadline/cancel) and retire running
   slots whose deadline passed or that were cancelled;
2. admit waiting requests into free slots -- a prefill writes the slot's KV
   rows and samples the first token (TTFT is measured here);
3. run the decode program for all S slots -- finished/empty slots decode
   garbage into rows the next prefill overwrites -- and retire slots on EOS
   / per-request ``max_new_tokens``.

Where ``pipe_tpu`` compiles each program once (``jax.jit``), the port
captures it once in a ``torch.cuda.CUDAGraph`` on the card (:class:`_Program`)
and replays it: the host writes the programs' static input buffers with one
``copy_`` and reads one output buffer back. Every program's capture counts
its ``pipe_tpu`` trace counter (``serve.engine.decode_traces``,
``serve.engine.prefill_chunk_traces``, ``serve.engine.resident_traces``,
``serve.kv.fork_traces``, ``serve.kv.restore_traces``);
``tests/test_torch_serve.py``, ``tests/test_torch_kvpool.py``,
``tests/test_torch_resident.py`` and ``chip_smoke.py`` hold them at 1 across
staggered mixed-length traffic. A capture or replay error raises: there is no
eager fallback on the card. On the CPU the same functions run eagerly (the
first run counts as the trace). ``cuda_graph=False`` runs them eagerly on the
card too: the reference the graphs are held to.

KV memory is one of two layouts:

* **slab** (default): one ``[S, max_len, heads, head_dim]`` cache per layer.
  Prefill runs one program per prompt-length bucket
  (:class:`~.buckets.BucketSpec`), captured per bucket touched, as
  ``pipe_tpu`` jits one per bucket.
* **paged** (``kv_block_size``): a :class:`~.kvpool.KvPool` of blocks with
  per-slot tables, shared prompt prefixes (copy-on-write), optional host
  offload and int8 rows. Prefill is ONE fixed-shape ``[1, prefill_chunk]``
  chunk program replayed until the prompt is covered, for every prompt
  length. Decode runs on per-slot gathered views of the pool, carried across
  ticks, and scatters the chunk's new rows back through the tables. A view
  is re-gathered only when a prefill moved its slot's table: the prefill's
  epilogue refreshes that one slot (``pipe_tpu`` re-gathers every slot
  under a regather flag that the next decode program reads; a graph
  without conditional nodes could only gate that by computing it every
  launch), so decode ticks and resident launches make no gather decision.

Token equality: a slot's tokens do not depend on what the other slots do.
Positions are per row (``MultiHeadAttention.decode`` with a position tensor;
a dead slot's position is clamped to its cache), and sampled draws are keyed
by (request seed, step, vocab index)
(:func:`~..inference.generate.keyed_uniform`), not drawn from a stream. S
slots run as S-row GEMMs, which need not give batch-1 bits, so greedy tokens
equal a one-shot batch-1 ``Generator`` wherever the logits' top-2 margin is
wider than rounding (the margin-gated law of the generator's tests).

``decode_chunk > 1`` runs K decode steps per launch (one host round trip per
K tokens). A slot finishing mid-chunk wastes at most K-1 slot-steps.

**The resident loop** (``resident=True``; ``"auto"`` picks it on ``cuda``)
runs up to ``resident_chunks`` decode chunks per launch with a device-side
``done`` mask (EOS or spent token budget), and stops early when a live slot
goes done, with one host read-back per launch. ``pipe_tpu`` writes it as a
``lax.while_loop``. PyTorch 2.11 captures no conditional graph node, so the
port captures ONE graph that unrolls all ``resident_chunks`` chunks, each
gated by a device flag ``go = (k < r_max) & ~any(live & done)``: a chunk past
the stop computes but keeps ``tok/pos/step/budget/done`` as they were
(``torch.where``). That is exact, not an approximation: a frozen chunk
recomputes what the next real chunk will compute from the same state, so
its K/V writes put exactly the next real chunk's bits into the same rows.
The cost is device time on those "ghost" chunks; the
``serve.engine.resident_chunks_run`` and ``_computed`` counters show it.

**The speculative lane** (``spec_tokens=K``, resident only) makes each
gated chunk of that graph a draft/verify ROUND: a drafter
(:mod:`~..inference.draft`: n-gram history lookup, the model's first
stages, or a tree of branches) proposes K-1 tokens per slot, one
teacher-forced ``[S, Q]`` decode at the slots' positions verifies them
(``Q = K``, or ``1 + B(K-1)`` tree nodes under the tree mask), and the
longest prefix the model itself picks is emitted with one correction token.
Row r draws ``keyed_uniform(seed, step + depth[r])``, so accepted tokens are
the tick path's, sampled too. A round past the stop keeps the per-slot
state and the token history as they were, and recomputes the next real
round exactly (drafts and tree relocation included). Each rung of the
adaptive ladder is its own captured graph.

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP.md item: the watchdog, chaos and disaggregated phases, and the
fleet's KV handoff.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..inference.draft import DraftSource, resolve_draft, tree_layout
from ..inference.generate import (GenerationConfig, head_logits,
                                  keyed_uniform, sample_logits, seed_word)
from ..obs.events import NULL_EVENT_LOG, REQUEST
from ..obs.telemetry import get_registry, host_overhead_per_token
from ..ops.layers import causal_table, tree_mask
from .buckets import BucketSpec
from .kvpool import (HostKvStore, KvPool, PoolExhausted, copy_block,
                     flat_row_index, gather_block_cache, scatter_block_rows,
                     storage_for)
from .queue import QueueFull, Request, RequestQueue, Response

__all__ = ["SingleDeviceSlotBackend", "ServeEngine", "EngineDraining",
           "resolve_resident"]

_FLEET = "A.7, fleet handoff"


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


def resolve_resident(resident, device: torch.device) -> bool:
    """The resident tri-state as a backend on ``device`` runs it: the
    multi-chunk launch pays off where launch and sync overhead does, so
    ``"auto"`` is the resident loop on ``cuda`` and the single-chunk tick
    elsewhere (``pipe_tpu``: on any accelerator)."""
    if resident == "auto":
        return device.type == "cuda"
    return bool(resident)


class _Program:
    """``body(st)`` over a dict of static device buffers ``st``, run as one
    unit: captured once into a CUDA graph (into the backend's shared graph
    memory pool) and replayed per call when the backend captures, run
    eagerly otherwise. The first call counts ``counter``: the capture, or
    the eager first run. The capture's warm-up (cuBLAS handles, the
    allocator) runs ``body(scratch())`` on a side stream, where
    ``scratch()`` gives buffers whose writes cannot touch live state."""

    def __init__(self, backend, body: Callable[[dict], None], st: dict,
                 scratch: Callable[[], dict], counter: Optional[str] = None):
        self.backend = backend
        self.body = body
        self.st = st
        self.scratch = scratch
        self.counter = counter
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._ready = False

    def __call__(self) -> None:
        if not self._ready:
            if self.counter is not None:
                get_registry().counter(self.counter).inc()
            if self.backend.cuda_graph:
                self._capture()
            self._ready = True
        if self.graph is not None:
            self.graph.replay()
        else:
            self.body(self.st)

    def _capture(self) -> None:
        dev = self.backend.device
        scratch = self.scratch()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body(scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.backend._graph_pool):
            self.body(self.st)
        self.graph = graph


def _clone(st: dict, names: Sequence[str]) -> dict:
    """``st`` with fresh copies of the buffers ``names`` (tensors, or lists
    of per-layer cache dicts, or dicts of tensors)."""
    def cp(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: cp(x) for k, x in v.items()}
        return [cp(x) for x in v]
    return dict(st, **{n: cp(st[n]) for n in names})


class SingleDeviceSlotBackend:
    """S decode slots over one device's weights: the model's own (an int8
    :func:`~..inference.quant.quantize_params` copy serves int8 weights),
    on the model's device.

    KV memory is a slab per layer, ``[S, max_len, heads, head_dim]`` in the
    compute dtype, or -- with ``kv_block_size`` (or
    ``GenerationConfig.kv_block_size``) -- a paged pool of
    ``kv_pool_blocks`` blocks (default: the slab's rows plus the
    sacrificial block), prefilled in ``prefill_chunk``-row chunks, with
    ``kv_dtype="int8"`` rows and ``kv_offload`` host spill
    (``kv_offload_blocks`` caps the host store; default the pool size).
    ``resident`` (``"auto"``: True on ``cuda``) runs up to
    ``resident_chunks`` decode chunks per launch. ``spec_tokens=K`` (or
    ``GenerationConfig.spec_tokens``) makes each resident iteration a
    speculative draft/verify round emitting 1..K tokens per slot, drafted
    by ``draft`` (``"ngram"``, ``"truncated"`` over the first
    ``draft_stages`` stages, ``"tree"`` of ``spec_branches`` branches, or a
    :class:`~..inference.draft.DraftSource`); ``spec_adaptive`` picks the
    round depth per launch from a small ladder.
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
        if not hasattr(model, "embed_at"):
            raise TypeError(
                f"{type(model).__name__} has no embed_at; KV-cache "
                "generation needs position-offset embedding")
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
        if resident not in ("auto", True, False):
            raise ValueError(
                f"resident must be 'auto', True or False, got {resident!r}")
        if resident_chunks < 1:
            raise ValueError(
                f"resident_chunks must be >= 1, got {resident_chunks}")
        self.model = model
        self.gen = gen
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = buckets
        self.decode_chunk = decode_chunk
        self.shape_cache_warn = shape_cache_warn
        self.device = next(model.parameters()).device
        self.resident = resolve_resident(resident, self.device)
        self.resident_chunks = resident_chunks
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graph else None)
        self._n_layers = len(model.blocks)
        self._init_spec(spec_tokens if spec_tokens is not None
                        else gen.spec_tokens, draft, draft_stages,
                        spec_branches, spec_adaptive)

        dev = self.device
        cd = model.cfg.compute_dtype
        ids = dict(dtype=torch.int64, device=dev)
        kbs = kv_block_size if kv_block_size is not None \
            else gen.kv_block_size
        self.paged = kbs is not None
        self.kv_dtype = kv_dtype
        with torch.no_grad():
            proto = model.blocks[0].attn.make_cache(1, max_len, dtype=cd)
        if self.paged:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            self.prefill_chunk = prefill_chunk
            mb = -(-max_len // kbs)
            nb = kv_pool_blocks if kv_pool_blocks is not None \
                else num_slots * mb + 1
            if buckets is not None:
                gen.check_kv_headroom(buckets.max_len, kbs,
                                      self._spec_overshoot)
            self.pool = KvPool(
                num_blocks=nb, block_size=kbs, num_slots=num_slots,
                max_len=max_len, prefix_cache=gen.prefix_cache,
                gather_slack_rows=prefill_chunk)
            self.kv_offload = bool(kv_offload)
            if self.kv_offload:
                # host spill target for cold refcount-0 blocks: payloads are
                # raw device bytes (int8 codes + scales for int8 pools), so
                # offload -> restore is a bitwise round trip
                self.pool.attach_offload(
                    HostKvStore(max_blocks=(kv_offload_blocks
                                            if kv_offload_blocks is not None
                                            else nb)),
                    self._offload_read_block)
        else:
            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype needs the paged pool (set kv_block_size); "
                    "the slab path stores KV in the compute dtype")
            if kv_offload:
                raise ValueError(
                    "kv_offload needs the paged pool (set kv_block_size); "
                    "the slab path has no block-level eviction to spill")
            self.kv_offload = False
            self.pool = None

        # The decode programs' static buffers: what the captured graphs
        # read and write. Host writes go through copy_ into them.
        st = {
            "tok": torch.zeros(num_slots, **ids),
            "pos": torch.zeros(num_slots, **ids),
            "seed": torch.zeros(num_slots, **ids),
            "step": torch.zeros(num_slots, **ids),
            "out": torch.zeros((num_slots, decode_chunk), **ids),
        }
        if self.spec_tokens is not None:
            # the spec lane's token history: hist[s, p] = the token
            # embedded at position p of slot s; K rows of slack take the
            # masked write past the last position
            st["hist"] = torch.full(
                (num_slots, max_len + self.spec_tokens), gen.pad_token_id,
                **ids)
        with torch.no_grad():
            if self.paged:
                self._init_paged(st, proto)
            else:
                st["caches"] = [blk.attn.make_cache(num_slots, max_len,
                                                    dtype=cd)
                                for blk in model.blocks]
                st["table"] = causal_table(max_len, dev)
                # the bucket prefill's input: (true length, slot, seed
                # word, the right-padded prompt), one host copy per prefill
                st["pin"] = torch.zeros(3 + max_len, **ids)
            if self.resident:
                R, C = resident_chunks, decode_chunk
                # (live, budget, r_max) in, (tokens, chunks run) out: one
                # host copy each way per launch; spec rounds read out
                # (accepted counts [R], rounds run, tokens [R*K])
                st["rin"] = torch.zeros(2 * num_slots + 1, **ids)
                st["rout"] = torch.zeros(
                    (num_slots, R * C + 1 if self.spec_tokens is None
                     else R + 1 + R * self.spec_tokens), **ids)
            if self.spec_tokens is not None:
                self._init_spec_state(st)
        self._state = st
        self._prefill_programs: Dict[int, _Program] = {}
        scratch_names = ("caches", "tok", "pos", "seed", "step", "out")
        self._decode_prog = _Program(
            self, self._decode_paged_body if self.paged else
            self._decode_body, st,
            lambda: self._scratch(scratch_names),
            "serve.engine.decode_traces")
        if self.resident and self.spec_tokens is None:
            self._resident_prog = _Program(
                self, self._resident_body, st,
                lambda: self._scratch(scratch_names + ("rout",)),
                "serve.engine.resident_traces")
        # one resident spec program per ladder rung, each captured at its
        # first launch
        self._spec_progs = {
            K: _Program(self, lambda s, K=K: self._resident_spec_body(s, K),
                        st, lambda: self._scratch(scratch_names + ("rout",)),
                        "serve.engine.resident_traces")
            for K in self._spec_ladder}

    def _init_spec(self, spec: Optional[int], draft, draft_stages: int,
                   spec_branches: Optional[int], spec_adaptive: bool) -> None:
        """The speculative lane's knobs, validated as ``pipe_tpu`` does:
        the drafter, the verify's row overshoot, the adaptive ladder of
        round depths and its per-slot acceptance EWMA."""
        if spec is not None and spec < 2:
            raise ValueError(
                f"spec_tokens must be >= 2, got {spec}")
        if spec is not None and not self.resident:
            raise ValueError(
                "spec_tokens needs the resident loop (the draft/verify "
                "round IS the resident chunk body); pass resident=True")
        self.spec_tokens = spec
        # tokens per resident iteration: the readout stride; spec mode
        # sets it per launch to the ladder rung that ran
        self.decode_width = spec if spec is not None else self.decode_chunk
        if spec is None:
            if not (draft == "ngram" and draft_stages == 1
                    and spec_branches is None and not spec_adaptive):
                raise ValueError(
                    "draft/draft_stages/spec_branches/spec_adaptive "
                    "configure the speculative lane; set spec_tokens")
            self._drafter = None
            self._spec_overshoot = 0
            self._spec_ladder = []
            return
        m = self.model
        self._drafter = draft if isinstance(draft, DraftSource) \
            else resolve_draft(draft, n_stages=m.n_stages,
                               layers_per_stage=m.layers_per_stage,
                               draft_stages=draft_stages,
                               spec_branches=spec_branches)
        if self._drafter.branches > 1 and not hasattr(m, "embed_tree"):
            raise TypeError(
                f"{type(m).__name__} has no embed_tree; tree "
                "verification needs per-node position embedding")
        # a verify writes Q = 1 + branches*(K-1) rows from pos, at most
        # plen + max_new - 2: the headroom keeps the write unclamped
        self._spec_overshoot = self._drafter.branches * (spec - 1)
        self._spec_ladder = (sorted({2, (spec + 2) // 2, spec})
                             if spec_adaptive else [spec])
        self._spec_ewma = np.full((self.num_slots,), float(spec))
        self._spec_acc_total = 0
        self._spec_draft_total = 0

    def _init_spec_state(self, st: dict) -> None:
        """The drafter's scratch (a tree's branch caches: static buffers of
        the programs, rewritten every round) and a tree's constants: each
        rung's node depths and ancestor mask, on the device before any
        capture."""
        dev = self.device
        B = self._drafter.branches
        buffers = self._drafter.make_buffers(st["caches"])
        if buffers is not None:
            st["drafter_buffers"] = buffers
        self._tree_consts = {}
        for k in self._spec_ladder if B > 1 else ():
            depths, anc = tree_layout(k, B)
            self._tree_consts[k] = (
                torch.as_tensor(depths, dtype=torch.int64, device=dev),
                torch.as_tensor(anc, device=dev))

    def _init_paged(self, st: dict, proto: dict) -> None:
        """The pool's device arrays, the per-slot views the decode programs
        run on, the tables, and the prefill-chunk program's buffers."""
        m, dev, pool = self.model, self.device, self.pool
        cd = m.cfg.compute_dtype
        ids = dict(dtype=torch.int64, device=dev)
        L, S = len(m.blocks), self.num_slots
        bs, W = pool.block_size, pool.table_width
        self._pool_kv = storage_for(proto, L, pool.num_blocks, bs,
                                    kv_dtype=self.kv_dtype)
        # Per-slot gathered views carried across decode chunks: the
        # prefill that moves a slot's table refreshes that slot's view.
        # Compute dtype even for int8 pools: the view is the dequantized
        # working set.
        R = pool.max_blocks * bs
        views = {name: torch.zeros((L, S, R) + tuple(proto[name].shape[2:]),
                                   dtype=cd, device=dev)
                 for name in ("k", "v")}
        st["views"] = views
        st["caches"] = self._layer_views(views)
        st["table"] = causal_table(R, dev)
        st["tables"] = torch.zeros((S, W), **ids)
        st["pool"] = self._pool_kv
        # The chunk program's input: (chunk start t0, true length, slot,
        # seed word, the table row, the padded prompt), one host copy per
        # prefill; each replay advances t0 by one chunk on the device.
        R_ext = (W - 1) * bs
        self._cpin_layout = (4, 4 + W, 4 + W + R_ext)
        cst = {"pin": torch.zeros(4 + W + R_ext, **ids),
               "h_last": torch.zeros((1, m.cfg.d_model), dtype=cd,
                                     device=dev),
               "table": causal_table(R_ext, dev), "pool": self._pool_kv}
        self._chunk_prog = _Program(
            self, self._chunk_body, cst, self._chunk_scratch,
            "serve.engine.prefill_chunk_traces")
        self._first_prog = _Program(
            self, self._first_token_paged, dict(st, cst=cst),
            lambda: dict(self._scratch(("tok", "pos", "seed", "step",
                                        "caches")),
                         cst=_clone(cst, ("h_last", "pin"))))
        fst = {"pin": torch.zeros(2, **ids), "pool": self._pool_kv}
        self._fork_prog = _Program(
            self, lambda s: copy_block(s["pool"], s["pin"][0:1],
                                       s["pin"][1:2]),
            fst, lambda: dict(fst, pin=torch.zeros_like(fst["pin"])),
            "serve.kv.fork_traces")
        rst = {"dst": torch.zeros(1, **ids), "pool": self._pool_kv,
               "payload": {name: torch.zeros_like(a[:, 0])
                           for name, a in self._pool_kv.items()}}
        self._restore_prog = _Program(
            self, self._restore_body, rst,
            lambda: dict(rst, dst=torch.zeros_like(rst["dst"])),
            "serve.kv.restore_traces")

    @staticmethod
    def _layer_views(views: dict) -> list:
        """Per-layer ``{'k', 'v'}`` caches ``[S, R, ...]`` over the views
        ``[L, S, R, ...]``: what the decode step runs on."""
        return [{name: views[name][l] for name in ("k", "v")}
                for l in range(views["k"].shape[0])]

    def _scratch(self, names: Sequence[str]) -> dict:
        """Copies of the decode state for a capture's warm-up; a paged
        backend's copy also zeroes the tables, so every pool write of the
        warm-up lands in the sacrificial block, and copies the views."""
        st = self._state
        names = list(names)
        if self.paged:
            if "caches" in names:
                names[names.index("caches")] = "views"
            names.append("tables")
        out = _clone(st, [n for n in names if n in st])
        if self.paged:
            out["tables"].zero_()
            if "views" in names:
                out["caches"] = self._layer_views(out["views"])
        for name in ("rin", "hist"):
            if name in st:
                out[name] = st[name].clone()
        return out

    # -- validation --------------------------------------------------------

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        """Admission-control shape checks — reject at submit, not at
        prefill, so a bad request never costs a slot. A live slot's last
        decode writes row ``prompt_len + max_new_tokens - 2``, inside the
        cache; a speculative verify writes ``branches * (K-1)`` rows past
        it (the speculative headroom). Paged mode adds the can-it-EVER-fit
        check: demand beyond the whole pool is unservable, not merely
        parked."""
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
        if prompt_len + max_new_tokens + self._spec_overshoot > self.max_len:
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
        if limit is not None and max(bucket,
                                     prompt_len + max_new_tokens) > limit:
            raise ValueError(
                f"request needs position {max(bucket, prompt_len + max_new_tokens)} "
                f"but the positional table has {limit}")

    # -- device programs ---------------------------------------------------

    def _draws(self, seed: torch.Tensor, step: torch.Tensor,
               vocab: int) -> Optional[torch.Tensor]:
        if self.gen.temperature == 0.0:
            return None
        return keyed_uniform(seed, step, vocab)

    def _first_token(self, st: dict, h_last: torch.Tensor,
                     slot: torch.Tensor, plen: torch.Tensor,
                     word: torch.Tensor) -> None:
        """The first-token epilogue of every prefill: the head on ``h_last
        [1, d]``, a draw at step 0 keyed by the request's seed word, and
        the slot's (token, position, seed, step) written at ``slot`` (all
        ``[1]`` device tensors). The token also lands in ``st["tok0"]``."""
        logits = head_logits(self.model, h_last)            # [1, V]
        tok = sample_logits(
            logits, self.gen,
            uniform=self._draws(word, torch.zeros_like(word),
                                logits.shape[-1]))
        st["tok"].index_copy_(0, slot, tok)
        st["pos"].index_copy_(0, slot, plen)
        st["seed"].index_copy_(0, slot, word)
        st["step"].index_fill_(0, slot, 1)

    def _hist_write(self, st: dict, slot: torch.Tensor, plen: torch.Tensor,
                    prompt: torch.Tensor) -> None:
        """Seed the spec lane's history row of a freshly prefilled slot:
        the prompt (``prompt``, padded past ``plen``), the first token at
        ``plen``, pad beyond -- inside the prefill's epilogue program, from
        the prompt already on the device. No-op without the spec lane."""
        if "hist" not in st:
            return
        hist, pad = st["hist"], self.gen.pad_token_id
        H = hist.shape[1]
        n = min(prompt.shape[0], H)
        row = torch.nn.functional.pad(prompt[:n], (0, H - n), value=pad)
        ar = torch.arange(H, device=hist.device)
        row = torch.where(ar < plen, row, pad)
        row = torch.where(ar == plen, st["tok"].index_select(0, slot), row)
        hist.index_copy_(0, slot, row[None])

    def _bucket_body(self, st: dict, B: int) -> None:
        """The bucket-length-B prefill: the right-padded prompt through
        every block's ``decode`` against a fresh full-length cache, which
        then replaces the ENTIRE slot slab (the previous occupant's rows
        are gone, not merely masked), then the first token from the logits
        at the true last position."""
        m = self.model
        pin = st["pin"]
        plen, slot, word = pin[0:1], pin[1:2], pin[2:3]
        prompt = pin[3:3 + B][None]                         # [1, B]
        h = m.embed_at(prompt, 0)                           # [1, B, d]
        allowed = st["table"][:B]
        for blk, cache in zip(m.blocks, st["caches"]):
            rows = {name: torch.zeros_like(c[:1])
                    for name, c in cache.items()}
            h, _ = blk.decode(h, rows, 0, allowed=allowed)
            for name, c in cache.items():
                c.index_copy_(0, slot, rows[name])
        h_last = h[0].index_select(0, plen - 1)            # [1, d]
        self._first_token(st, h_last, slot, plen, word)
        self._hist_write(st, slot, plen, pin[3:3 + B])

    def _decode_step(self, st: dict, tok: torch.Tensor, pos: torch.Tensor,
                     step: torch.Tensor) -> torch.Tensor:
        """One decode step for all S slots: each slot's K/V row written at
        its position in ``st["caches"]``, the next token returned. Reads
        nothing back to the host: positions gather the mask rows and the
        positional table, K/V rows are written by index."""
        m = self.model
        allowed = st["table"][pos][:, None]               # [S, 1, rows]
        h = m.embed_at(tok[:, None], pos)                 # [S, 1, d]
        for blk, cache in zip(m.blocks, st["caches"]):
            h, _ = blk.decode(h, cache, pos, allowed=allowed)
        logits = head_logits(m, h[:, 0])                  # [S, V]
        return sample_logits(
            logits, self.gen,
            uniform=self._draws(st["seed"], step, logits.shape[-1]))

    def _decode_body(self, st: dict) -> None:
        """THE decode step: ``decode_chunk`` tokens for all S slots, on the
        buffers of ``st`` in place; EOS masking is a ``where``. A slot's
        position stops at the cache's last row (a dead slot decodes
        garbage there; a live one never gets that far)."""
        gen = self.gen
        eos = gen.eos_token_id
        tok, pos = st["tok"], st["pos"]
        last = st["caches"][0]["k"].shape[1] - 1
        done = None if eos is None else tok == eos
        for k in range(self.decode_chunk):
            nxt = self._decode_step(st, tok, pos, st["step"])
            if done is not None:
                # a finished slot emits pad from the step after its EOS
                nxt = torch.where(done, gen.pad_token_id, nxt)
                done = done | (nxt == eos)
            st["out"][:, k].copy_(nxt)
            tok.copy_(nxt)
            pos.add_(1).clamp_(max=last)
            st["step"].add_(1)

    def _scatter_chunk(self, st: dict, pos0: torch.Tensor,
                       width: Optional[int] = None) -> None:
        """The rows a decode chunk (or a ``width``-row spec verify) wrote
        into the views, positions ``pos0 + [0, C)`` of every slot, back
        into the pool through the FULL-width tables: positions past a
        slot's reserved blocks, and every row of a released slot (zeroed
        table), land in the sacrificial block."""
        C = self.decode_chunk if width is None else width
        S = self.num_slots
        views = st["views"]
        last = views["k"].shape[2] - 1
        p = pos0[:, None] + torch.arange(C, device=pos0.device)  # [S, C]
        ridx = flat_row_index(st["tables"], p, self.pool.block_size)
        ridx = ridx.reshape(-1)
        src = p.clamp(max=last)
        rows_of = torch.arange(S, device=pos0.device)[:, None]
        for l in range(len(self.model.blocks)):
            pool_l = {name: a[l] for name, a in st["pool"].items()}
            rows = {name: views[name][l][rows_of, src].reshape(
                        (S * C,) + views[name].shape[3:])
                    for name in ("k", "v")}
            scatter_block_rows(pool_l, ridx, rows)

    def _decode_paged_body(self, st: dict) -> None:
        """The paged decode program: ``decode_chunk`` slab-style steps on
        the per-slot views (the attention math of the slab, in-chunk rows
        read back from the view as the slab reads its own), then the S*C
        new rows scattered back into the pool once."""
        pos0 = st["pos"].clone()
        self._decode_body(st)
        self._scatter_chunk(st, pos0)

    def _chunk_body(self, cst: dict) -> None:
        """THE prefill program: one fixed-shape ``[1, C]`` chunk at the
        offset ``t0`` held on the device, for any prompt length. Each layer
        attends over the slot's gathered view (earlier chunks' rows
        included) and scatters its C new rows back through the table row;
        pad positions past the true length land in the slot's own future
        decode blocks or the sacrificial block, both rewritten or ignored
        before any unmasked read. Leaves ``h`` at ``true_len - 1``, clamped
        into this chunk, in ``h_last`` (the last chunk's is the prompt's),
        and advances ``t0`` by C."""
        m = self.model
        cd = m.cfg.compute_dtype
        bs = self.pool.block_size
        C = self.prefill_chunk
        a, b, _ = self._cpin_layout
        pin = cst["pin"]
        t0, true_len = pin[0:1], pin[1:2]
        trow, prompt = pin[a:b], pin[b:]
        positions = t0 + torch.arange(C, device=pin.device)   # [C]
        h = m.embed_at(prompt.index_select(0, positions)[None], t0)
        ridx = flat_row_index(trow, positions, bs)
        allowed = cst["table"][positions][None]              # [1, C, R]
        for l, blk in enumerate(m.blocks):
            pool_l = {name: arr[l] for name, arr in cst["pool"].items()}
            cache = gather_block_cache(pool_l, trow, block_size=bs,
                                       compute_dtype=cd)
            h, c2 = blk.decode(h, cache, t0, allowed=allowed)
            scatter_block_rows(pool_l, ridx, {
                name: c2[name][0].index_select(0, positions)
                for name in ("k", "v")})
        idx = (true_len - 1 - t0).clamp(0, C - 1)
        cst["h_last"].copy_(h[0].index_select(0, idx))
        t0.add_(C)

    def _chunk_scratch(self) -> dict:
        cst = _clone(self._chunk_prog.st, ("h_last", "pin"))
        a, b, _ = self._cpin_layout
        cst["pin"][a:b].zero_()
        return cst

    def _first_token_paged(self, st: dict) -> None:
        """The paged prefill's epilogue program: the first token from the
        chunk program's ``h_last``, and the slot's view refreshed from the
        pool through its new table row (its first ``max_blocks`` entries:
        every row the slot can read or write). The other slots' views stay
        valid: this admission wrote only blocks its own table holds."""
        pin = st["cst"]["pin"]
        slot = pin[2:3]
        self._first_token(st, st["cst"]["h_last"], slot, pin[1:2],
                          pin[3:4])
        a, b, _ = self._cpin_layout
        self._hist_write(st, slot, pin[1:2], pin[b:])
        trow = pin[a:a + self.pool.max_blocks + 1]
        cd = self.model.cfg.compute_dtype
        for l in range(len(self.model.blocks)):
            pool_l = {name: arr[l] for name, arr in st["pool"].items()}
            fresh = gather_block_cache(pool_l, trow,
                                       block_size=self.pool.block_size,
                                       compute_dtype=cd)     # [1, R, ...]
            for name in ("k", "v"):
                st["views"][name][l].index_copy_(0, slot, fresh[name])

    def _restore_body(self, rst: dict) -> None:
        """An offloaded block's host payload (staged on the device) back
        at physical block ``dst``: one program for every restore."""
        for name, a in rst["pool"].items():
            a.index_copy_(1, rst["dst"], rst["payload"][name][:, None])

    def _offload_read_block(self, bid: int) -> dict:
        """Host copy of one physical block across every pool array -- the
        payload :class:`~.kvpool.HostKvStore` holds while the block is
        offloaded. Raw storage bytes (int8 codes + scales for int8 pools),
        so the later restore is bitwise. A copy, also on the CPU, where
        ``.cpu()`` would return the pool's own memory."""
        return {name: a[:, bid].to("cpu", copy=True).numpy()
                for name, a in self._pool_kv.items()}

    # -- the resident loop -------------------------------------------------

    def _resident_body(self, st: dict) -> None:
        """The resident program: ``resident_chunks`` decode chunks,
        unrolled, each gated by ``go = (k < r_max) & ~any(live & done)``.
        The chunk math is :meth:`_decode_step`'s; ``done`` (dead slot,
        spent budget, EOS) masks a slot's tokens to pad, and a chunk
        without ``go`` keeps every per-slot value as it was, so the next
        launch recomputes it. Paged: each chunk's rows scatter back into
        the pool. Writes the tokens and the count of chunks run ``k`` to
        ``rout``."""
        gen = self.gen
        eos, pad = gen.eos_token_id, gen.pad_token_id
        S, C = self.num_slots, self.decode_chunk
        rin = st["rin"]
        live, budget, r_max = rin[:S] > 0, rin[S:2 * S], rin[2 * S]
        tok, pos, step = st["tok"], st["pos"], st["step"]
        last = st["caches"][0]["k"].shape[1] - 1
        done = ~live | (budget <= 0)
        if eos is not None:
            done = done | (tok == eos)
        k = torch.zeros((), dtype=torch.int64, device=tok.device)
        cur = (tok, pos, step, budget, done)
        outs = []
        for _ in range(self.resident_chunks):
            go = (k < r_max) & ~(live & cur[4]).any()
            t, p, s, b, d = cur
            toks = []
            for _ in range(C):
                nxt = self._decode_step(st, t, p, s)
                nxt = torch.where(d, pad, nxt)
                b = b - (~d).to(b.dtype)
                d = d | (b <= 0)
                if eos is not None:
                    d = d | (nxt == eos)
                toks.append(nxt)
                t, p, s = nxt, (p + 1).clamp(max=last), s + 1
            if self.paged:
                self._scatter_chunk(st, cur[1])
            cur = tuple(torch.where(go, new, old)
                        for new, old in zip((t, p, s, b, d), cur))
            k = k + go.to(k.dtype)
            outs.append(torch.stack(toks, dim=1))
        tok.copy_(cur[0])
        pos.copy_(cur[1])
        step.copy_(cur[2])
        st["rout"].copy_(torch.cat(outs + [k.expand(S, 1)], dim=1))

    # -- the speculative lane ----------------------------------------------
    #
    # A resident iteration becomes a draft/verify ROUND: the drafter
    # proposes K-1 tokens per slot, ONE teacher-forced [S, Q] decode at the
    # slots' positions verifies [tok, drafts], and the longest prefix the
    # model itself picks is accepted plus one correction token. Rollback is
    # free: rejected rows sit at positions >= the advanced pos, masked, and
    # the next round's Q-row write covers them before any unmasked read.
    # Row r of the chunk draws keyed_uniform(seed, step + depth[r]), so a
    # node at depth d takes the d-th sequential draw whatever branch it sits
    # on, and accepted tokens are exactly those the tick path draws.

    def _spec_round(self, st: dict, K: int, cur: tuple):
        """One draft/verify round at ladder depth ``K`` on the caches of
        ``st`` (slab, or the paged views) and the per-slot state ``cur =
        (tok, pos, step, budget, done, hist)``. Returns the advanced state
        (done slots frozen), the round's ``[S, K]`` tokens (pad past the
        accepted count and after an EOS) and the accepted counts ``[S]``
        (0 for a done slot). With a multi-branch drafter the chunk is the
        flattened tree, ``Q = 1 + B(K-1)`` rows under the tree mask; the
        winning branch's rows are relocated to ``[pos+1, pos+K)`` before
        the round returns, so the next round reads them as a linear
        prefix."""
        m, gen = self.model, self.gen
        eos, pad = gen.eos_token_id, gen.pad_token_id
        tok, pos, step, budget, done, hist = cur
        caches, table = st["caches"], st["table"]
        S, rows, dev = tok.shape[0], caches[0]["k"].shape[1], tok.device
        B = self._drafter.branches
        ar = torch.arange(K, device=dev)

        # 1) draft: [S, B, K-1] candidate continuations of tok
        drafts = self._drafter.propose(m, caches, table, tok, pos, hist, K,
                                       st.get("drafter_buffers"))

        # 2) verify: ONE teacher-forced [S, Q] decode at pos
        x = torch.cat([tok[:, None], drafts.reshape(S, B * (K - 1))], dim=1)
        Q = x.shape[1]
        if B == 1:
            depth = ar
            h = m.embed_at(x, pos)
            allowed = table[pos.clamp(0, rows - Q)[:, None] + ar]
        else:
            depth, anc = self._tree_consts[K]
            h = m.embed_tree(x, pos, depth)
            allowed = tree_mask(anc, pos, rows)
        for blk, cache in zip(m.blocks, caches):
            h, _ = blk.decode(h, cache, pos, allowed=allowed)
        logits = head_logits(m, h)                          # [S, Q, V]
        V = logits.shape[-1]

        # 3) the draws: row r at step + depth[r]
        u = None
        if gen.temperature != 0.0:
            u = keyed_uniform(st["seed"][:, None].expand(S, Q).reshape(-1),
                              (step[:, None] + depth).reshape(-1), V)
        t = sample_logits(logits.reshape(S * Q, V), gen,
                          uniform=u).reshape(S, Q)

        # 4) accept the longest matching (root-to-leaf) prefix + 1
        if B == 1:
            t_lin = t
            lead = (drafts[:, 0] == t[:, :K - 1]).long().cumprod(dim=1)
            n_emit = 1 + lead.sum(dim=1)
        else:
            tb = t[:, 1:].reshape(S, B, K - 1)
            prev = torch.cat([t[:, :1, None].expand(S, B, 1),
                              tb[:, :, :-1]], dim=2)
            len_b = (drafts == prev).long().cumprod(dim=2).sum(dim=2)
            bsel = torch.argmax(len_b, dim=1)                # [S]
            n_emit = 1 + len_b.gather(1, bsel[:, None])[:, 0]
            t_lin = torch.cat(
                [t[:, :1],
                 tb.gather(1, bsel[:, None, None].expand(S, 1, K - 1))[:, 0]],
                dim=1)
        n_emit = torch.where(done, 0, n_emit)
        emit = ar < n_emit[:, None]                          # [S, K]
        keep = emit
        if eos is not None:
            hit = ((t_lin == eos) & emit).long()
            keep = emit & ((hit.cumsum(dim=1) - hit) == 0)
        toks = torch.where(keep, t_lin, pad)

        # 5) tree: the winning branch's K-1 rows to [pos+1, pos+K), read
        # into a temporary first (the ranges overlap)
        if B > 1:
            ar1 = torch.arange(K - 1, device=dev)
            src = ((pos + 1 + bsel * (K - 1))[:, None] + ar1).clamp(
                0, rows - 1)
            dst = (pos + 1).clamp(0, rows - (K - 1))[:, None] + ar1
            slot = torch.arange(S, device=dev)[:, None].expand(S, K - 1)
            for cache in caches:
                for c in cache.values():
                    c.index_put_((slot, dst), c[slot, src])

        # 6) advance; done slots keep tok/pos/step/budget/hist
        last = t_lin.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
        H = hist.shape[1]
        hidx = (pos + 1).clamp(0, H - K)[:, None] + ar
        hist = hist.scatter(1, hidx, torch.where(emit, t_lin,
                                                 hist.gather(1, hidx)))
        budget = budget - n_emit
        new_done = done | (budget <= 0)
        if eos is not None:
            new_done = new_done | (hit > 0).any(dim=1)
        new = (torch.where(done, tok, last), pos + n_emit, step + n_emit,
               budget, new_done, hist)
        return new, toks, n_emit

    def _resident_spec_body(self, st: dict, K: int) -> None:
        """The resident spec program at ladder depth ``K``:
        ``resident_chunks`` rounds unrolled, each gated by ``go = (k <
        r_max) & ~any(live & done)`` as :meth:`_resident_body`'s chunks
        are; a round without ``go`` keeps every per-slot value (history
        included) as it was. Paged: each round's Q rows scatter back into
        the pool from the round's start. Writes the accepted counts ``[S,
        R]``, the rounds run ``k`` and the tokens ``[S, R*K]`` to
        ``rout``."""
        eos = self.gen.eos_token_id
        S, R = self.num_slots, self.resident_chunks
        rin = st["rin"]
        live, budget, r_max = rin[:S] > 0, rin[S:2 * S], rin[2 * S]
        tok, pos, step, hist = st["tok"], st["pos"], st["step"], st["hist"]
        done = ~live | (budget <= 0)
        if eos is not None:
            done = done | (tok == eos)
        B = self._drafter.branches
        Q = 1 + B * (K - 1) if B > 1 else K
        k = torch.zeros((), dtype=torch.int64, device=tok.device)
        cur = (tok, pos, step, budget, done, hist)
        counts, outs = [], []
        for _ in range(R):
            go = (k < r_max) & ~(live & cur[4]).any()
            new, toks, n_emit = self._spec_round(st, K, cur)
            if self.paged:
                self._scatter_chunk(st, cur[1], Q)
            cur = tuple(torch.where(go, a, b) for a, b in zip(new, cur))
            k = k + go.to(k.dtype)
            counts.append(torch.where(go, n_emit, 0)[:, None])
            outs.append(toks)
        tok.copy_(cur[0])
        pos.copy_(cur[1])
        step.copy_(cur[2])
        hist.copy_(cur[5])
        st["rout"][:, :R + 1 + R * K].copy_(
            torch.cat(counts + [k.expand(S, 1)] + outs, dim=1))

    # -- backend API -------------------------------------------------------

    def prefill(self, slot: int, prompt: Sequence[int], seed: int,
                max_new_tokens: Optional[int] = None) -> int:
        """Fill slot ``slot``'s KV rows from ``prompt`` and return the
        first sampled token. Blocking -- the returned int IS the TTFT
        moment. Slab: one program per prompt-length bucket. Paged: ONE
        chunk program whatever the length; ``max_new_tokens`` sizes the
        block reservation (default the engine cap: full-demand reservation
        means no mid-decode OOM)."""
        if self.spec_tokens is not None:
            # adaptive K starts each request optimistic: full draft depth
            # until its own acceptance says otherwise
            self._spec_ewma[slot] = float(self.spec_tokens)
        with torch.no_grad():
            if self.paged:
                return self._prefill_paged(
                    slot, prompt, seed,
                    max_new_tokens if max_new_tokens is not None
                    else self.gen.max_new_tokens)
            return self._prefill_slab(slot, prompt, seed)

    def _prefill_slab(self, slot: int, prompt: Sequence[int],
                      seed: int) -> int:
        reg = get_registry()
        if self.buckets is not None:
            padded, p = self.buckets.pad(prompt, self.gen.pad_token_id)
        else:
            padded, p = list(prompt), len(prompt)
        B = len(padded)
        st = self._state
        run = self._prefill_programs.get(B)
        if run is None:
            run = _Program(
                self, lambda s, B=B: self._bucket_body(s, B), st,
                self._bucket_scratch)
            self._prefill_programs[B] = run
            reg.counter("serve.engine.prefill_traces").inc()
            reg.counter("serve.engine.prefill_program_misses").inc()
            reg.gauge("serve.engine.prefill_programs").set(
                len(self._prefill_programs))
            if self.buckets is None and \
                    len(self._prefill_programs) == self.shape_cache_warn + 1:
                warnings.warn(
                    f"serve engine prefilled {len(self._prefill_programs)} "
                    f"distinct prompt shapes with bucketing DISABLED — "
                    f"every new prompt length is a new shape. Pass a "
                    f"BucketSpec to cap them.", RuntimeWarning,
                    stacklevel=4)
        else:
            reg.counter("serve.engine.prefill_program_hits").inc()
        pin = np.zeros(3 + B, np.int64)
        pin[:3] = (p, slot, seed_word(seed))
        pin[3:] = padded
        st["pin"][:3 + B].copy_(torch.from_numpy(pin))
        run()
        return int(st["tok"][slot])

    def _bucket_scratch(self) -> dict:
        """Warm-up buffers of a bucket program: one-slot caches and copies
        of the per-slot state, so the live slab is not touched."""
        st = self._scratch(("tok", "pos", "seed", "step", "pin"))
        st["caches"] = [{name: torch.zeros_like(c[:1])
                         for name, c in cache.items()}
                        for cache in self._state["caches"]]
        st["pin"][1] = 0
        return st

    def _prefill_paged(self, slot: int, prompt: Sequence[int], seed: int,
                       max_new_tokens: int) -> int:
        """Admit into the pool (reserving full demand), restore offloaded
        prefix blocks, run the COW forks, stream the prompt's recompute
        tail through the one chunk program, sample the first token. A
        failure mid-way releases the reservation with ``failed=True``,
        which unpublishes any half-written cache entries."""
        plen = len(prompt)
        C = self.prefill_chunk
        adm = self.pool.admit(slot, prompt, max_new_tokens, chunk=C)
        st = self._state
        try:
            for dst, payload in adm.restores:
                # offloaded prefix blocks come back from the host store
                # BEFORE any fork or chunk writes
                rst = self._restore_prog.st
                for name, a in payload.items():
                    rst["payload"][name].copy_(torch.from_numpy(a))
                rst["dst"].fill_(dst)
                self._restore_prog()
            for src, dst in adm.cow_forks:
                self._fork_prog.st["pin"].copy_(torch.tensor([src, dst]))
                self._fork_prog()
            a, b, end = self._cpin_layout
            pin = np.full(end, self.gen.pad_token_id, np.int64)
            pin[:4] = (adm.resume_from, plen, slot, seed_word(seed))
            pin[a:b] = adm.table
            pin[b:b + plen] = prompt
            self._chunk_prog.st["pin"].copy_(torch.from_numpy(pin))
            for _ in range(adm.resume_from, plen, C):
                self._chunk_prog()
            self._first_prog()
            tok0 = int(st["tok"][slot])
        except Exception:
            self.pool.release(slot, failed=True)
            raise
        st["tables"][slot].copy_(torch.from_numpy(
            adm.table.astype(np.int64)))
        # the epilogue refreshed this slot's view: the ONE host gather
        # decision per admission (decode ticks and launches make none)
        get_registry().counter("serve.kv.regather_host_decisions").inc()
        return tok0

    def decode(self, live: np.ndarray,
               budgets: Optional[np.ndarray] = None,
               r_max: Optional[int] = None):
        """One decode chunk for all slots. Returns ``(tokens [S, K],
        valid [S, K])`` -- dead slots compute garbage (their rows are
        rewritten at the next prefill or, paged, land in the sacrificial
        block); ``valid`` masks them out.

        With ``budgets`` (per-slot remaining max_new_tokens) on a resident
        backend, the call runs the RESIDENT program instead: up to
        ``r_max`` chunks (default ``resident_chunks``) in one launch,
        returning ``[S, k*K]`` tokens for the ``k`` chunks it ran. Without
        ``budgets`` the single-chunk path runs even when ``resident=True``:
        that is the equality reference."""
        with torch.no_grad():
            if self.resident and budgets is not None:
                return self._decode_resident(live, budgets, r_max)
            st = self._state
            self._decode_prog()
            toks = st["out"].cpu().numpy()
        valid = np.broadcast_to(
            np.asarray(live, bool)[:, None], toks.shape)
        return toks, valid

    def _decode_resident(self, live: np.ndarray, budgets: np.ndarray,
                         r_max: Optional[int]):
        """One resident launch: up to ``r_max`` chunks (spec: rounds) on
        the device, ONE host read-back (the tokens, the chunk count and,
        spec, the accepted counts)."""
        reg = get_registry()
        S, R = self.num_slots, self.resident_chunks
        rm = R if r_max is None else max(1, min(int(r_max), R))
        rin = np.zeros(2 * S + 1, np.int64)
        rin[:S] = np.asarray(live, bool)
        rin[S:2 * S] = budgets
        rin[2 * S] = rm
        st = self._state
        st["rin"].copy_(torch.from_numpy(rin))
        if self.spec_tokens is not None:
            self.decode_width = self._pick_spec_k(live)
            self._spec_progs[self.decode_width]()
        else:
            self._resident_prog()
        rout = st["rout"].cpu().numpy()            # THE host sync
        W = self.decode_width
        k = int(rout[0, R] if self.spec_tokens is not None else rout[0, -1])
        reg.counter("serve.engine.resident_chunks_run").inc(k)
        reg.counter("serve.engine.resident_chunks_computed").inc(R)
        if k < rm:
            reg.counter("serve.engine.device_exits").inc()
        if self.spec_tokens is None:
            toks = rout[:, :k * W]
            return toks, np.broadcast_to(np.asarray(live, bool)[:, None],
                                         toks.shape)
        counts = rout[:, :k]
        toks = rout[:, R + 1:R + 1 + k * W]
        valid = (np.arange(W)[None, None, :]
                 < counts[:, :, None]).reshape(S, k * W)
        self._spec_telemetry(reg, np.asarray(live, bool), counts, W)
        return toks, valid

    def _spec_telemetry(self, reg, lmask: np.ndarray, counts: np.ndarray,
                        W: int) -> None:
        """A launch's spec counters and gauges, and the adaptive ladder's
        per-slot EWMA of accepted length (live slots that ran)."""
        lc = counts[lmask]
        rounds = int((lc > 0).sum())
        emitted = int(lc.sum())
        reg.counter("serve.engine.spec_rounds").inc(rounds)
        reg.counter("serve.engine.spec_emitted").inc(emitted)
        # acceptance: accepted draft tokens over drafted positions (K-1 a
        # round), cumulative; draft cost: the drafter's work-unit share at
        # the rung that ran
        self._spec_acc_total += max(emitted - rounds, 0)
        self._spec_draft_total += rounds * (W - 1)
        if self._spec_draft_total:
            reg.gauge("serve.spec.acceptance_rate").set(
                self._spec_acc_total / self._spec_draft_total)
        reg.gauge("serve.spec.draft_cost_frac").set(
            self._drafter.draft_cost_frac(W, self._n_layers))
        hist_m = reg.histogram("serve.spec.accept_len")
        for v in lc[lc > 0]:
            hist_m.observe(float(v))
        if len(self._spec_ladder) > 1:
            rc = np.maximum((counts > 0).sum(axis=1), 1)
            mean_acc = counts.sum(axis=1) / rc
            upd = lmask & (counts.sum(axis=1) > 0)
            self._spec_ewma[upd] = (0.7 * self._spec_ewma[upd]
                                    + 0.3 * mean_acc[upd])

    def _pick_spec_k(self, live: np.ndarray) -> int:
        """Smallest ladder rung covering the live slots' accepted-length
        EWMA (plus one probe token so acceptance can grow back).
        Single-rung ladders -- the non-adaptive default -- short-circuit
        to ``spec_tokens``."""
        ladder = self._spec_ladder
        if len(ladder) == 1:
            return ladder[0]
        lmask = np.asarray(live, bool)
        if not lmask.any():
            return ladder[0]
        need = int(np.ceil(self._spec_ewma[lmask].max())) + 1
        need = max(2, min(need, self.spec_tokens))
        for k in ladder:
            if k >= need:
                return k
        return ladder[-1]

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        """Block-availability admission gate (always True for the slab —
        its reservation is the slot itself)."""
        if not self.paged:
            return True
        return self.pool.can_admit(prompt_len, max_new_tokens, prompt,
                                   chunk=self.prefill_chunk)

    def release(self, slot: int) -> None:
        """Engine retirement hook: return the slot's blocks to the pool
        and zero its device table row, so the dead slot decodes into the
        sacrificial block (a no-op for the slab — the next prefill
        rewrites the rows)."""
        if self.paged:
            self.pool.release(slot)
            self._state["tables"][slot].zero_()

    def program_stats(self) -> dict:
        out = {"prefill_programs": (1 if self.paged
                                    else len(self._prefill_programs)),
               "decode_chunk": self.decode_chunk,
               "kv": "paged" if self.paged else "slab",
               "decode_graph": self._decode_prog.graph is not None}
        if self.spec_tokens is not None:
            graphs = [p.graph is not None for p in self._spec_progs.values()
                      if p._ready]
            out["resident_graph"] = bool(graphs) and all(graphs)
            out["spec_rungs_ready"] = len(graphs)
        elif self.resident:
            out["resident_graph"] = self._resident_prog.graph is not None
        return out

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
    On a paged backend a request the pool cannot cover parks at the head
    of the queue while a smaller one behind it may be admitted, and
    ``pool.observe()`` feeds the ``serve.kv.*`` gauges every tick. On a
    resident backend each tick's decode is one resident launch whose
    horizon (:meth:`_resident_horizon`) is sized from the soonest deadline
    and the observed per-chunk latency. ``watchdog``, ``chaos`` and the
    disaggregated ``phase`` values are not ported yet (ROADMAP.md A.7) and
    raise ``NotImplementedError``.
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
        # observed per-chunk decode latency (EWMA): sizes the resident
        # deadline horizon in chunks; None until the first decode
        self._chunk_ewma: Optional[float] = None

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
        detail = ({"demand": exc.demand, "blocks_free": exc.free,
                   "blocks_evictable": exc.evictable,
                   "blocks_total": exc.total}
                  if isinstance(exc, PoolExhausted) else {})
        self.events.event("resilience", action="slot_error",
                          request=req.id, where="prefill",
                          error=type(exc).__name__, **detail)
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
        # each request can seat now (always, for the slab; block
        # availability, for the paged pool); a parked head keeps its place
        # while the next request in pop order may go.
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
                    pool = self.backend.pool
                    detail = ({"blocks_free": pool.free_blocks,
                               "blocks_evictable": pool.evictable_blocks}
                              if pool is not None else {})
                    reg.counter("serve.kv.admission_blocked").inc()
                    self.events.event("serve", action="admission_blocked",
                                      request=cand.id,
                                      depth=self.queue.depth, **detail)
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

        # 3) decode — one fixed-shape chunk for every slot (a resident
        # backend: up to resident_chunks of them in one launch). A failure
        # is NOT attributable (all slots share the step): skip the tick
        # with slot state intact, and only a run of consecutive failures
        # retires the live set.
        live = np.array([s is not None for s in self._slots])
        if live.any():
            t0 = self.clock()
            try:
                reg.counter("serve.engine.host_syncs").inc()
                if self.backend.resident:
                    budgets = np.array(
                        [0 if s is None else
                         max(s.req.max_new_tokens - len(s.tokens), 0)
                         for s in self._slots], np.int64)
                    toks, valid = self.backend.decode(
                        live, budgets=budgets,
                        r_max=self._resident_horizon(now))
                else:
                    toks, valid = self.backend.decode(live)
            except Exception as e:           # noqa: BLE001 — containment
                self._on_decode_error(reg, e, tick_idx, finished)
            else:
                self._decode_errors = 0
                t1 = self.clock()
                device_sec += t1 - t0
                chunks = max(1, toks.shape[1] // self.backend.decode_width)
                per = (t1 - t0) / chunks
                self._chunk_ewma = per if self._chunk_ewma is None \
                    else 0.8 * self._chunk_ewma + 0.2 * per
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
        if self.backend.pool is not None:
            self.backend.pool.observe()
        dur = self.clock() - t_start
        # everything in the tick that was NOT a device call (prefill or
        # decode) is host overhead
        reg.timer("serve.engine.host_sec").observe(
            max(dur - device_sec, 0.0))
        reg.gauge("serve.engine.host_overhead_per_token").set(
            host_overhead_per_token(reg))
        reg.gauge("resilience.tick_sec").set(dur)
        return finished

    def _resident_horizon(self, now: float) -> int:
        """How many chunks the device may run before host attention could
        matter: the soonest deadline -- live slots or queued requests --
        over the observed per-chunk latency, clamped to [1,
        resident_chunks]. No deadline in sight: the full resident depth
        (the slot-free early exit still fires on the device)."""
        R = self.backend.resident_chunks
        dls = [s.req.deadline for s in self._slots
               if s is not None and s.req.deadline is not None]
        qd = self.queue.earliest_deadline()
        if qd is not None:
            dls.append(qd)
        if not dls:
            return R
        ew = self._chunk_ewma
        left = min(dls) - now
        if ew is None or ew <= 0.0 or left <= 0.0:
            return 1
        return int(max(1, min(R, left / ew)))

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
