"""Serving driver: the continuous-batching engine under a live workload.

Counterpart of the single-replica path of ``pipe_tpu/apps/serve.py``: runs
:class:`~pipe_tpu_torch.serve.ServeEngine` over the single-device slot
backend with ``--slots`` decode slots (the decode step captured in a CUDA
graph on the card; ``--kv paged`` serves from the paged KV pool,
``--resident`` runs several decode chunks per launch, and ``--spec-tokens``
makes each resident iteration a speculative draft/verify round). Workload:
``--prompts-file`` (comma-separated token-id
prompts, one per line, all arriving at once) or a synthetic seeded Poisson
stream (``--requests``/``--rate``). Per-request results stream to stdout as
JSON lines the moment each request retires; the final line is a summary
with the engine's ``serve.*`` metrics (admitted/retired/rejected counters,
TTFT percentiles, queue-depth/occupancy gauges). ``--events`` additionally
writes the request-span EventLog. SIGTERM/SIGINT drain the engine: live
slots finish, queued requests are shed.

Usage:
    python -m pipe_tpu_torch.apps.serve [--resume DIR] [--requests N --rate R]
        [--prompts-file F] [--slots S] [--max-new N] [--temperature T]
        [--top-k K] [--eos ID] [--queue-capacity C] [--policy fifo|priority]
        [--timeout-s T] [--decode-chunk K] [--events F.jsonl] [--int8]
        [--kv slab|paged] [--kv-block-size B] [--kv-pool-blocks N]
        [--kv-offload] [--kv-offload-blocks N] [--resident auto|on|off]
        [--resident-chunks R] [--spec-tokens K] [--draft ngram|truncated|tree]
        [--draft-stages N] [--spec-branches B] [--spec-adaptive]
        [--tiny] [--seed S] [--device cuda|cpu]

A model draft (``--draft truncated|tree``) is a strict prefix of the model:
with ``--stages 1`` the model is partitioned into ``--draft-stages + 1``
logical stages to carve it, as ``pipe_tpu`` does. Not ported yet, each
refused with rc 2 and the ROADMAP.md item it waits for: ``--stages > 1``
(the ring backend), ``--replicas``, ``--fleet``, ``--journal``,
``--roles``, ``--placement``, ``--kv-hot-refs``, ``--metrics-port``,
``--trace-out``, the ``--slo-*`` flags and the watchdog flags (the fleet
and its observability). ``--family gpt2`` serves ``PipelinedGPT2`` (fresh
weights from ``--seed``); its model has no ``embed_tree``, so ``--draft
tree`` exits 2 with the engine's message, as in ``pipe_tpu``. A request
that does not fit the model's positional table or the slot cache exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .generate import UsageError, build_model, family_config, model_source

_FLEET = "A.7, fleet/* and serve/router.py"
_OBS = "A.7, the rest of obs/* (fleet observability)"

# (flag, is it set away from its default?, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("--stages > 1", lambda a: a.stages > 1,
     "A.8, serve/ring.py over a stage mesh"),
    ("--replicas > 1", lambda a: a.replicas > 1, _FLEET),
    ("--fleet", lambda a: a.fleet is not None, _FLEET),
    ("--journal", lambda a: a.journal is not None, _FLEET),
    ("--roles", lambda a: a.roles is not None, _FLEET),
    ("--placement", lambda a: a.placement is not None, _FLEET),
    ("--kv-hot-refs", lambda a: a.kv_hot_refs is not None, _FLEET),
    ("--metrics-port", lambda a: a.metrics_port is not None, _OBS),
    ("--trace-out", lambda a: a.trace_out is not None, _OBS),
    ("--slo-*", lambda a: any(getattr(a, f) is not None for f in (
        "slo_ttft_p50", "slo_ttft_p99", "slo_e2e_p99", "slo_goodput_min",
        "slo_deadline_miss_max", "slo_shed_max")), _OBS),
    ("--tick-budget-s/--shed-ewma",
     lambda a: a.tick_budget_s is not None or a.shed_ewma is not None,
     "A.7, resilience/* (the tick watchdog)"),
)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resume", default=None,
                   help="Trainer checkpoint dir (train/state.py layout); "
                        "default: fresh random weights from --seed")
    p.add_argument("--prompts-file", default=None,
                   help="serve these prompts (comma-separated ids per "
                        "line) instead of a synthetic stream")
    p.add_argument("--requests", type=int, default=16,
                   help="synthetic stream: number of requests")
    p.add_argument("--rate", type=float, default=0.0,
                   help="synthetic stream: Poisson arrivals/s "
                        "(0 = all at once)")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--eos", type=int, default=None)
    p.add_argument("--slots", type=int, default=4, help="decode slots")
    p.add_argument("--queue-capacity", type=int, default=64)
    p.add_argument("--policy", choices=["fifo", "priority"],
                   default="fifo")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="per-request deadline")
    p.add_argument("--decode-chunk", type=int, default=4,
                   help="decode steps per host tick")
    p.add_argument("--events", default=None,
                   help="write the request-span EventLog here (.jsonl)")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only quantized block weights")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--resident", choices=["auto", "on", "off"],
                   default="auto",
                   help="run up to --resident-chunks decode chunks per "
                        "launch with on-device done-masking and early "
                        "exit (auto: on for cuda, off on cpu)")
    p.add_argument("--resident-chunks", type=int, default=8,
                   help="max decode chunks per resident launch")
    p.add_argument("--spec-tokens", type=int, default=None,
                   help="speculative decode: K-token draft/verify per "
                        "resident round (needs --resident on/auto-on)")
    p.add_argument("--draft", choices=["ngram", "truncated", "tree"],
                   default="ngram",
                   help="draft source for --spec-tokens: prompt-history "
                        "n-gram lookup (free), truncated-pipeline "
                        "(first --draft-stages stages + tied embedding "
                        "head), or multi-branch tree")
    p.add_argument("--draft-stages", type=int, default=1,
                   help="stage depth of the truncated/tree draft — a "
                        "STRICT prefix of the model (with --stages 1 "
                        "the model is partitioned into draft-stages+1 "
                        "logical stages to carve one)")
    p.add_argument("--spec-branches", type=int, default=None,
                   help="tree draft: parallel branches per round (>= 2)")
    p.add_argument("--spec-adaptive", action="store_true",
                   help="per-slot acceptance-EWMA adaptive K over a "
                        "small ladder of round depths")
    p.add_argument("--kv", choices=["slab", "paged"], default="slab",
                   help="KV memory: per-slot slab, or the paged block pool "
                        "(shared-prefix reuse + chunked prefill)")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="rows per KV block with --kv paged")
    p.add_argument("--kv-pool-blocks", type=int, default=None,
                   help="pool size in blocks with --kv paged (default: the "
                        "slab's row footprint)")
    p.add_argument("--kv-offload", action="store_true",
                   help="with --kv paged: spill cold refcount-0 blocks to "
                        "host RAM under pressure and restore them on "
                        "re-reference instead of hard-evicting")
    p.add_argument("--kv-offload-blocks", type=int, default=None,
                   help="host store capacity in blocks for --kv-offload "
                        "(default: the device pool size)")
    # Not ported yet: each refused with rc 2 (see _NOT_PORTED).
    p.add_argument("--stages", type=int, default=1)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--fleet", default=None)
    p.add_argument("--journal", default=None)
    p.add_argument("--roles", default=None)
    p.add_argument("--placement", default=None)
    p.add_argument("--kv-hot-refs", type=int, default=None)
    p.add_argument("--metrics-port", type=int, default=None)
    p.add_argument("--trace-out", default=None)
    for name in ("ttft-p50", "ttft-p99", "e2e-p99", "goodput-min",
                 "deadline-miss-max", "shed-max"):
        p.add_argument(f"--slo-{name}", type=float, default=None)
    p.add_argument("--tick-budget-s", type=float, default=None)
    p.add_argument("--shed-ewma", type=float, default=None)
    p.add_argument("--family", choices=["lm", "gpt2"], default="lm")
    return p


def read_prompts(path: str, vocab: int):
    """Comma-separated token-id prompts, one per non-empty line, or
    UsageError."""
    if not os.path.isfile(path):
        raise UsageError(f"--prompts-file {path}: no such file")
    with open(path) as f:
        try:
            prompts = [[int(t) for t in ln.split(",") if t.strip()]
                       for ln in f if ln.strip()]
        except ValueError:
            raise UsageError(
                "prompts must be comma-separated integer token ids")
    if not prompts or any(not p or any(i < 0 or i >= vocab for i in p)
                          for p in prompts):
        raise UsageError(f"prompt ids must be in [0, {vocab})")
    return prompts


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import numpy as np

    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.obs.events import NULL_EVENT_LOG, EventLog
    from pipe_tpu_torch.obs.telemetry import (get_registry,
                                              host_overhead_per_token)
    from pipe_tpu_torch.serve import (BucketSpec, EngineDraining, QueueFull,
                                      RequestQueue, ServeEngine,
                                      SingleDeviceSlotBackend)

    try:
        for flag, is_set, item in _NOT_PORTED:
            if is_set(args):
                raise UsageError(f"{flag} is not ported to pipe_tpu_torch "
                                 f"yet (ROADMAP.md {item})")
        model_cfg, state = model_source(args, family_config(args))
        # a model draft runs "the first stage(s)": --stages 1 serves an
        # unpartitioned model, so split it into draft-stages+1 logical
        # stages (the same weights, grouped differently)
        n_model_stages = 1
        if args.draft != "ngram":
            n_model_stages = max(args.draft_stages, 1) + 1
        if model_cfg.n_layers % n_model_stages:
            raise UsageError(
                f"--draft {args.draft} with --stages 1 partitions the "
                f"model into --draft-stages + 1 = {n_model_stages} logical "
                f"stages, which must divide the model's "
                f"{model_cfg.n_layers} layers")
        vocab = model_cfg.vocab
        if args.prompts_file:
            prompts = read_prompts(args.prompts_file, vocab)
        else:
            if args.requests < 1:
                raise UsageError(
                    f"--requests must be >= 1, got {args.requests}")
            rng = np.random.RandomState(args.seed)
            lens = rng.choice((8, 12, 16, 24, 32), size=args.requests)
            prompts = [rng.randint(1, vocab, size=int(n)).tolist()
                       for n in lens]
        if args.eos is not None and not 0 <= args.eos < vocab:
            raise UsageError(f"--eos must be in [0, {vocab})")
        gen_cfg = GenerationConfig(max_new_tokens=args.max_new,
                                   temperature=args.temperature,
                                   top_k=args.top_k, eos_token_id=args.eos)
        if args.kv_offload and args.kv != "paged":
            raise UsageError("--kv-offload needs --kv paged (the slab has "
                             "no blocks to spill)")
        kv_kwargs = {} if args.kv == "slab" else {
            "kv_block_size": args.kv_block_size,
            "kv_pool_blocks": args.kv_pool_blocks,
            "kv_offload": args.kv_offload,
            "kv_offload_blocks": args.kv_offload_blocks}
        resident = {"auto": "auto", "on": True, "off": False}[args.resident]
        longest = max(len(p) for p in prompts)
        buckets = BucketSpec.pow2(min_len=min(8, longest), max_len=longest)
        model = build_model(args, model_cfg, state, n_stages=n_model_stages)
        # spec lane: verify-write slack on top of the request cap -- the
        # chunk writes branches x (K-1) rows past the accepted frontier
        spec_slack = ((args.spec_branches or 1) * (args.spec_tokens - 1)
                      if args.spec_tokens else 0)
        backend = SingleDeviceSlotBackend(
            model, num_slots=args.slots,
            max_len=buckets.max_len + args.max_new + spec_slack,
            gen=gen_cfg, buckets=buckets, decode_chunk=args.decode_chunk,
            resident=resident, resident_chunks=args.resident_chunks,
            spec_tokens=args.spec_tokens, draft=args.draft,
            draft_stages=args.draft_stages,
            spec_branches=args.spec_branches,
            spec_adaptive=args.spec_adaptive, **kv_kwargs)
        for p in prompts:
            backend.validate(len(p), gen_cfg.max_new_tokens)
        queue = RequestQueue(capacity=args.queue_capacity,
                             policy=args.policy)
    except (UsageError, ValueError, TypeError) as e:
        print(str(e), file=sys.stderr)
        return 2

    events = EventLog(args.events) if args.events else NULL_EVENT_LOG
    eng = ServeEngine(backend, queue, event_log=events)

    # Graceful drain on SIGTERM/SIGINT: live slots finish, queued work is
    # shed back to callers, new admissions stop — then a clean summary.
    import signal as _signal

    def _drain_handler(signum, frame):
        eng.drain()

    for _sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(_sig, _drain_handler)
        except (ValueError, OSError):
            pass  # not the main thread (embedded use) — skip handlers

    if args.prompts_file or args.rate <= 0:
        arrivals = [0.0] * len(prompts)
    else:
        rng = np.random.RandomState(args.seed + 1)
        arrivals = np.cumsum(
            rng.exponential(1.0 / args.rate, size=len(prompts))).tolist()

    t0 = time.monotonic()
    i = rejected = done = 0
    while i < len(prompts) or not eng.idle:
        if eng.draining:
            i = len(prompts)      # stop submitting; finish what's live
        now = time.monotonic() - t0
        while i < len(prompts) and arrivals[i] <= now:
            try:
                eng.submit(prompts[i], seed=args.seed + i,
                           timeout_s=args.timeout_s)
            except QueueFull:
                rejected += 1
            except EngineDraining:
                i = len(prompts)
                break
            i += 1
        if eng.idle and i < len(prompts):
            time.sleep(min(arrivals[i] - now, 0.005))
            continue
        for r in eng.tick():
            done += 1
            print(json.dumps({
                "request": r.request_id, "status": r.status,
                "finish_reason": r.finish_reason,
                "prompt_len": r.prompt_len, "tokens": r.tokens,
                "ttft_s": (round(r.ttft, 4)
                           if r.ttft is not None else None),
                "latency_s": round(r.latency, 4)}), flush=True)
    elapsed = time.monotonic() - t0

    snap = {k: v for k, v in get_registry().scalars().items()
            if k.startswith(("serve.", "resilience."))}
    summary = {
        "backend": type(backend).__name__,
        "device": str(backend.device),
        "finished": done, "rejected": rejected,
        "drained": eng.draining,
        "elapsed_s": round(elapsed, 3),
        "resident": backend.resident,
        "spec_tokens": backend.spec_tokens,
        "draft": args.draft if backend.spec_tokens else None,
        **{k: v for k, v in backend.program_stats().items()
           if k in ("kv", "decode_graph", "resident_graph")},
        "host_overhead_per_token_us": round(
            1e6 * host_overhead_per_token(), 2),
        "buckets": list(buckets.lengths), "metrics": snap}
    print(json.dumps({"summary": summary}))
    events.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
