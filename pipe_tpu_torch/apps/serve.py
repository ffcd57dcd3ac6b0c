"""Serving driver: the continuous-batching engine under a live workload.

Counterpart of the single-replica path of ``pipe_tpu/apps/serve.py``: runs
:class:`~pipe_tpu_torch.serve.ServeEngine` over the single-device slot
backend with ``--slots`` decode slots (the decode step captured in a CUDA
graph on the card). Workload: ``--prompts-file`` (comma-separated token-id
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
        [--tiny] [--seed S] [--device cuda|cpu]

Not ported yet, each refused with rc 2 and the ROADMAP.md item it waits
for: ``--stages > 1`` (the ring backend), ``--replicas``, ``--fleet``,
``--journal``, ``--roles``, ``--placement``, ``--kv-hot-refs``,
``--metrics-port``, ``--trace-out``, the ``--slo-*`` flags and the watchdog
flags (the fleet and its observability), ``--kv paged`` and its
``--kv-*`` flags, ``--resident on``, ``--spec-*`` and ``--draft*`` (the rest
of serving on one device), ``--family gpt2`` (the model zoo).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .generate import UsageError, build_model, model_source

_FLEET = "A.7, fleet/* and serve/router.py"
_OBS = "A.7, the rest of obs/* (fleet observability)"
_PAGED = "A.6, serve/kvpool.py: the paged KV pool"
_SPEC = "A.6, inference/draft.py and the speculative lane"

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
    ("--kv paged", lambda a: a.kv != "slab", _PAGED),
    ("--kv-block-size/--kv-pool-blocks/--kv-offload*",
     lambda a: (a.kv_block_size is not None or a.kv_pool_blocks is not None
                or a.kv_offload or a.kv_offload_blocks is not None), _PAGED),
    ("--resident on", lambda a: a.resident == "on", "A.6, the resident loop"),
    ("--resident-chunks", lambda a: a.resident_chunks is not None,
     "A.6, the resident loop"),
    ("--spec-*", lambda a: (a.spec_tokens is not None
                            or a.spec_branches is not None
                            or a.spec_adaptive), _SPEC),
    ("--draft*", lambda a: a.draft is not None or a.draft_stages is not None,
     _SPEC),
    ("--family gpt2", lambda a: a.family != "lm", "A.10, the GPT-2 family"),
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
    p.add_argument("--kv", default="slab")
    p.add_argument("--kv-block-size", type=int, default=None)
    p.add_argument("--kv-pool-blocks", type=int, default=None)
    p.add_argument("--kv-offload", action="store_true")
    p.add_argument("--kv-offload-blocks", type=int, default=None)
    p.add_argument("--resident", choices=["auto", "on", "off"],
                   default="auto")
    p.add_argument("--resident-chunks", type=int, default=None)
    p.add_argument("--spec-tokens", type=int, default=None)
    p.add_argument("--spec-branches", type=int, default=None)
    p.add_argument("--spec-adaptive", action="store_true")
    p.add_argument("--draft", default=None)
    p.add_argument("--draft-stages", type=int, default=None)
    p.add_argument("--family", default="lm")
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
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    from pipe_tpu_torch.obs.events import NULL_EVENT_LOG, EventLog
    from pipe_tpu_torch.obs.telemetry import (get_registry,
                                              host_overhead_per_token)
    from pipe_tpu_torch.serve import (BucketSpec, EngineDraining, QueueFull,
                                      RequestQueue, ServeEngine,
                                      SingleDeviceSlotBackend)

    model_cfg = LMConfig().tiny() if args.tiny else LMConfig()
    try:
        for flag, is_set, item in _NOT_PORTED:
            if is_set(args):
                raise UsageError(f"{flag} is not ported to pipe_tpu_torch "
                                 f"yet (ROADMAP.md {item})")
        model_cfg, state = model_source(args, model_cfg)
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
        longest = max(len(p) for p in prompts)
        buckets = BucketSpec.pow2(min_len=min(8, longest), max_len=longest)
        model = build_model(args, model_cfg, state)
        backend = SingleDeviceSlotBackend(
            model, num_slots=args.slots,
            max_len=buckets.max_len + args.max_new, gen=gen_cfg,
            buckets=buckets, decode_chunk=args.decode_chunk)
        queue = RequestQueue(capacity=args.queue_capacity,
                             policy=args.policy)
    except (UsageError, ValueError) as e:
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
        "resident": False,
        "decode_graph": backend.program_stats()["decode_graph"],
        "host_overhead_per_token_us": round(
            1e6 * host_overhead_per_token(), 2),
        "buckets": list(buckets.lengths), "metrics": snap}
    print(json.dumps({"summary": summary}))
    events.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
