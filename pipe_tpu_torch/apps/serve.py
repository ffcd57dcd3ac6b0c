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

``--replicas N`` serves through the fleet instead (``pipe_tpu``'s): N
replicas behind one front queue with health-gated failover; the summary gains
per-replica lines and a fleet rollup, and SIGTERM drains the whole fleet.
``--fleet`` picks the replica transport: ``inproc`` (default; engines in this
process, ticked serially), ``thread`` (one tick thread per engine) or
``proc`` (each replica a child process, ``python -m
pipe_tpu_torch.fleet.proc``, on ``--device``; needs ``--family lm`` without
``--resume`` or ``--spec-tokens``: the child rebuilds the model from the
config and ``--seed``). ``--roles prefill,decode,...`` (or ``auto``) splits
the fleet by phase, ``--placement least_loaded|session|prefix`` and
``--kv-hot-refs`` steer placement by KV prefix, ``--journal DIR`` (``--fleet
proc`` only) keeps the fsync'd request journal a restarted controller
recovers from. The observability plane rides along: ``--metrics-port``
serves ``/metrics`` (Prometheus text), ``/slo`` and ``/fleet`` (JSON) on
127.0.0.1, ``--slo-*`` targets are scored into ``summary["slo"]``, and
``--trace-out`` writes the stitched per-request traces as JSONL.
``--tick-budget-s`` and ``--shed-ewma`` arm the engines' tick watchdog.

Usage:
    python -m pipe_tpu_torch.apps.serve [--resume DIR] [--requests N --rate R]
        [--prompts-file F] [--slots S] [--max-new N] [--temperature T]
        [--top-k K] [--eos ID] [--queue-capacity C] [--policy fifo|priority]
        [--timeout-s T] [--decode-chunk K] [--events F.jsonl] [--int8]
        [--kv slab|paged] [--kv-block-size B] [--kv-pool-blocks N]
        [--kv-offload] [--kv-offload-blocks N] [--resident auto|on|off]
        [--resident-chunks R] [--spec-tokens K] [--draft ngram|truncated|tree]
        [--draft-stages N] [--spec-branches B] [--spec-adaptive]
        [--replicas N] [--fleet inproc|thread|proc] [--journal DIR]
        [--roles R,R,...|auto] [--placement least_loaded|session|prefix]
        [--kv-hot-refs N] [--metrics-port P] [--trace-out F.jsonl]
        [--slo-ttft-p50 S] [--slo-ttft-p99 S] [--slo-e2e-p99 S]
        [--slo-goodput-min F] [--slo-deadline-miss-max F] [--slo-shed-max F]
        [--tick-budget-s S] [--shed-ewma F]
        [--tiny] [--seed S] [--device cuda|cpu]

A model draft (``--draft truncated|tree``) is a strict prefix of the model:
with ``--stages 1`` the model is partitioned into ``--draft-stages + 1``
logical stages to carve it, as ``pipe_tpu`` does. ``--stages N`` (N > 1)
serves over a ring of N stage ranks that the app spawns
(``runtime.distributed.launch``, backend ``gloo``; on the card they share
it), each holding its stage of the model: the engine runs on rank 0 over
``RingSlotBackend`` (``serve/ring.py``), whose N slots are the ring's
groups (``--slots`` is not read); ``--kv paged``, ``--resident`` and
``--spec-tokens`` (``--draft ngram|truncated``) come through, with
``pipe_tpu``'s refusals; ``--replicas`` with it exits 2 naming ROADMAP.md
A.8, the mesh carve.
``--family gpt2`` serves ``PipelinedGPT2`` (fresh
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



def _start_metrics_server(port, registry_fn, slo, observer):
    """Daemon-thread HTTP server on 127.0.0.1 exposing the fleet
    observability plane: ``/metrics`` renders ``registry_fn()`` as
    Prometheus text, ``/slo`` the verdict JSON, ``/fleet`` the per-replica
    JSON view. Returns the server (``.server_address[1]`` is the bound
    port)."""
    import http.server
    import threading

    from pipe_tpu_torch.obs.fleet_obs import prometheus_text

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
            try:
                if path == "/metrics":
                    body = prometheus_text(registry_fn()).encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/slo":
                    body = json.dumps(slo.verdict(registry_fn())).encode()
                    ctype = "application/json"
                elif path == "/fleet":
                    per = (observer.per_replica()
                           if observer is not None else {})
                    body = json.dumps(
                        {str(k): v for k, v in per.items()}).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
            except Exception as e:               # surface, don't crash
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):               # keep stdout JSON-clean
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="metrics-http").start()
    return srv


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
    p.add_argument("--stages", type=int, default=1,
                   help=">1: serve over a ring of this many stage ranks "
                        "(serve/ring.py; the ring's groups are the slots)")
    p.add_argument("--replicas", type=int, default=1,
                   help=">1: run N engine replicas behind the fleet "
                        "Router (health-gated failover)")
    p.add_argument("--fleet", choices=["inproc", "thread", "proc"],
                   default="inproc",
                   help="replica transport with --replicas > 1: same-"
                        "process serial ticks (inproc), one tick thread "
                        "per replica (thread), or one OS process per "
                        "replica (proc)")
    p.add_argument("--journal", default=None,
                   help="directory for the durable request journal "
                        "(fsync'd lifecycle log; a crashed controller "
                        "restarts from it via FleetController."
                        "from_journal). --fleet proc only")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the merged fleet registry on "
                        "127.0.0.1:<port>: /metrics (Prometheus text), "
                        "/slo (verdict JSON), /fleet (per-replica JSON). "
                        "0 picks a free port (printed to stderr)")
    p.add_argument("--trace-out", default=None,
                   help="with --replicas > 1: write the stitched "
                        "per-request trace timelines here (.jsonl)")
    p.add_argument("--slo-ttft-p50", type=float, default=None,
                   help="SLO target: TTFT p50 seconds")
    p.add_argument("--slo-ttft-p99", type=float, default=None,
                   help="SLO target: TTFT p99 seconds")
    p.add_argument("--slo-e2e-p99", type=float, default=None,
                   help="SLO target: end-to-end latency p99 seconds")
    p.add_argument("--slo-goodput-min", type=float, default=None,
                   help="SLO target: minimum ok/delivered fraction")
    p.add_argument("--slo-deadline-miss-max", type=float, default=None,
                   help="SLO target: max timed_out/delivered fraction")
    p.add_argument("--slo-shed-max", type=float, default=None,
                   help="SLO target: max shed/delivered fraction")
    p.add_argument("--tick-budget-s", type=float, default=None,
                   help="watchdog: count ticks slower than this "
                        "(resilience.watchdog_slow_ticks)")
    p.add_argument("--shed-ewma", type=float, default=None,
                   help="watchdog: deadline-miss EWMA above which "
                        "lowest-priority queued requests are shed")
    p.add_argument("--placement",
                   choices=["least_loaded", "session", "prefix"],
                   default="least_loaded",
                   help="fleet placement: least_loaded, session pinning, "
                        "or prefix (score replicas by matched prefix depth "
                        "x occupancy headroom)")
    p.add_argument("--kv-hot-refs", type=int, default=None,
                   help="fleet: replicate prefixes shared by at least N "
                        "live slots to a sibling proactively (requires "
                        "--kv paged; >= 2)")
    p.add_argument("--roles", default=None,
                   help="disaggregated fleet: comma-separated per-replica "
                        "roles (prefill|decode|mixed), length == "
                        "--replicas, e.g. 'prefill,decode,decode', or "
                        "'auto' (suggest_roles). Pair with --kv paged so "
                        "decode replicas resume from shipped blocks")
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


def _fleet_checks(args, prompts):
    """``pipe_tpu``'s fleet argument checks, with its messages: the roles
    list (``auto`` sized by ``suggest_roles``), or None. UsageError."""
    replicas = max(args.replicas, 1)
    if (args.kv_hot_refs is not None or args.placement == "prefix") \
            and args.kv != "paged":
        raise UsageError("--kv-offload/--kv-hot-refs/--placement prefix "
                         "need --kv paged (the slab has no blocks to "
                         "spill, share, or advertise)")
    roles = None
    if args.roles:
        if args.roles == "auto":
            from pipe_tpu_torch.fleet import suggest_roles
            roles = suggest_roles(
                replicas, prompt_len=max(len(p) for p in prompts),
                max_new_tokens=args.max_new).roles
        else:
            roles = [r.strip() for r in args.roles.split(",")]
        bad = [r for r in roles if r not in ("prefill", "decode", "mixed")]
        if bad or len(roles) != replicas:
            raise UsageError(
                f"--roles must name one of prefill|decode|mixed per "
                f"replica ({replicas} expected, got {roles})")
        if replicas < 2:
            raise UsageError("--roles needs --replicas >= 2 (one replica "
                             "cannot be split by phase)")
    if args.journal and not (replicas > 1 and args.fleet == "proc"):
        # the journal recovers a crashed controller; in-process engines
        # die WITH their controller, so journaling them would promise a
        # restart that cannot happen
        raise UsageError("--journal requires --fleet proc with --replicas "
                         "> 1 (only the process fleet survives its "
                         "controller)")
    if replicas > 1 and args.fleet == "proc" and (
            args.family != "lm" or args.resume or args.spec_tokens):
        raise UsageError("--fleet proc requires --family lm without "
                         "--resume/--spec-tokens (children rebuild the "
                         "model from the spec + seed)")
    return roles


def _build_fleet(args, roles, model, model_cfg, backend, backend_kw,
                 events):
    """The fleet front (``Router``, ``FleetController`` or
    ``DisaggController``) over ``--replicas`` replicas, and the journal
    (or None). Process replicas are spawned one after another, each
    waiting for its child's ready frame, as ``pipe_tpu`` does."""
    from pipe_tpu_torch.serve import (RequestQueue, Router, RouterPolicy,
                                      ServeEngine, SingleDeviceSlotBackend)

    policy = RouterPolicy(placement=args.placement,
                          kv_hot_refs=args.kv_hot_refs)
    queue = RequestQueue(capacity=args.queue_capacity, policy=args.policy)
    if args.fleet == "proc":
        import dataclasses

        from pipe_tpu_torch.fleet import (DisaggController, FleetController,
                                          ProcessReplicaTransport,
                                          ReplicaSpec, RequestJournal)
        b = backend
        spec = ReplicaSpec(
            lm_cfg={f: getattr(model_cfg, f)
                    for f in ("vocab", "d_model", "nhead", "d_ff",
                              "n_layers", "dropout", "seq_len")},
            n_stages=1, init_seed=args.seed, num_slots=args.slots,
            max_len=b.max_len, buckets=list(b.buckets.lengths),
            decode_chunk=args.decode_chunk,
            queue_capacity=args.queue_capacity,
            gen=dict(max_new_tokens=args.max_new,
                     temperature=args.temperature, top_k=args.top_k,
                     eos_token_id=args.eos),
            device=str(b.device),
            **({"kv_block_size": args.kv_block_size,
                "kv_pool_blocks": args.kv_pool_blocks,
                "kv_offload": args.kv_offload,
                "kv_offload_blocks": args.kv_offload_blocks,
                "kv_hot_refs": args.kv_hot_refs}
               if args.kv == "paged" else {}))
        transports = []
        try:
            for role in (roles or ["mixed"] * args.replicas):
                transports.append(ProcessReplicaTransport(
                    dataclasses.replace(spec, role=role)))
        except Exception:
            for tr in transports:
                tr.close()
            raise
        journal = RequestJournal(args.journal) if args.journal else None
        ctl_cls = DisaggController if roles is not None else FleetController
        eng = ctl_cls(transports, queue, policy=policy, event_log=events,
                      journal=journal)
        if journal is not None:
            # each child's wire coordinates (and the fleet.json snapshot)
            # so a restarted controller re-dials the RUNNING children
            for i, tr in enumerate(transports):
                journal.record_replica(i, **tr.rejoin_info())
        return eng, journal
    # in-process fleet: one front queue, N engines each with its own queue
    # and watchdog; --fleet thread gives each its own tick thread
    backends = [backend] + [SingleDeviceSlotBackend(model, **backend_kw)
                            for _ in range(args.replicas - 1)]
    engines = [ServeEngine(b, RequestQueue(capacity=args.queue_capacity),
                           event_log=events, watchdog=_watchdog(args),
                           phase=roles[i] if roles is not None else "mixed")
               for i, b in enumerate(backends)]
    if roles is not None:
        from pipe_tpu_torch.fleet import DisaggController, InProcessTransport
        return DisaggController(
            [InProcessTransport(e, async_tick=(args.fleet == "thread"))
             for e in engines], queue, event_log=events, policy=policy), None
    return Router(engines, queue, event_log=events, policy=policy,
                  async_tick=(args.fleet == "thread")), None


def _watchdog(args):
    if args.tick_budget_s is None and args.shed_ewma is None:
        return None
    from pipe_tpu_torch.resilience import TickWatchdog
    return TickWatchdog(tick_budget_s=args.tick_budget_s,
                        shed_ewma_threshold=args.shed_ewma)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.stages > 1:
        return _main_ring(args, list(sys.argv[1:] if argv is None
                                     else argv))
    return _serve(args)


def _main_ring(args, argv) -> int:
    """``--stages N``: a world of N ranks (``runtime.distributed.launch``,
    backend ``gloo``; on the card they share it), each holding its stage of
    the model. The engine runs on rank 0 over the ring backend
    (``serve/ring.py``) and its output is printed here; the other ranks
    follow the ring. The flags' checks run on every rank, as on one
    device."""
    if args.replicas > 1:
        print("--replicas with --stages > 1 is not ported to pipe_tpu_torch "
              "yet (ROADMAP.md A.8, the mesh carve of fleet/topology.py: "
              "runtime/distributed.py)", file=sys.stderr)
        return 2
    from pipe_tpu_torch.runtime.distributed import launch

    threads = (max(1, (os.cpu_count() or 1) // args.stages)
               if args.device == "cpu" else 0)
    rc, out, err = launch(_ring_rank, args.stages, argv, device=args.device,
                          backend="gloo", threads=threads)[0]
    sys.stdout.write(out)
    sys.stderr.write(err)
    return rc


def _ring_rank(argv) -> tuple:
    """One rank of ``--stages N``: rank 0 serves (its output captured and
    returned as ``(rc, stdout, stderr)``), the others follow the ring."""
    import contextlib
    import io

    from pipe_tpu_torch.parallel.mesh import make_mesh

    args = build_argparser().parse_args(argv)
    mesh = make_mesh(args.stages, 1)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = _serve(args, mesh)
    return rc, out.getvalue(), err.getvalue()


def _serve(args, mesh=None) -> int:
    """The serving flow on this process: one device, or with ``mesh`` this
    rank's stage of the ring (rank 0 drives the engine; the others run the
    follower loop and return)."""
    import numpy as np

    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.obs.events import NULL_EVENT_LOG, EventLog
    from pipe_tpu_torch.obs.fleet_obs import (FleetObserver, SloMonitor,
                                              SloTargets, TraceBuffer)
    from pipe_tpu_torch.obs.telemetry import (get_registry,
                                              host_overhead_per_token)
    from pipe_tpu_torch.serve import (BucketSpec, EngineDraining, QueueFull,
                                      RequestQueue, ServeEngine,
                                      SingleDeviceSlotBackend)

    replicas = max(args.replicas, 1)
    try:
        model_cfg, state = model_source(args, family_config(args))
        # a model draft runs "the first stage(s)": --stages 1 serves an
        # unpartitioned model, so split it into draft-stages+1 logical
        # stages (the same weights, grouped differently)
        n_model_stages = 1
        if mesh is not None:
            n_model_stages = mesh.n_stages
        elif args.draft != "ngram":
            n_model_stages = max(args.draft_stages, 1) + 1
        if mesh is not None and model_cfg.n_layers % n_model_stages:
            raise UsageError(f"--stages {n_model_stages} must divide the "
                             f"model's {model_cfg.n_layers} layers")
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
        roles = _fleet_checks(args, prompts)
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
        backend_kw = dict(
            num_slots=args.slots,
            max_len=buckets.max_len + args.max_new + spec_slack,
            gen=gen_cfg, buckets=buckets, decode_chunk=args.decode_chunk,
            resident=resident, resident_chunks=args.resident_chunks,
            spec_tokens=args.spec_tokens, draft=args.draft,
            draft_stages=args.draft_stages,
            spec_branches=args.spec_branches,
            spec_adaptive=args.spec_adaptive, **kv_kwargs)
        if mesh is None:
            backend = SingleDeviceSlotBackend(model, **backend_kw)
        else:
            from pipe_tpu_torch.inference.pipelined import localize_stage
            from pipe_tpu_torch.serve import RingSlotBackend

            ring_kw = dict(backend_kw)
            for name, ring_name in (("decode_chunk", "revolutions"),
                                    ("resident_chunks",
                                     "resident_revolutions")):
                ring_kw[ring_name] = ring_kw.pop(name)
            del ring_kw["num_slots"]
            backend = RingSlotBackend(mesh, localize_stage(model, mesh),
                                      **ring_kw)
        for p in prompts:
            backend.validate(len(p), gen_cfg.max_new_tokens)
    except (UsageError, ValueError, TypeError,
            NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if mesh is not None and not backend.is_driver:
        backend.follow()
        return 0

    trace_buf = None
    if args.events:
        events = EventLog(args.events)
    elif args.trace_out and replicas > 1:
        # --trace-out without --events: hold the parent-side request
        # skeleton (queued/placed/delivered) in memory, or the stitched
        # timelines would carry child-side stages only
        trace_buf = TraceBuffer(maxlen=200_000)
        events = trace_buf
    else:
        events = NULL_EVENT_LOG

    journal = None
    if replicas > 1:
        eng, journal = _build_fleet(args, roles, model, model_cfg, backend,
                                    backend_kw, events)
    else:
        queue = RequestQueue(capacity=args.queue_capacity,
                             policy=args.policy)
        eng = ServeEngine(backend, queue, event_log=events,
                          watchdog=_watchdog(args))

    # the observability plane: the observer merges the replicas' metrics
    # into one rollup registry, the SLO monitor scores it, and
    # --metrics-port serves both live
    slo = SloMonitor(SloTargets(
        ttft_p50_s=args.slo_ttft_p50, ttft_p99_s=args.slo_ttft_p99,
        e2e_p99_s=args.slo_e2e_p99, goodput_min=args.slo_goodput_min,
        deadline_miss_max=args.slo_deadline_miss_max,
        shed_max=args.slo_shed_max))
    observer = FleetObserver(eng, parent_events=(args.events or trace_buf)) \
        if replicas > 1 else None

    def _fleet_registry():
        return observer.rollup() if observer is not None \
            else get_registry()

    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = _start_metrics_server(
            args.metrics_port, _fleet_registry, slo, observer)
        print(f"metrics: http://127.0.0.1:"
              f"{metrics_server.server_address[1]}/metrics",
              file=sys.stderr, flush=True)

    # Graceful drain on SIGTERM/SIGINT: live slots finish, queued work is
    # shed back to callers, new admissions stop -- then a clean summary.
    # With --replicas this drains the whole fleet.
    import signal as _signal

    def _drain_handler(signum, frame):
        eng.drain()

    for _sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(_sig, _drain_handler)
        except (ValueError, OSError):
            pass  # not the main thread (embedded use) -- skip handlers

    if args.prompts_file or args.rate <= 0:
        arrivals = [0.0] * len(prompts)
    else:
        rng = np.random.RandomState(args.seed + 1)
        arrivals = np.cumsum(
            rng.exponential(1.0 / args.rate, size=len(prompts))).tolist()

    t0 = time.monotonic()
    i = rejected = done = 0
    try:
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
    except BaseException:
        if replicas > 1:
            eng.close()       # stop tick threads, end the child processes
        raise
    elapsed = time.monotonic() - t0

    snap = {k: v for k, v in get_registry().scalars().items()
            if k.startswith(("serve.", "resilience."))}
    summary = {
        "backend": (f"Fleet[{args.fleet}]({type(backend).__name__} x "
                    f"{replicas})"
                    if replicas > 1 else type(backend).__name__),
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
    summary["slo"] = slo.verdict(_fleet_registry())
    if replicas > 1:
        def _rep_line(rep):
            line = {"replica": rep.index, "state": rep.state}
            try:
                # a retired process transport may be gone
                line["queue_depth"] = rep.transport.queue_depth
                line["live_slots"] = rep.transport.live_slots
            except Exception:
                line["queue_depth"] = line["live_slots"] = None
            return line
        summary["fleet"] = {
            "transport": args.fleet,
            "rollup": eng.counts(),
            "per_replica": [_rep_line(rep) for rep in eng.replicas]}
        eng.close()   # stops tick threads / shuts replica processes down
        # after close: the children ship their final obs deltas on the
        # shutdown RPC, and every read below is parent-side state
        if observer is not None:
            per = observer.per_replica()
            summary["fleet"]["staleness_s"] = {
                str(i): v["staleness_s"] for i, v in per.items()}
            summary["fleet"]["reconcile"] = observer.reconcile()
            summary["slo"] = slo.verdict(_fleet_registry())
            if args.trace_out:
                events.flush()
                summary["fleet"]["trace_records"] = \
                    observer.write_stitched(args.trace_out)
    if journal is not None:
        # the loop ran to quiescence: everything submitted is terminal,
        # so a restart on this journal skips reconciliation
        journal.close(clean=True)
    print(json.dumps({"summary": summary}))
    if mesh is not None:
        backend.close()
    events.close()
    if metrics_server is not None:
        metrics_server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
