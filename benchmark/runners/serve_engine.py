"""Serving cells through the port's ``ServeEngine`` over
``SingleDeviceSlotBackend`` (paged KV, the resident decode loop, greedy).

Open loop: each request is submitted when it falls due, whatever the
engine is doing, and its time to first token is taken from when it was
due, so a stall counts against every request that waited behind it. The
window is ``--seconds`` long; afterwards the engine drains what is left
(a minute at most), the requests' tails come from every request due in the
window, and a request that never finishes counts as failed. A traced run
profiles the last ``profile_s`` of the window and reads its rates from the
part before it.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from harness import checks, core, trace, traffic

KIND = "serve"


def logits_fn(plan):
    """The plain reference's logits ``(weights, tokens)`` of the model."""
    ref, cfg = plan.reference(), plan.config
    return lambda w, t: ref.logits(w, t, cfg)


def build(plan, weights, seed: int, device):
    """The cell's model, backend and engine, holding the benchmark's
    weights."""
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.models.gpt2 import PipelinedGPT2
    from pipe_tpu_torch.serve import (ServeEngine, SingleDeviceSlotBackend)
    from pipe_tpu_torch.serve.queue import RequestQueue

    cfg, cell = plan.config, plan.cell
    adapter = core.load_module(plan.root / "benchmark" / "adapters"
                               / f"{cfg['family']}.py")
    model = PipelinedGPT2(
        adapter.model_config(cfg), device=device,
        generator=torch.Generator(device=device).manual_seed(seed))
    adapter.load(list(model.children()), weights)
    backend = SingleDeviceSlotBackend(
        model, num_slots=cell["slots"], max_len=cell["max_len"],
        gen=GenerationConfig(max_new_tokens=cell["output"]["max"],
                             temperature=0.0),
        kv_block_size=cell["kv_block_size"], resident=cell["resident"])
    queue = RequestQueue(capacity=1 << 30, clock=time.perf_counter)
    return model, backend, ServeEngine(backend, queue)


class Timing:
    """Host clock, with a synchronise on each side, around the backend's
    decode launches and prefills while ``on``."""

    def __init__(self, backend, device):
        self.on = False
        self.decode_calls = self.prefill_tokens = 0
        self.decode_s = self.prefill_s = 0.0
        cuda = torch.device(device).type == "cuda"
        decode, prefill = backend.decode, backend.prefill

        def sync():
            if cuda:
                torch.cuda.synchronize()

        def timed_decode(*a, **kw):
            if not self.on:
                return decode(*a, **kw)
            sync()
            t = time.perf_counter()
            out = decode(*a, **kw)
            sync()
            self.decode_s += time.perf_counter() - t
            self.decode_calls += 1
            return out

        def timed_prefill(slot, prompt, *a, **kw):
            if not self.on:
                return prefill(slot, prompt, *a, **kw)
            sync()
            t = time.perf_counter()
            out = prefill(slot, prompt, *a, **kw)
            sync()
            self.prefill_s += time.perf_counter() - t
            self.prefill_tokens += len(prompt)
            return out

        backend.decode, backend.prefill = timed_decode, timed_prefill


def _counters():
    from pipe_tpu_torch.obs.telemetry import get_registry

    reg = get_registry()
    return {"tokens": reg.counter("serve.engine.tokens").value,
            "admitted": reg.counter("serve.engine.admitted").value,
            "host_s": reg.timer("serve.engine.host_sec").total}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def drive(engine, schedule, seconds: float, *, profile_s: float = 0.0,
          timing: Timing = None, drain_s: float = 60.0) -> dict:
    """Offer ``schedule`` for ``seconds``; then drain. Returns the
    submitted requests with their due times, the counters over the window
    (and over its unprofiled part), the queue depth after each tick, the
    generator's lag and the profiled stretch."""
    subs, depth, lag = [], [], 0.0
    stretch, part = None, None
    i, n = 0, len(schedule)
    if timing is not None:
        timing.on = True
    start = _counters()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        while i < n and t0 + schedule[i].due_s <= now:
            a = schedule[i]
            req = engine.submit(a.prompt, max_new_tokens=a.max_new, seed=i)
            subs.append((t0 + a.due_s, req))
            lag = max(lag, req.submitted_at - (t0 + a.due_s))
            i += 1
        if now - t0 >= seconds:
            break
        if profile_s and stretch is None and now - t0 >= seconds - profile_s:
            part = _delta(start, _counters())
            if timing is not None:
                timing.on = False
            stretch = trace.Stretch().__enter__()
        if engine.idle:
            nxt = t0 + schedule[i].due_s if i < n else t0 + seconds
            time.sleep(max(0.0, min(nxt - time.perf_counter(), 0.0005)))
            continue
        engine.tick()
        depth.append((time.perf_counter() - t0, engine.queue.depth))
    t_end = time.perf_counter()
    window = _delta(start, _counters())
    if stretch is not None:
        stretch.__exit__(None, None, None)
    if timing is not None:
        timing.on = False
    if part is None:
        part = window
    deadline = time.perf_counter() + drain_s
    while not engine.idle and time.perf_counter() < deadline:
        engine.tick()
    return {"subs": subs, "t0": t0, "window_s": t_end - t0,
            "counters": window, "part": part,
            "depth": depth, "lag_s": lag, "stretch": stretch}


def ttfts(engine, subs) -> list:
    """Time to first token from each request's due time; ``inf`` for one
    that produced no token."""
    out = []
    for due, req in subs:
        resp = engine.response(req.id)
        if resp is None or resp.status != "ok" or resp.ttft is None:
            out.append(math.inf)
        else:
            out.append(req.submitted_at + resp.ttft - due)
    return out


def percentile(values, q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def sample(engine, subs, seed: int, min_tokens: int) -> list:
    """Finished requests for the check, drawn from ``seed``: the longest
    (prompt and served tokens), then others until ``min_tokens`` served
    tokens are in."""
    done = []
    for _, req in subs:
        resp = engine.response(req.id)
        if resp is not None and resp.status == "ok" and resp.tokens:
            done.append((list(req.prompt), list(resp.tokens)))
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda j: len(done[j][0]) + len(done[j][1]))
    rng = np.random.default_rng([seed, 3])
    order = [longest] + [int(j) for j in rng.permutation(len(done))
                         if j != longest]
    picked, served = [], 0
    for j in order:
        if served >= min_tokens:
            break
        picked.append(done[j])
        served += len(done[j][1])
    return picked


def reference_gaps(logits, weights, picked, device, tf32: bool = False):
    """For each picked (prompt, served): the reference's logits over the
    prompt and the served tokens, and the gap of each served token below
    the best at its position. With ``tf32`` the gap is that of the token
    the TF32 reference puts first (the control)."""
    from harness import plain

    gaps = []
    weights = {n: w.to(device) for n, w in weights.items()}
    with torch.no_grad():
        for prompt, served in picked:
            seq = torch.tensor([prompt + served[:-1]], device=device)
            pos = torch.arange(len(prompt) - 1, seq.shape[1], device=device)
            with plain.matmul_precision(False):
                exact = logits(weights, seq)[0]
            if tf32:
                with plain.matmul_precision(True):
                    low = logits(weights, seq)[0]
                tokens = low[pos].argmax(dim=-1).tolist()
            else:
                tokens = served
            gaps.append(checks.served_gap(exact, pos, tokens))
    return gaps


def setup(plan, seed: int, device):
    """Weights, the engine, and a warm-up that captures every program the
    traffic uses (a burst of the cell's own lengths from another seed)."""
    cell = plan.cell
    ref = plan.reference()
    weights = ref.make_weights(plan.config, seed, device)
    model, backend, engine = build(plan, weights, seed, device)
    vocab = plan.config["vocab_size"]
    warm = traffic.serve_schedule(cell, seed + 1, 1.0, vocab,
                                  rate=cell["warmup_requests"])
    for a in warm:
        engine.submit(a.prompt, max_new_tokens=a.max_new)
    engine.run_until_idle()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return ref, weights, model, backend, engine


def run(plan, seed, seconds, trace_on, device, t_start):
    cell, cfg = plan.cell, plan.config
    cuda = torch.device(device).type == "cuda"
    _, weights, model, backend, engine = setup(plan, seed, device)
    # the benchmark's copy of the weights waits on the host, so that the
    # peak is the program's
    weights = {n: w.cpu() for n, w in weights.items()}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    schedule = traffic.serve_schedule(cell, seed, seconds, cfg["vocab_size"])
    timing = Timing(backend, device) if trace_on else None
    if trace_on and cuda:
        trace.warm_profiler()
    core.settle_host()
    setup_s = time.perf_counter() - t_start
    rec = drive(engine, schedule, seconds,
                profile_s=cell["profile_s"] if trace_on else 0.0,
                timing=timing, drain_s=cell["drain_s"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    lat = ttfts(engine, rec["subs"])
    failed = sum(not math.isfinite(x) for x in lat)
    picked = sample(engine, rec["subs"], seed, cell["check_tokens"])
    c = rec["counters"]
    generated = c["tokens"] + c["admitted"]
    del engine, backend, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = reference_gaps(logits_fn(plan), weights, picked, device)
    gap = max(gaps) if gaps else math.inf
    held = checks.held({"logit_gap": gap}, cell["limits"])
    summary = None
    if rec["stretch"] is not None:
        summary = rec["stretch"].summary()
    p95 = percentile(lat, 95) if lat else math.inf
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    part = rec["part"]
    ctx = {"serve": {"host_s": part["host_s"], "tokens": part["tokens"],
                     "decode_calls": timing.decode_calls if timing else 0,
                     "decode_s": timing.decode_s if timing else 0.0,
                     "prefill_s": timing.prefill_s if timing else 0.0,
                     "prefill_tokens": timing.prefill_tokens if timing
                     else 0},
           "trace": summary}
    info = {"requests_due": len(rec["subs"]), "requests_failed": failed,
            "rate_per_s": cell["rate_per_s"], "window_s": rec["window_s"],
            "generated_tokens": generated, "generator_lag_s": rec["lag_s"],
            "ttft_ms_p50": 1e3 * percentile(lat, 50) if lat else None,
            "checked_requests": len(picked),
            "checked_tokens": sum(len(s) for _, s in picked),
            "logit_gaps": gaps}
    return core.Outcome(
        correct=checks.passed(held) and failed == 0 and bool(picked),
        attempted=len(rec["subs"]), failed=failed, checks=held,
        end_to_end={"serve_tokens_per_s": generated / rec["window_s"],
                    "ttft_ms_p95": 1e3 * p95, "setup_s": setup_s},
        layer_ctx=ctx, device=device_info, info=info,
        breakdown=trace.breakdown(summary) if summary else None)
