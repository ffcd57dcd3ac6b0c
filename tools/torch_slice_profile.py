"""Where the time goes in pipe_tpu_torch's slices on one CUDA card.

    python3 tools/torch_slice_profile.py [--batches N] [--out DIR]
    python3 tools/torch_slice_profile.py --train [--steps N] [--out DIR]
    python3 tools/torch_slice_profile.py --train --schedule 1f1b|zb-h1|gpipe
        [--checkpoint never|except_last|always] [--remat-policy NAME]
        [--steps N] [--out DIR]
    python3 tools/torch_slice_profile.py --bert [--remat-policy NAME]
        [--steps N] [--out DIR]
    python3 tools/torch_slice_profile.py --generate [--decode-steps N]
        [--out DIR]
    python3 tools/torch_slice_profile.py --serve [--kv slab|paged]
        [--resident [--spec-tokens K [--draft ngram|truncated|tree]
        [--draft-stages N] [--spec-branches B]]] [--decode-steps N]
        [--out DIR]

Eval (default): builds the full-width tutorial LM and ``Pipe`` that
``chip_smoke.py`` drives (``make_slice``: d_model 2048, 32 heads, d_ff 2048,
16 layers, bptt 128, eval batch 8, chunks 4, 2 stages), then

1. times the eval forward of N batches with ``attn_impl="flash"`` (the CUDA
   kernel) and with ``"xla"`` (plain attention) on the same weights, in turns
   flash, xla, xla, flash (host clock around work that ends in a synchronize);
2. profiles one flash pass with ``torch.profiler`` (CPU + CUDA) and reports
   the device's busy time (union of kernel intervals), its idle share of the
   window, and kernel time by category and by name.

``--train``: the same for training steps of ``Trainer`` over that LM with
dropout 0.2 (batch 32, bptt 128, chunks 4, 2 stages, except_last, lr 1e-4,
as ``chip_smoke.py``'s train phase): N steps timed per turn with the kernels
and with plain attention, then one kernel step profiled, with the forward
kernel, dQ, dK/dV, GEMMs, copies and the optimizer as categories.

``--train --schedule S``: the same LM and batch through the table executor
(``Trainer(schedule=S)``; ``gpipe`` runs the gpipe table) under
``--checkpoint`` (default except_last): N steps timed per turn against the
emulator ``Pipe`` step of the plain ``--train`` (except_last), in turns
table, pipe, pipe, table, then one table step profiled; besides the kernel
categories it reports the device time of the kernels launched inside the
executor's ranges (the backward's from the autograd thread included): ``F``,
``B`` and ``W`` ops, and inside them the post's forward at F (``post-F``)
and its rebuilt forward and backward at B (``post-B``), the work the
one-device walk does that GPipe does not (with zb-h1's second backward
walk, ``W``); and the device's idle share against the fastest unprofiled
step (the profiler stretches the traced window). With ``--remat-policy``
the turns are the table with the policy (profiled) against the same table
without one, and the policy-free step is profiled too
(``without_policy``).

``--bert``: BERT-large at full width through the interleaved-1F1B table as
``chip_smoke.py``'s bert phase runs it (8 stages x 3, chunks 32, batch 32 x
512, except_last, dropout 0.1, Adam at lr 1e-4): N steps timed in turns
with ``--remat-policy`` (default none) and without, then one step of each
profiled; the summary has no per-kernel trace (a step launches ~10^5
kernels) but the busy time, idle share against the unprofiled step and the
kernel time by category.

``--generate``: KV-cached generation over that LM's weights as
``chip_smoke.py``'s generate phase runs it (batch 8, 128-token prompts from
the eval split, greedy): for fp32 and for int8 weights, the wall time of a
prefill alone and of a prefill plus N decode steps (default 32), in turns
fp32, int8, int8, fp32, then both windows profiled; launches and device
busy time per decode step are the difference of the two windows over N,
the idle share and kernel time by category are the longer window's, and
``decode_idle_share_unprofiled`` sets the busy time per step against the
unprofiled step time.

``--serve``: the serve engine's decode tick as ``chip_smoke.py``'s serve
phase runs it (``SingleDeviceSlotBackend``: 8 slots, 256 cache rows, fp32,
over the eval weights; every slot prefilled with 128 eval tokens): N ticks
(default 32) with the decode step replayed from its CUDA graph and N run
eagerly on the card, timed in turns graph, eager, eager, graph, then each
window profiled (launches, device busy time, idle share and kernel time by
category, per tick), and one 128-token prefill profiled (what TTFT pays
beside queueing). ``--kv paged`` serves from the paged pool (blocks of 16
rows, chunked prefill, decode on per-slot views) and also profiles the
prefill's epilogue alone (the first token and the admitted slot's view
refresh from the pool: the port's regather). ``--resident`` replaces each
tick with one resident launch of ``resident_chunks`` (8) chunks, every slot
live with an unbounded budget, and reports per launch and per step.
``--spec-tokens K`` makes each chunk a speculative draft/verify round of K
tokens (``--draft``, default ngram; a truncated or tree draft over the
first ``--draft-stages`` of ``--draft-stages + 1`` logical stages), over
``chip_smoke.py``'s spec-phase cache of 272 rows, and reports per round.
Positions then run past the cache within a window; the rows a round
computes, and so its device time, do not depend on them.

Prints one JSON summary as its last line and writes it, with the chrome
trace, under ``--out`` (default ``build/profile/``).
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_CATEGORIES = (
    ("flash_attn_fwd", ("flash_fwd_kernel",)),
    ("flash_attn_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_attn_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("matmul", ("gemm", "cutlass", "cublas", "xmma", "sm90_")),
    ("optimizer", ("multi_tensor", "adam")),
    ("softmax", ("softmax",)),
    ("layer_norm", ("layer_norm", "layernorm")),
    ("reduce", ("reduce",)),
    ("copy_elementwise", ("elementwise", "copy", "vectorized", "cat",
                          "index", "gather", "fill", "scatter")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile(fn, label: str) -> tuple:
    """``fn()`` under ``torch.profiler``: (summary dict, profiler)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == label
              and e.device_type == torch.autograd.DeviceType.CPU]
    window_us = window[0].time_range.end - window[0].time_range.start
    # Kernels only: the chunk{i}-stage{j} ranges also show on the device
    # timeline as user annotations.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != label
               and not e.name.startswith(("chunk", "table:"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_cat: dict = {}
    calls_by_cat: dict = {}
    by_name: dict = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        calls_by_cat[cat] = calls_by_cat.get(cat, 0) + 1
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    total = sum(by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # The table executor's op ranges live on the main thread, but the
    # autograd engine launches the backward's kernels from its own thread
    # while the main thread waits inside the range: attribute to a range
    # the device time of every host op (any thread) that starts inside it.
    cpu = torch.autograd.DeviceType.CPU
    launched = sorted(
        (e.time_range.start,
         getattr(e, "self_device_time_total",
                 getattr(e, "self_cuda_time_total", 0.0)))
        for e in events if e.device_type == cpu
        and not e.name.startswith("table:") and e.name != label)
    starts = [t for t, _ in launched]
    ranges: dict = {}
    for e in events:
        if e.name.startswith("table:") and e.device_type == cpu:
            kind = e.name[len("table:"):].split("-stage")[0].rstrip(
                "0123456789")
            lo = bisect.bisect_left(starts, e.time_range.start)
            hi = bisect.bisect_left(starts, e.time_range.end)
            dev = sum(d for _, d in launched[lo:hi])
            n, t = ranges.get(kind, (0, 0.0))
            ranges[kind] = (n + 1, t + dev)
    return {
        "table_op_ranges": {k: {"calls": n, "device_us": t}
                            for k, (n, t) in ranges.items()},
        "profiled_window_us": window_us,
        "kernel_launches": len(kernels),
        "device_busy_us": busy,
        "device_idle_share": 1.0 - busy / window_us,
        "kernel_us_by_category": by_cat,
        "kernel_calls_by_category": calls_by_cat,
        "kernel_share_by_category": {k: v / total for k, v in by_cat.items()},
        "top_kernels": [{"name": n[:120], "calls": c, "us": t}
                        for n, (c, t) in top],
    }, prof


def eval_slice(args):
    import chip_smoke
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.models.transformer_lm import build_sequential

    cfg, seq, pipe, batches = chip_smoke.make_slice(args.batches)
    twin_seq = build_sequential(dataclasses.replace(cfg, attn_impl="xla"),
                                device="cuda")
    twin_seq.load_state_dict(seq.state_dict())
    twin = Pipe(twin_seq, chunks=chip_smoke.CHUNKS,
                n_stages=chip_smoke.N_STAGES, device="cuda")
    tokens = args.batches * chip_smoke.EVAL_BATCH * chip_smoke.BPTT
    with torch.inference_mode():
        for p in (pipe, twin):                       # warm-up
            chip_smoke.evaluate(p, batches[:1])
        turns = {"flash": [], "xla": []}
        for name in ("flash", "xla", "xla", "flash"):
            p = pipe if name == "flash" else twin
            turns[name].append(timed(lambda: chip_smoke.evaluate(p, batches)))
        summary, prof = profile(lambda: chip_smoke.evaluate(pipe, batches),
                                "eval_window")
    summary.update(tokens=tokens, wall_s=turns,
                   tokens_per_s={k: [tokens / t for t in v]
                                 for k, v in turns.items()})
    return summary, prof, "torch_slice"


def train_slice(args):
    import chip_smoke
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig

    train_lines, _, _ = lm_text.load_corpus(vocab_size=28782)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, train_lines))
    tcfg = TrainerConfig(batch_size=chip_smoke.TRAIN_BATCH,
                         bptt=chip_smoke.BPTT, chunks=chip_smoke.CHUNKS,
                         n_stages=chip_smoke.N_STAGES,
                         checkpoint="except_last", lr=chip_smoke.TRAIN_LR)
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              tcfg.batch_size)
    # "main" is profiled; "other" is timed beside it in turns
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")      # dropout 0.2
    if args.schedule and args.remat_policy:
        names = {"main": f"table-{args.schedule}/{args.checkpoint}/"
                         f"{args.remat_policy}",
                 "other": f"table-{args.schedule}/{args.checkpoint}"}
        trainers = {k: chip_smoke._sched_trainer(cfg, args.schedule,
                                                 args.checkpoint)
                    for k in names}
        trainers["main"].scheduled = dataclasses.replace(
            trainers["main"].scheduled, remat_policy=args.remat_policy)
    elif args.schedule:
        names = {"main": f"table-{args.schedule}/{args.checkpoint}",
                 "other": "pipe-gpipe/except_last"}
        trainers = {"main": chip_smoke._sched_trainer(cfg, args.schedule,
                                                      args.checkpoint),
                    "other": Trainer(cfg, tcfg, device="cuda")}
    else:
        names = {"main": "flash", "other": "xla"}
        trainers = {"main": Trainer(cfg, tcfg, device="cuda"),
                    "other": Trainer(dataclasses.replace(cfg,
                                                         attn_impl="xla"),
                                     tcfg, device="cuda")}
    states = {k: t.init_state() for k, t in trainers.items()}
    position = {"main": 0, "other": 0}

    def steps(key, n):
        b = position[key]
        states[key], _ = trainers[key].train_epoch(
            source, state=states[key], max_steps=b + n, start_step=b,
            log_every=0)
        position[key] = b + n

    for key in ("main", "other"):                   # warm-up
        steps(key, 1)
    turns = {"main": [], "other": []}
    for key in ("main", "other", "other", "main"):
        turns[key].append(timed(lambda: steps(key, args.steps)))
    without = None
    if args.remat_policy:
        without, _ = profile(lambda: steps("other", 1), "train_step")
        without["idle_share_unprofiled"] = max(
            0.0, 1.0 - without["device_busy_us"]
            / (min(turns["other"]) * 1e6 / args.steps))
    trainers.pop("other")
    states.pop("other")
    torch.cuda.empty_cache()
    summary, prof = profile(lambda: steps("main", 1), "train_step")
    if without is not None:
        summary["without_policy"] = without
    tokens = args.steps * tcfg.batch_size * tcfg.bptt
    if args.schedule:
        # the profiler stretches the traced window; the device's busy time
        # against the fastest unprofiled step is the idle share a step pays
        step_us = min(turns["main"]) * 1e6 / args.steps
        summary.update(memory_plan=trainers["main"].scheduled.memory_plan(
            tcfg.chunks), idle_share_unprofiled=max(
                0.0, 1.0 - summary["device_busy_us"] / step_us))
    turns = {names[k]: v for k, v in turns.items()}
    summary.update(tokens=tokens, steps_per_turn=args.steps,
                   wall_s=turns,
                   ms_per_step={k: [t * 1e3 / args.steps for t in v]
                                for k, v in turns.items()},
                   tokens_per_s={k: [tokens / t for t in v]
                                 for k, v in turns.items()})
    stem = "torch_train"
    if args.schedule:
        stem += f"_{args.schedule}_{args.checkpoint}"
    if args.remat_policy:
        stem += f"_{args.remat_policy}"
    return summary, prof, stem


def bert_slice(args):
    import chip_smoke
    from pipe_tpu_torch.apps import zoo
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
    from pipe_tpu_torch.models import bert
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    cfg = bert.BertConfig()                          # dropout 0.1
    n_virtual = chip_smoke.BERT_STAGES * chip_smoke.BERT_INTERLEAVE
    model = bert.PipelinedBERT(
        cfg, n_virtual, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=chip_smoke.TRAIN_LR)
    names = {"main": args.remat_policy or "none", "other": "none"}
    tables = {k: ScheduledPipeline(
        model.stage_fn, model.pre_fn, model.loss_post_fn,
        n_stages=chip_smoke.BERT_STAGES, module=model,
        checkpoint="except_last",
        schedule=InterleavedOneFOneBSchedule(
            interleave=chip_smoke.BERT_INTERLEAVE), device="cuda",
        remat_policy=args.remat_policy if k == "main" else None)
        for k in names}
    position = {"main": 0, "other": 0}

    def steps(key, n):
        for _ in range(n):
            b = position[key]
            x, rows = mb.stack_scatter(zoo.synthetic_batch(
                "bert", cfg, chip_smoke.BERT_BATCH, b, "cuda"),
                chip_smoke.BERT_CHUNKS)
            opt.zero_grad(set_to_none=True)
            tables[key].loss_and_grad(x, mb.valid_row_mask(x, rows), seed=b)
            opt.step()
            position[key] = b + 1

    for key in ("main", "other"):                   # warm-up
        steps(key, 1)
    turns = {"main": [], "other": []}
    for key in ("main", "other", "other", "main"):
        turns[key].append(timed(lambda: steps(key, args.steps)))
    summaries = {}
    for key in ("other", "main"):
        summaries[key], prof = profile(lambda: steps(key, 1), "bert_step")
        summaries[key]["idle_share_unprofiled"] = max(
            0.0, 1.0 - summaries[key]["device_busy_us"]
            / (min(turns[key]) * 1e6 / args.steps))
    summary = summaries["main"]
    if args.remat_policy:
        summary["without_policy"] = summaries["other"]
    tokens = args.steps * chip_smoke.BERT_BATCH * cfg.seq_len
    turns = {names["main"] if k == "main" else f"{names[k]}#2": v
             for k, v in turns.items()}
    summary.update(tokens=tokens, steps_per_turn=args.steps, wall_s=turns,
                   ms_per_step={k: [t * 1e3 / args.steps for t in v]
                                for k, v in turns.items()},
                   tokens_per_s={k: [tokens / t for t in v]
                                 for k, v in turns.items()},
                   memory_plan=tables["main"].memory_plan(
                       chip_smoke.BERT_CHUNKS))
    return summary, None, "torch_bert" + (f"_{args.remat_policy}"
                                          if args.remat_policy else "")


def generate_slice(args):
    import chip_smoke
    from pipe_tpu_torch.inference import (GenerationConfig, Generator,
                                          quantize_params)
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM

    cfg, seq, _, batches = chip_smoke.make_slice(1)
    prompts = batches[0][0][:, :chip_smoke.GEN_PROMPT]
    n = args.decode_steps
    models = {"fp32": PipelinedLM.from_sequential(cfg, seq)}
    models["int8"] = quantize_params(models["fp32"])
    runs = {}
    for name, model in models.items():
        prefill = Generator(model, GenerationConfig(max_new_tokens=1,
                                                    temperature=0.0))
        decode = Generator(model, GenerationConfig(max_new_tokens=n + 1,
                                                   temperature=0.0))
        runs[name] = {"prefill": lambda g=prefill: g.generate(prompts),
                      "prefill_decode": lambda g=decode: g.generate(prompts)}
        runs[name]["prefill_decode"]()                   # warm-up
    # Every timed turn before any profile: a profiled window leaves the
    # host's launches slower for a while after it.
    turns = {name: {"prefill": [], "prefill_decode": []} for name in runs}
    for name in ("fp32", "int8", "int8", "fp32"):
        for which in ("prefill", "prefill_decode", "prefill_decode",
                      "prefill"):
            turns[name][which].append(timed(runs[name][which]))
    summary, prof = {}, None
    for name, run in runs.items():
        short, _ = profile(run["prefill"], f"{name}_prefill")
        long, prof_n = profile(run["prefill_decode"],
                               f"{name}_prefill_decode")
        prof = prof if prof is not None else prof_n       # keep fp32's trace
        pf = min(turns[name]["prefill"])
        step_ms = (min(turns[name]["prefill_decode"]) - pf) * 1e3 / n
        busy_us = (long["device_busy_us"] - short["device_busy_us"]) / n
        long.update(
            wall_s=turns[name], prefill_ms=pf * 1e3,
            decode_ms_per_step=step_ms,
            prefill_kernel_launches=short["kernel_launches"],
            prefill_device_busy_us=short["device_busy_us"],
            launches_per_decode_step=(long["kernel_launches"]
                                      - short["kernel_launches"]) / n,
            decode_device_busy_us_per_step=busy_us,
            # the profiled window is stretched by the profiler; this share
            # sets the profiled busy time against the unprofiled step
            decode_idle_share_unprofiled=1.0 - busy_us / 1e3 / step_ms)
        summary[name] = long
    summary.update(batch=prompts.shape[0], prompt=prompts.shape[1],
                   decode_steps=n)
    return summary, prof, "torch_generate"


def serve_slice(args):
    import numpy as np

    import chip_smoke
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.serve import BucketSpec, SingleDeviceSlotBackend

    cfg, seq, _, batches = chip_smoke.make_slice(1)
    prompts = batches[0][0].tolist()                   # 8 x 128 tokens
    n = args.decode_steps
    S, R = chip_smoke.SERVE_SLOTS, chip_smoke.RESIDENT_CHUNKS
    kv = ({} if args.kv == "slab"
          else {"kv_block_size": chip_smoke.PAGED_BLOCK})
    max_len, new, spec, stages = chip_smoke.SERVE_MAX_LEN, 128, {}, 1
    if args.spec_tokens:
        if not args.resident:
            raise SystemExit("--spec-tokens needs --resident")
        spec = dict(spec_tokens=args.spec_tokens, draft=args.draft,
                    draft_stages=args.draft_stages,
                    spec_branches=args.spec_branches)
        max_len = chip_smoke.SPEC_MAX_LEN
        new = max_len - 128 - (args.spec_branches or 1) * (
            args.spec_tokens - 1)
        if args.draft != "ngram":
            stages = args.draft_stages + 1
    model = PipelinedLM.from_sequential(cfg, seq, stages)
    backends = {}
    for name, graph in (("graph", True), ("eager", False)):
        b = SingleDeviceSlotBackend(
            model, num_slots=S, max_len=max_len,
            gen=GenerationConfig(max_new_tokens=new, temperature=0.0),
            buckets=BucketSpec.pow2(*chip_smoke.SERVE_BUCKETS),
            cuda_graph=graph, resident=args.resident, resident_chunks=R,
            **kv, **spec)
        for slot, p in enumerate(prompts):
            b.prefill(slot, p, 0)
        backends[name] = b
    live = np.ones(S, bool)
    budgets = np.full(S, 1 << 30, np.int64)
    steps = R if args.resident else 1                  # decode steps a call

    def ticks(b):
        for _ in range(n):
            if args.resident:
                b.decode(live, budgets=budgets, r_max=R)
            else:
                b.decode(live)

    for b in backends.values():                        # capture, warm-up
        if args.resident:
            b.decode(live, budgets=budgets, r_max=R)
        else:
            b.decode(live)
    turns = {"graph": [], "eager": []}
    for name in ("graph", "eager", "eager", "graph"):
        turns[name].append(timed(lambda: ticks(backends[name])))
    summary, prof = {}, None
    for name, b in backends.items():
        part, prof_n = profile(lambda: ticks(b), f"{name}_ticks")
        prof = prof if prof is not None else prof_n     # keep the graph's
        tick_ms = min(turns[name]) * 1e3 / n
        part.update(
            wall_s=turns[name], decode_ms_per_tick=tick_ms,
            decode_ms_per_step=tick_ms / steps,
            launches_per_tick=part["kernel_launches"] / n,
            device_busy_us_per_tick=part["device_busy_us"] / n,
            kernel_us_per_tick_by_category={
                k: v / n for k, v in part["kernel_us_by_category"].items()},
            decode_idle_share_unprofiled=1.0 - part["device_busy_us"]
            / n / 1e3 / tick_ms)
        if spec:
            part.update(ms_per_round=tick_ms / R,
                        device_busy_ms_per_round=part["device_busy_us"]
                        / n / R / 1e3)
        summary[name] = part
    # a prompt no slot holds, so the paged pool's prefix cache misses
    fresh = prompts[0][::-1]
    backends["graph"].release(0)
    pre, _ = profile(lambda: backends["graph"].prefill(0, fresh, 0),
                     "prefill_128")
    keep = ("profiled_window_us", "kernel_launches", "device_busy_us",
            "device_idle_share", "kernel_us_by_category")
    summary["prefill_128"] = {k: pre[k] for k in keep}
    if args.kv == "paged":
        # the epilogue program alone, replayed: the first token and the
        # admitted slot's view refreshed from the pool (the regather)
        epi, _ = profile(backends["graph"]._first_prog, "prefill_epilogue")
        summary["prefill_epilogue"] = {k: epi[k] for k in keep}
    summary.update(slots=S, max_len=max_len, ticks=n, kv=args.kv,
                   resident=args.resident, decode_steps_per_tick=steps,
                   spec={k: v for k, v in spec.items() if v is not None})
    return summary, prof, ("torch_serve" + ("_paged" if kv else "")
                           + ("_resident" if args.resident else "")
                           + (f"_spec{args.spec_tokens}{args.draft}"
                              if spec else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile training steps instead of the eval slice")
    ap.add_argument("--schedule", choices=["gpipe", "1f1b", "zb-h1"],
                    default=None,
                    help="profile a table-executor step of this schedule "
                         "(--train)")
    ap.add_argument("--checkpoint", choices=["never", "except_last",
                                             "always"],
                    default="except_last",
                    help="checkpoint mode of the table step (--schedule)")
    ap.add_argument("--remat-policy", default=None,
                    choices=["dots_saveable",
                             "dots_with_no_batch_dims_saveable",
                             "nothing_saveable", "everything_saveable"],
                    help="a remat policy for the table step (--schedule, "
                         "--bert), timed and profiled against none")
    ap.add_argument("--bert", action="store_true",
                    help="profile BERT-large steps through the "
                         "interleaved-1F1B table")
    ap.add_argument("--generate", action="store_true",
                    help="profile KV-cached generation (fp32 and int8)")
    ap.add_argument("--serve", action="store_true",
                    help="profile the serve engine's decode tick, captured "
                         "and eager")
    ap.add_argument("--kv", choices=["slab", "paged"], default="slab",
                    help="KV layout of the serve engine (--serve)")
    ap.add_argument("--resident", action="store_true",
                    help="one resident launch of 8 chunks per tick "
                         "(--serve)")
    ap.add_argument("--spec-tokens", type=int, default=None,
                    help="speculative rounds of K tokens (--serve "
                         "--resident): each chunk is a round")
    ap.add_argument("--draft", choices=["ngram", "truncated", "tree"],
                    default="ngram", help="draft source (--spec-tokens)")
    ap.add_argument("--draft-stages", type=int, default=1,
                    help="stages of a truncated or tree draft")
    ap.add_argument("--spec-branches", type=int, default=None,
                    help="tree draft branches")
    ap.add_argument("--decode-steps", type=int, default=32,
                    help="decode steps after the prefill (--generate), "
                         "ticks per turn (--serve)")
    ap.add_argument("--batches", type=int, default=4,
                    help="eval batches per timed turn")
    ap.add_argument("--steps", type=int, default=3,
                    help="training steps per timed turn (--train)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    run = (generate_slice if args.generate else serve_slice if args.serve
           else bert_slice if args.bert
           else train_slice if args.train else eval_slice)
    with torch.inference_mode(args.generate):
        summary, prof, stem = run(args)
    summary["device"] = smi

    os.makedirs(args.out, exist_ok=True)
    if prof is not None:
        prof.export_chrome_trace(os.path.join(args.out,
                                              f"{stem}_trace.json"))
    with open(os.path.join(args.out, f"{stem}_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(smi)
    keys = ("wall_s", "ms_per_step", "tokens_per_s", "profiled_window_us",
            "kernel_launches", "device_busy_us", "device_idle_share",
            "kernel_us_by_category", "kernel_calls_by_category",
            "prefill_ms", "decode_ms_per_step", "launches_per_decode_step",
            "decode_device_busy_us_per_step", "decode_idle_share_unprofiled",
            "decode_ms_per_tick", "launches_per_tick",
            "device_busy_us_per_tick", "kernel_us_per_tick_by_category",
            "ms_per_round", "device_busy_ms_per_round", "table_op_ranges",
            "idle_share_unprofiled", "memory_plan", "without_policy")
    parts = ([summary[k] for k in ("fp32", "int8")] if args.generate
             else [summary[k] for k in ("graph", "eager")] if args.serve
             else [summary])
    for part in parts:
        for k in keys:
            if k in part:
                print(f"{k}: {part[k]}")
        for row in part["top_kernels"]:
            print(f"  {row['us']:10.1f} us {row['calls']:5d}x  {row['name']}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
