"""Where the time goes in pipe_tpu_torch's slices on one CUDA card.

    python3 tools/torch_slice_profile.py [--batches N] [--out DIR]
    python3 tools/torch_slice_profile.py --train [--steps N] [--out DIR]
    python3 tools/torch_slice_profile.py --generate [--decode-steps N]
        [--out DIR]
    python3 tools/torch_slice_profile.py --serve [--decode-steps N]
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
beside queueing).

Prints one JSON summary as its last line and writes it, with the chrome
trace, under ``--out`` (default ``build/profile/``).
"""

from __future__ import annotations

import argparse
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
               and not e.name.startswith("chunk")]
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
    return {
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
    trainers, states = {}, {}
    for impl in ("flash", "xla"):
        cfg = LMConfig(vocab=len(vocab), attn_impl=impl)   # dropout 0.2
        trainers[impl] = Trainer(cfg, tcfg, device="cuda")
        states[impl] = trainers[impl].init_state()
    position = {"flash": 0, "xla": 0}

    def steps(impl, n):
        b = position[impl]
        states[impl], _ = trainers[impl].train_epoch(
            source, state=states[impl], max_steps=b + n, start_step=b,
            log_every=0)
        position[impl] = b + n

    for impl in ("flash", "xla"):                   # warm-up
        steps(impl, 1)
    turns = {"flash": [], "xla": []}
    for impl in ("flash", "xla", "xla", "flash"):
        turns[impl].append(timed(lambda: steps(impl, args.steps)))
    trainers.pop("xla")
    states.pop("xla")
    torch.cuda.empty_cache()
    summary, prof = profile(lambda: steps("flash", 1), "train_step")
    tokens = args.steps * tcfg.batch_size * tcfg.bptt
    summary.update(tokens=tokens, steps_per_turn=args.steps,
                   wall_s=turns,
                   ms_per_step={k: [t * 1e3 / args.steps for t in v]
                                for k, v in turns.items()},
                   tokens_per_s={k: [tokens / t for t in v]
                                 for k, v in turns.items()})
    return summary, prof, "torch_train"


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
    model = PipelinedLM.from_sequential(cfg, seq)
    prompts = batches[0][0].tolist()                   # 8 x 128 tokens
    n = args.decode_steps
    backends = {}
    for name, graph in (("graph", True), ("eager", False)):
        b = SingleDeviceSlotBackend(
            model, num_slots=chip_smoke.SERVE_SLOTS,
            max_len=chip_smoke.SERVE_MAX_LEN,
            gen=GenerationConfig(max_new_tokens=128, temperature=0.0),
            buckets=BucketSpec.pow2(*chip_smoke.SERVE_BUCKETS),
            cuda_graph=graph)
        for slot, p in enumerate(prompts):
            b.prefill(slot, p, 0)
        backends[name] = b
    live = np.ones(chip_smoke.SERVE_SLOTS, bool)

    def ticks(b):
        for _ in range(n):
            b.decode(live)

    for b in backends.values():                        # capture, warm-up
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
            launches_per_tick=part["kernel_launches"] / n,
            device_busy_us_per_tick=part["device_busy_us"] / n,
            kernel_us_per_tick_by_category={
                k: v / n for k, v in part["kernel_us_by_category"].items()},
            decode_idle_share_unprofiled=1.0 - part["device_busy_us"]
            / n / 1e3 / tick_ms)
        summary[name] = part
    pre, _ = profile(lambda: backends["graph"].prefill(0, prompts[0], 0),
                     "prefill_128")
    summary["prefill_128"] = {
        k: pre[k] for k in ("profiled_window_us", "kernel_launches",
                            "device_busy_us", "device_idle_share",
                            "kernel_us_by_category")}
    summary.update(slots=chip_smoke.SERVE_SLOTS,
                   max_len=chip_smoke.SERVE_MAX_LEN, ticks=n)
    return summary, prof, "torch_serve"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile training steps instead of the eval slice")
    ap.add_argument("--generate", action="store_true",
                    help="profile KV-cached generation (fp32 and int8)")
    ap.add_argument("--serve", action="store_true",
                    help="profile the serve engine's decode tick, captured "
                         "and eager")
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
           else train_slice if args.train else eval_slice)
    with torch.inference_mode(args.generate):
        summary, prof, stem = run(args)
    summary["device"] = smi

    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, f"{stem}_trace.json"))
    with open(os.path.join(args.out, f"{stem}_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(smi)
    keys = ("wall_s", "ms_per_step", "tokens_per_s", "profiled_window_us",
            "kernel_launches", "device_busy_us", "device_idle_share",
            "kernel_us_by_category", "kernel_calls_by_category",
            "prefill_ms", "decode_ms_per_step", "launches_per_decode_step",
            "decode_device_busy_us_per_step", "decode_idle_share_unprofiled",
            "decode_ms_per_tick", "launches_per_tick",
            "device_busy_us_per_tick", "kernel_us_per_tick_by_category")
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
