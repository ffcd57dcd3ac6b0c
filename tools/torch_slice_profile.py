"""Where the time goes in pipe_tpu_torch's eval slice on one CUDA card.

    python3 tools/torch_slice_profile.py [--batches N] [--out DIR]

Builds the full-width tutorial LM and ``Pipe`` that ``chip_smoke.py`` drives
(``make_slice``: d_model 2048, 32 heads, d_ff 2048, 16 layers, bptt 128, eval
batch 8, chunks 4, 2 stages), then:

1. times the eval forward of N batches with ``attn_impl="flash"`` (the CUDA
   kernel) and with ``"xla"`` (plain attention) on the same weights, in turns
   flash, xla, xla, flash (host clock around work that ends in a synchronize);
2. profiles one flash pass with ``torch.profiler`` (CPU + CUDA) and reports
   the device's busy time (union of kernel intervals), its idle share of the
   window, and kernel time by category and by name.

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
    ("matmul", ("gemm", "cutlass", "cublas", "xmma", "sm90_")),
    ("softmax", ("softmax",)),
    ("layer_norm", ("layer_norm", "layernorm")),
    ("reduce", ("reduce",)),
    ("copy_elementwise", ("elementwise", "copy", "vectorized", "cat",
                          "index", "gather", "fill")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def timed(pipe, batches, evaluate) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate(pipe, batches)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.models.transformer_lm import build_sequential

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
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
            turns[name].append(timed(p, batches, chip_smoke.evaluate))

        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("eval_window"):
                chip_smoke.evaluate(pipe, batches)
                torch.cuda.synchronize()

    events = prof.events()
    window = [e for e in events if e.name == "eval_window"
              and e.device_type == torch.autograd.DeviceType.CPU]
    window_us = window[0].time_range.end - window[0].time_range.start
    # Kernels only: the chunk{i}-stage{j} ranges also show on the device
    # timeline as user annotations.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "eval_window"
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
    by_name: dict = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + dur
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    total = sum(by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]

    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "torch_slice_trace.json"))
    summary = {
        "device": smi,
        "tokens": tokens,
        "wall_s": turns,
        "tokens_per_s": {k: [tokens / t for t in v] for k, v in turns.items()},
        "profiled_window_us": window_us,
        "kernel_launches": len(kernels),
        "device_busy_us": busy,
        "device_idle_share": 1.0 - busy / window_us,
        "kernel_us_by_category": by_cat,
        "kernel_share_by_category": {k: v / total for k, v in by_cat.items()},
        "top_kernels": [{"name": n[:120], "calls": c, "us": t}
                        for n, (c, t) in top],
    }
    with open(os.path.join(args.out, "torch_slice_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(smi)
    for k in ("wall_s", "tokens_per_s", "profiled_window_us",
              "kernel_launches", "device_busy_us", "device_idle_share",
              "kernel_us_by_category"):
        print(f"{k}: {summary[k]}")
    for row in summary["top_kernels"]:
        print(f"  {row['us']:10.1f} us {row['calls']:5d}x  {row['name']}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
