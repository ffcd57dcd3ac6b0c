"""Chip smoke test of pipe_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without a result line:

1. device  -- the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 off for matmul and cuDNN, so fp32 means fp32.
2. build   -- nvcc builds every kernel source of the package for sm_90a;
   per kernel instance, ptxas's registers and spill, and the count of
   tensor-core instructions (HMMA/HGMMA) and asynchronous copies
   (LDGSTS/UTMALDG) in its SASS (cuobjdump): the forward and dK/dV kernels
   must show both.
3. kernels -- each kernel (flash forward, dQ, dK/dV) against its plain
   PyTorch version on the card at the shapes the main paths give it (and a
   few more), with and without attention dropout (the plain versions fed the
   same Philox mask), with its time, the plain version's, one PyTorch library
   call's, and the least time the card could take (bytes or operations over
   the H100's peak rates). Same seed, same bits: each kernel run twice.
   SDPA is timed beside the forward with and without dropout, and its
   backward five times, with their spread.
4. slice   -- the eval path: the tutorial Transformer LM at full width
   (d_model 2048, 32 heads, d_ff 2048, 16 layers, bptt 128, random weights
   from a seed) through ``Pipe(chunks=4, n_stages=2)`` in eval mode over 4
   batches of the tutorial text pipeline. The flash kernel must be launched
   16 layers x 4 chunks x 4 batches times, and the logits and losses must
   agree with a twin that runs plain attention on the same weights.
5. train   -- the training path: ``Trainer`` over the same LM with dropout
   0.2 (batch 32, bptt 128, chunks 4, 2 stages, except_last, lr 1e-4) for 8
   steps; the forward kernel must be launched 8 x 112 times (64 forwards and
   48 recomputes a step), dQ and dK/dV 8 x 64 times each; every loss finite,
   the last below the first. Then twins at dropout 0: one step's loss and
   gradients with the kernels and with plain attention on the same weights,
   each held to plain attention in float64.

The last two lines are the kernels JSON object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

SEED = 0
EVAL_BATCH = 8
BPTT = 128
N_BATCHES = 4
CHUNKS = 4
N_STAGES = 2
# fp32, sums taken in another order than the plain version: |err| at most
# TOL_KERNEL x max(1, max|plain|).
TOL_KERNEL = 1e-4
TOL_LOSS_REL = 1e-4      # flash vs plain-attention twin, per batch
TOL_LOGITS = 1e-3        # flash vs plain-attention twin, abs
# Training twins at dropout 0, each held to a float64 run of plain attention
# on the same weights: per parameter, the largest gradient difference over
# the larger of that parameter's largest gradient and GRAD_FLOOR of the
# largest gradient of any parameter. The floor is for the key projection's
# bias, whose gradient is zero in exact arithmetic (softmax ignores a
# constant added to a row of scores): every path gives rounding noise there,
# which no relative bound of its own holds. The kernel path must come within
# TOL_GRAD_REL, or within GRAD_SLACK times what fp32 plain attention itself
# comes within: a one-ulp change of a ReLU input near 0 switches that
# element's whole term in the feed-forward gradients on or off, so fp32 runs
# that round differently disagree there by far more than rounding.
TOL_GRAD_REL = 1e-3
GRAD_FLOOR = 1e-3
GRAD_SLACK = 2.0
TRAIN_BATCH = 32
TRAIN_STEPS = 8
TRAIN_LR = 1e-4          # lr 5.0 (the reference's) diverges at full width
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the fastest
# fp32-accurate product rate the card has: TF32 tensor cores (495 TFLOP/s)
# in three passes (big*big + big*small + small*big), which keep fp32-level
# error, against 67 TFLOP/s of fp32 FMA on the CUDA cores.
PEAK_BYTES = 3.35e12
PEAK_FP32_ACCURATE = 495e12 / 3

# (bh, s, d, causal): the eval slice's shape first (b*h = 2 x 32, bptt,
# 2048 / 32); the training path's micro-batch of 8 rows gives b*h = 8 x 32.
TRAIN_SHAPE = (256, 128, 64, True)
DROPOUT = 0.2
DROP_SEEDS = (12345, (1 << 62) + 977)   # the second uses the key's high word
TIMED_SHAPES = [(64, 128, 64, True), (16, 512, 64, True), (8, 256, 128, False)]
# Ragged and odd shapes the kernel also takes: checked, not timed.
EDGE_SHAPES = [(3, 24, 8, True), (2, 8, 16, False), (4, 40, 48, True),
               (2, 200, 64, True), (2, 96, 96, False), (5, 136, 32, False),
               (3, 72, 8, True), (2, 136, 48, False), (2, 200, 96, True),
               (1, 128, 128, True)]
SDPA_RUNS = 5   # graph timings of SDPA's backward
# Kernels that must run on tensor cores with asynchronous copies (SASS).
TC_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi.splitlines()[0], flush=True)
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi


def sass_counts(lib: str) -> dict:
    """``{kernel instance: (tensor-core instructions, async copies)}`` of a
    built library, from ``cuobjdump --dump-sass``: HMMA/HGMMA and
    LDGSTS/UTMALDG lines per function, names demangled."""
    from pipe_tpu_torch._build import cuda_tool
    out = subprocess.run([cuda_tool("cuobjdump"), "--dump-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            op = line.split(";")[0]
            counts[name][0] += ("HMMA" in op) or ("HGMMA" in op)
            counts[name][1] += ("LDGSTS" in op) or ("UTMALDG" in op)
    names = list(counts)
    plain = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {p.replace("<unnamed>::", "").removeprefix("void "): tuple(counts[n])
            for n, p in zip(names, plain)}


def phase_build() -> None:
    from pipe_tpu_torch import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    total = time.perf_counter() - t0
    for src, info in report.items():
        log("build", source=src, nvcc_s=f"{info['seconds']:.2f}")
        for line in info["ptxas"].splitlines():
            if "Function properties" in line:
                print("    " + line.split(" for ")[-1].strip()[:100], flush=True)
            elif "registers" in line or "spill" in line:
                print("      " + line.replace("ptxas info    :", "").strip(),
                      flush=True)
    log("build", total_s=f"{total:.2f}")
    for src in _build.SOURCES:
        for fn, (tc, cp) in sass_counts(str(_build.lib_path(src))).items():
            log("build", sass=src, kernel=repr(fn.split(">(")[0] + ">"),
                tensor_core=tc, async_copy=cp)
            if any(k in fn for k in TC_KERNELS) and not (tc and cp):
                raise AssertionError(f"{fn} lacks tensor-core instructions "
                                     f"({tc}) or async copies ({cp})")


def time_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events, so host launch overhead is
    not what is timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_ACCURATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def attention_bound(bh: int, s: int, d: int, causal: bool, elem: int):
    """Least time (ms) for one flash forward: q, k, v read once, o and lse
    written once; 4*d FLOPs per (query, key) pair the mask keeps."""
    return _bound(4 * bh * s * d * elem + bh * s * 4,
                  4 * d * _pairs(s, causal) * bh)


def bwd_bound(kernel: str, bh: int, s: int, d: int, causal: bool, elem: int):
    """Least time (ms) for one dQ or dK/dV call: q, k, v, dO, L and D read
    once, the gradients written once; 6*d (dQ) or 8*d (dK/dV) FLOPs per
    (query, key) pair the mask keeps."""
    outs, per_pair = {"dq": (1, 6), "dkv": (2, 8)}[kernel]
    return _bound((4 + outs) * bh * s * d * elem + 2 * bh * s * 4,
                  per_pair * d * _pairs(s, causal) * bh)


def _qkv(bh, s, d, dtype, gen, n=3):
    return [torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(n)]


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def _scale_of(want: torch.Tensor) -> float:
    return max(1.0, want.float().abs().max().item())


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the kernels' rows."""
    import torch.nn.functional as F

    from pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_attn_fwd": 0.0, "flash_attn_bwd_dq": 0.0,
             "flash_attn_bwd_dkv": 0.0}
    rows = {}

    def keep_of(seed, rate, bh, s):
        return fa.dropout_keep(seed, rate, bh, s, device="cuda") if rate else None

    def check(name, errs, scale, tol, where):
        if tol == TOL_KERNEL:                 # fp32: what max_abs_err reports
            worst[name] = max(worst[name], *errs)
        if max(errs) > tol * scale:
            raise AssertionError(
                f"{name} disagrees with its plain version at {where}: "
                f"max|err|={max(errs):.3e} > {tol} x {scale:.3g}")

    def compare_fwd(bh, s, d, causal, dtype, tol, seed=0, rate=0.0):
        q, k, v = _qkv(bh, s, d, dtype, gen)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                        seed=seed, rate=rate)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, scale,
                                                keep_of(seed, rate, bh, s))
        errs = (_err(o, o_ref), _err(lse, lse_ref))
        check("flash_attn_fwd", errs, _scale_of(o_ref), tol,
              f"bh={bh} s={s} d={d} causal={causal} {dtype} rate={rate}")
        return q, k, v, scale, errs

    def compare_bwd(bh, s, d, causal, dtype, tol, seed=0, rate=0.0):
        q, k, v, do = _qkv(bh, s, d, dtype, gen, n=4)
        scale = 1.0 / math.sqrt(d)
        keep = keep_of(seed, rate, bh, s)
        o, lse = fa.flash_attention_ref(q, k, v, causal, scale, keep)
        delta = fa.attention_delta(o, do)
        kw = dict(causal=causal, scale=scale, seed=seed, rate=rate)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ref = dict(causal=causal, scale=scale, keep=keep)
        dq_r = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **ref)
        dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    **ref)
        where = f"bh={bh} s={s} d={d} causal={causal} {dtype} rate={rate}"
        e_dq = _err(dq, dq_r)
        e_dkv = (_err(dk, dk_r), _err(dv, dv_r))
        check("flash_attn_bwd_dq", (e_dq,), _scale_of(dq_r), tol, where)
        check("flash_attn_bwd_dkv", e_dkv,
              max(_scale_of(dk_r), _scale_of(dv_r)), tol, where)
        return (q, k, v, do, lse, delta, kw), (e_dq, *e_dkv)

    # The forward without dropout: the eval path's shape first.
    for bh, s, d, causal in TIMED_SHAPES:
        q, k, v, scale, (err_o, err_l) = compare_fwd(bh, s, d, causal,
                                                     torch.float32, TOL_KERNEL)
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                    scale=scale))
        plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal,
                                                       scale))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale))
        bound, bound_by = attention_bound(bh, s, d, causal, 4)
        log("kernels", name="flash_attn_fwd", bh=bh, s=s, d=d, causal=causal,
            dtype="f32", rate=0.0, max_abs_dO=f"{err_o:.3e}",
            max_abs_dL=f"{err_l:.3e}", ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
            library_ms=f"{lib:.5f}", bound_ms=f"{bound:.5f}",
            bound_by=bound_by, roofline=f"{bound / ms:.3f}")

    # Every kernel, with and without dropout, at the training shape (timed)
    # and at the other shapes (checked).
    for shape in [TRAIN_SHAPE] + TIMED_SHAPES + EDGE_SHAPES:
        bh, s, d, causal = shape
        for seed, rate in [(0, 0.0)] + [(sd, DROPOUT) for sd in DROP_SEEDS]:
            *_, (err_o, err_l) = compare_fwd(bh, s, d, causal, torch.float32,
                                             TOL_KERNEL, seed, rate)
            args, errs = compare_bwd(bh, s, d, causal, torch.float32,
                                     TOL_KERNEL, seed, rate)
            log("kernels", check="fwd+bwd", bh=bh, s=s, d=d, causal=causal,
                rate=rate, seed=seed, max_abs_dO=f"{err_o:.3e}",
                max_abs_dL=f"{err_l:.3e}", max_abs_ddq=f"{errs[0]:.3e}",
                max_abs_ddk=f"{errs[1]:.3e}", max_abs_ddv=f"{errs[2]:.3e}")
    # bf16 in and out (fp32 inside): results round to bf16, 8 bits of
    # mantissa, so the tolerance is 1e-2 of the largest value.
    for seed, rate in ((0, 0.0), (DROP_SEEDS[0], DROPOUT)):
        *_, (err_o, err_l) = compare_fwd(*TRAIN_SHAPE, torch.bfloat16, 1e-2,
                                         seed, rate)
        _, errs = compare_bwd(*TRAIN_SHAPE, torch.bfloat16, 1e-2, seed, rate)
        log("kernels", check="bf16", shape=TRAIN_SHAPE, rate=rate,
            max_abs_dO=f"{err_o:.3e}", max_abs_ddq=f"{errs[0]:.3e}",
            max_abs_ddk=f"{errs[1]:.3e}", max_abs_ddv=f"{errs[2]:.3e}")

    # The training shape with dropout, as the main path calls the kernels.
    bh, s, d, causal = TRAIN_SHAPE
    seed = DROP_SEEDS[0]
    (q, k, v, do, lse, delta, kw), _ = compare_bwd(
        bh, s, d, causal, torch.float32, TOL_KERNEL, seed, DROPOUT)
    scale = kw["scale"]

    # Same seed, same bits: a second run of each kernel equals the first;
    # another seed changes the result.
    runs = [(lambda sd=sd: fa.flash_attention_fwd(
                 q, k, v, causal=causal, scale=scale, seed=sd, rate=DROPOUT)[0],
             lambda sd=sd: fa.flash_attention_bwd_dq(
                 q, k, v, do, lse, delta, **dict(kw, seed=sd)),
             lambda sd=sd: torch.cat(fa.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, **dict(kw, seed=sd))))
            for sd in (seed, DROP_SEEDS[1])]
    for name, a, b in zip(("fwd", "dq", "dkv"), *runs):
        first, again, other = a(), a(), b()
        if not torch.equal(first, again):
            raise AssertionError(f"{name}: the same seed gave other bits")
        if torch.equal(first, other):
            raise AssertionError(f"{name}: another seed gave the same result")
    keep = fa.dropout_keep(seed, DROPOUT, bh, s, device="cuda")
    kept = (keep > 0).float().mean().item()
    sigma = math.sqrt(DROPOUT * (1 - DROPOUT) / keep.numel())
    log("kernels", check="repeat", same_seed_bitwise=True,
        keep_rate=f"{kept:.6f}", expected=1 - DROPOUT, sigma=f"{sigma:.2e}")
    if abs(kept - (1 - DROPOUT)) > 4 * sigma:
        raise AssertionError(f"keep rate {kept} is not within 4 sigma of "
                             f"{1 - DROPOUT}")

    plain_keep = lambda: fa.dropout_keep(seed, DROPOUT, bh, s, device="cuda")
    ref_kw = dict(causal=causal, scale=scale)
    fwd_ms = time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=causal, scale=scale, seed=seed, rate=DROPOUT))
    fwd_plain = time_ms(lambda: fa.flash_attention_ref(
        q, k, v, causal, scale, plain_keep()))
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, **kw))
    dq_plain = time_ms(lambda: fa.flash_attention_bwd_dq_ref(
        q, k, v, do, lse, delta, keep=plain_keep(), **ref_kw))
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, **kw))
    dkv_plain = time_ms(lambda: fa.flash_attention_bwd_dkv_ref(
        q, k, v, do, lse, delta, keep=plain_keep(), **ref_kw))
    # Library yardsticks, timed like the kernels (CUDA graphs). The forward's:
    # SDPA with the same dropout rate (the same function up to the mask's
    # bits, which come from PyTorch's own generator); without dropout beside
    # it. The backward's: SDPA's whole backward (dQ, dK and dV together, no
    # dropout), as forward+backward less the forward, the mean of SDPA_RUNS
    # graph timings, with their spread.
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    do4 = do[None]

    def sdpa(p=0.0):
        return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=p,
                                              is_causal=causal, scale=scale)

    def sdpa_grads():
        return torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa)
        lib_fwd_drop = time_ms(lambda: sdpa(DROPOUT))
    side = torch.cuda.Stream()       # autograd warms up off the capture stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            sdpa_grads()
    torch.cuda.current_stream().wait_stream(side)
    bwd_runs = []
    for _ in range(SDPA_RUNS):
        with torch.no_grad():
            fwd_only = time_ms(sdpa)
        bwd_runs.append(time_ms(sdpa_grads) - fwd_only)
    lib_bwd = sum(bwd_runs) / len(bwd_runs)

    for name, ms, plain, lib, (bound, by) in (
            ("flash_attn_fwd", fwd_ms, fwd_plain, lib_fwd_drop,
             attention_bound(bh, s, d, causal, 4)),
            ("flash_attn_bwd_dq", dq_ms, dq_plain, lib_bwd,
             bwd_bound("dq", bh, s, d, causal, 4)),
            ("flash_attn_bwd_dkv", dkv_ms, dkv_plain, lib_bwd,
             bwd_bound("dkv", bh, s, d, causal, 4))):
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bound, bound_by=by,
                          max_abs_err=worst[name])
        log("kernels", name=name, bh=bh, s=s, d=d, causal=causal, dtype="f32",
            rate=DROPOUT, ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
            library_ms=f"{lib:.5f}", bound_ms=f"{bound:.5f}", bound_by=by,
            roofline=f"{bound / ms:.3f}", max_abs_err=f"{worst[name]:.3e}")
    log("kernels", sdpa_fwd_ms=f"{lib_fwd:.5f}",
        sdpa_fwd_dropout_ms=f"{lib_fwd_drop:.5f}",
        sdpa_bwd_ms=f"{lib_bwd:.5f}",
        sdpa_bwd_runs_ms=[f"{x:.5f}" for x in bwd_runs],
        sdpa_bwd_spread_ms=f"{max(bwd_runs) - min(bwd_runs):.5f}",
        note="library_ms of fwd is SDPA with dropout 0.2; of dq and dkv "
        "SDPA's whole backward (dQ, dK, dV together), no dropout")
    return rows


def make_slice(n_batches: int = N_BATCHES):
    """The tutorial pipeline at full width on the card: ``(cfg, seq, pipe,
    batches)`` with ``batches`` a list of ``(tokens, targets)`` of
    ``[EVAL_BATCH, BPTT]`` from the eval split of the synthetic corpus."""
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig, build_sequential

    train_lines, val_lines, _ = lm_text.load_corpus(vocab_size=28782)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, train_lines))
    val = lm_text.batchify(lm_text.data_process(val_lines, vocab), EVAL_BATCH)
    batches = []
    for b in range(n_batches):
        data, target = lm_text.get_batch(val, b * BPTT, BPTT)
        if data.shape[1] != BPTT:
            raise RuntimeError("eval split too short for the smoke batches")
        batches.append((torch.from_numpy(data).long().cuda(),
                        torch.from_numpy(target).long().cuda()))
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")
    seq = build_sequential(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    pipe = Pipe(seq, chunks=CHUNKS, n_stages=N_STAGES,
                checkpoint="except_last", device="cuda")
    return cfg, seq, pipe, batches


def evaluate(pipe, batches):
    """Eval forward over ``batches``: (per-batch logits, [n] losses)."""
    from pipe_tpu_torch.models.transformer_lm import cross_entropy
    logits, losses = [], []
    for x, y in batches:
        out = pipe(x)
        logits.append(out)
        losses.append(cross_entropy(out, y))
    return logits, torch.stack(losses)


def phase_slice() -> int:
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.models.transformer_lm import build_sequential
    from pipe_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg, seq, pipe, batches = make_slice()
    n_params = sum(p.numel() for p in pipe.parameters())
    log("slice", vocab=cfg.vocab, d_model=cfg.d_model, nhead=cfg.nhead,
        d_ff=cfg.d_ff, n_layers=cfg.n_layers, params=n_params,
        balance=pipe.balance, setup_s=f"{time.perf_counter() - t0:.2f}")

    with torch.inference_mode():
        pipe(batches[0][0])                      # warm-up: not counted
        torch.cuda.synchronize()
        for c in _counters():
            c.launches = 0
        t0 = time.perf_counter()
        logits, losses = evaluate(pipe, batches)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches

    expected = cfg.n_layers * CHUNKS * N_BATCHES
    loss = losses.mean().item()
    tokens = N_BATCHES * EVAL_BATCH * BPTT
    log("slice", eval_loss=f"{loss:.6f}", ppl=f"{math.exp(loss):.2f}",
        log_vocab=f"{math.log(cfg.vocab):.6f}", tokens=tokens,
        seconds=f"{dt:.4f}", tokens_per_s=f"{tokens / dt:.1f}",
        flash_launches=launches, expected=expected,
        logits_shape=tuple(logits[0].shape))
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times on the "
                             f"main path, expected {expected}")
    if not all(torch.isfinite(l).all().item() for l in logits):
        raise AssertionError("non-finite logits")
    if not abs(loss - math.log(cfg.vocab)) <= 1.0:
        raise AssertionError(f"eval loss {loss} is not within 1 nat of "
                             f"log(vocab) {math.log(cfg.vocab)}")

    # The same weights with plain attention.
    twin_seq = build_sequential(
        dataclasses.replace(cfg, attn_impl="xla"), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    twin_seq.load_state_dict(seq.state_dict())
    twin = Pipe(twin_seq, chunks=CHUNKS, n_stages=N_STAGES,
                checkpoint="except_last", device="cuda")
    with torch.inference_mode():
        before = fa.flash_attention_fwd.launches
        twin_logits, twin_losses = evaluate(twin, batches)
        if fa.flash_attention_fwd.launches != before:
            raise AssertionError("the plain-attention twin launched the kernel")
    rel = ((losses - twin_losses).abs() / twin_losses.abs()).max().item()
    dlogits = max((a - b).abs().max().item()
                  for a, b in zip(logits, twin_logits))
    log("slice", twin="xla", max_loss_rel=f"{rel:.3e}",
        max_abs_dlogits=f"{dlogits:.3e}")
    if not (rel <= TOL_LOSS_REL and dlogits <= TOL_LOGITS):
        raise AssertionError(
            f"flash path disagrees with the plain-attention twin: loss rel "
            f"{rel:.3e} (tol {TOL_LOSS_REL}), logits {dlogits:.3e} "
            f"(tol {TOL_LOGITS})")
    return launches


def _counters():
    from pipe_tpu_torch.ops import flash_attention as fa
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def phase_train() -> dict:
    """The training path; returns each kernel's launches over its 8 steps."""
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import (LMConfig,
                                                      build_sequential,
                                                      pipelined_lm_balance)
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig, lm_loss

    t0 = time.perf_counter()
    train_lines, _, _ = lm_text.load_corpus(vocab_size=28782)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, train_lines))
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")   # dropout 0.2
    tcfg = TrainerConfig(batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
                         n_stages=N_STAGES, checkpoint="except_last",
                         lr=TRAIN_LR)
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              tcfg.batch_size)
    if lm_text.num_batches(source, BPTT) < TRAIN_STEPS:
        raise RuntimeError("train split too short for the smoke steps")
    trainer = Trainer(cfg, tcfg, device="cuda")
    state = trainer.init_state()
    torch.cuda.synchronize()
    log("train", vocab=cfg.vocab, dropout=cfg.dropout,
        params=trainer.num_params(state), balance=trainer.pipe.balance,
        batch=tcfg.batch_size, chunks=tcfg.chunks,
        checkpoint=tcfg.checkpoint, lr=tcfg.lr,
        setup_s=f"{time.perf_counter() - t0:.2f}")

    for c in _counters():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    t_all = time.perf_counter()
    for b in range(TRAIN_STEPS):
        t_step = time.perf_counter()
        state, info = trainer.train_epoch(source, epoch=0, state=state,
                                          max_steps=b + 1, start_step=b,
                                          log_every=1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_step)
        losses.append(info["loss"])
    wall = time.perf_counter() - t_all
    launches = {c.__name__: c.launches for c in _counters()}
    tokens = TRAIN_STEPS * tcfg.batch_size * BPTT
    steady = sum(step_s[1:]) / (TRAIN_STEPS - 1)
    log("train", steps=TRAIN_STEPS, losses=[f"{l:.6f}" for l in losses],
        seconds=f"{wall:.4f}", tokens=tokens,
        train_tokens_per_s=f"{tokens / wall:.1f}",
        ms_per_step=[f"{x * 1e3:.1f}" for x in step_s],
        steady_ms_per_step=f"{steady * 1e3:.1f}",
        steady_tokens_per_s=f"{tcfg.batch_size * BPTT / steady:.1f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        **launches)
    per_step = cfg.n_layers * CHUNKS
    recompute = cfg.n_layers * (CHUNKS - 1)      # except_last
    expected = {"flash_attention_fwd": TRAIN_STEPS * (per_step + recompute),
                "flash_attention_bwd_dq": TRAIN_STEPS * per_step,
                "flash_attention_bwd_dkv": TRAIN_STEPS * per_step}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} on the training "
                             f"path, expected {expected}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    del trainer, state
    torch.cuda.empty_cache()

    # Twins at dropout 0: one step's loss and gradients from the same weights
    # and batch, with the kernels (fp32), with plain attention (fp32) and
    # with plain attention in float64, the reference both are held to.
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    data, target = lm_text.get_batch(source, 0, BPTT)
    tokens_t = torch.from_numpy(data).long().cuda()
    target_t = torch.from_numpy(target).long().cuda()
    results = {}
    for name, impl, dtype in (("kernel", "flash", torch.float32),
                              ("plain", "xla", torch.float32),
                              ("f64", "xla", torch.float64)):
        seq = build_sequential(
            dataclasses.replace(cfg0, attn_impl=impl), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        seq.to(dtype)
        pipe = Pipe(seq, chunks=CHUNKS, checkpoint="except_last",
                    balance=pipelined_lm_balance(cfg.n_layers, N_STAGES),
                    device="cuda")
        before = [c.launches for c in _counters()]
        loss = lm_loss(pipe, tokens_t, target_t, train=True, seed=SEED)
        loss.backward()
        moved = [c.launches - n for c, n in zip(_counters(), before)]
        if (impl == "flash") != all(moved):
            raise AssertionError(f"{name} twin launched kernels {moved}")
        results[name] = (loss.item(), [p.grad for p in pipe.parameters()])
        names = [n for n, _ in pipe.named_parameters()]
        del seq, pipe
    l_64, g_64 = results.pop("f64")
    largest = [g.abs().max().item() for g in g_64]
    floor = GRAD_FLOOR * max(largest)
    worst = {}
    for name, (l, grads) in results.items():
        errs = [(a.double() - b).abs().max().item() / max(m, floor)
                for a, b, m in zip(grads, g_64, largest)]
        worst[name] = max(errs)
        log("train", twin=name, dropout=0.0, loss=f"{l:.9f}",
            loss_f64=f"{l_64:.9f}", loss_rel=f"{abs(l - l_64) / l_64:.3e}",
            max_grad_rel=f"{max(errs):.3e}",
            worst_param=names[errs.index(max(errs))],
            median_grad_rel=f"{sorted(errs)[len(errs) // 2]:.3e}",
            params_over_1e3=sum(e > 1e-3 for e in errs), params=len(errs),
            params_at_floor=sum(m < floor for m in largest))
        if abs(l - l_64) > TOL_LOSS_REL * l_64:
            raise AssertionError(f"{name} twin's loss {l} is not within "
                                 f"{TOL_LOSS_REL} of the float64 {l_64}")
    (l_k, _), (l_x, _) = results["kernel"], results["plain"]
    if abs(l_k - l_x) > TOL_LOSS_REL * abs(l_x):
        raise AssertionError(f"kernel path's loss {l_k} is not within "
                             f"{TOL_LOSS_REL} of plain attention's {l_x}")
    tol = max(TOL_GRAD_REL, GRAD_SLACK * worst["plain"])
    if worst["kernel"] > tol:
        raise AssertionError(
            f"kernel path's gradients are {worst['kernel']:.3e} of each "
            f"parameter's largest from the float64 twin's; plain attention "
            f"in fp32 is {worst['plain']:.3e} from it (tol {tol:.3e})")
    return launches


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    eval_launches = phase_slice()
    train_launches = phase_train()
    sources = {"flash_attn_fwd": ("flash_attn_fwd.cu", 87,
                                  "flash_attention_fwd"),
               "flash_attn_bwd_dq": ("flash_attn_bwd.cu", 162,
                                     "flash_attention_bwd_dq"),
               "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv.cu", 201,
                                      "flash_attention_bwd_dkv")}
    kernels = {"kernels": []}
    for name, (src, line, wrapper) in sources.items():
        row = rows[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"pipe_tpu_torch/csrc/{src}",
            "replaces": f"pipe_tpu/ops/pallas_attention.py:{line}",
            "launches": train_launches[wrapper],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        }
        if name == "flash_attn_fwd":
            entry["launches_eval"] = eval_launches
        kernels["kernels"].append(entry)
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
