"""Chip smoke test of pipe_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without a result line:

1. device  -- the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 off for matmul and cuDNN, so fp32 means fp32.
2. build   -- nvcc builds every kernel source of the package for sm_90a.
3. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it (and a few more), with its time, the
   plain version's, one PyTorch library call's, and the least time the card
   could take (bytes or operations over the H100's peak rates).
4. slice   -- the main path: the tutorial Transformer LM at full width
   (d_model 2048, 32 heads, d_ff 2048, 16 layers, bptt 128, random weights
   from a seed) through ``Pipe(chunks=4, n_stages=2)`` in eval mode over 4
   batches of the tutorial text pipeline. The flash kernel must be launched
   16 layers x 4 chunks x 4 batches times, and the logits and losses must
   agree with a twin that runs plain attention on the same weights.

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
TOL_KERNEL = 1e-4        # fp32, sums taken in another order than the plain version
TOL_LOSS_REL = 1e-4      # flash vs plain-attention twin, per batch
TOL_LOGITS = 1e-3        # flash vs plain-attention twin, abs
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 FMA FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# (bh, s, d, causal): the slice's shape first (b*h = 2 x 32, bptt, 2048 / 32).
TIMED_SHAPES = [(64, 128, 64, True), (16, 512, 64, True), (8, 256, 128, False)]
# Ragged and odd shapes the kernel also takes: checked, not timed.
EDGE_SHAPES = [(3, 24, 8, True), (2, 8, 16, False), (4, 40, 48, True),
               (2, 200, 64, True), (2, 96, 96, False), (5, 136, 32, False)]


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


def phase_build() -> None:
    from pipe_tpu_torch import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    total = time.perf_counter() - t0
    for src, info in report.items():
        log("build", source=src, nvcc_s=f"{info['seconds']:.2f}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip(), flush=True)
    log("build", total_s=f"{total:.2f}")


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


def attention_bound(bh: int, s: int, d: int, causal: bool, elem: int):
    """Least time (ms) for one flash forward: q, k, v read once, o and lse
    written once; 4*d FLOPs per (query, key) pair the mask keeps."""
    nbytes = 4 * bh * s * d * elem + bh * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * pairs * bh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _qkv(bh, s, d, dtype, gen):
    return [torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def phase_kernels() -> dict:
    import torch.nn.functional as F

    from pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    slice_row = None

    def compare(bh, s, d, causal, dtype, tol):
        q, k, v = _qkv(bh, s, d, dtype, gen)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        if not (err_o <= tol and err_l <= tol):
            raise AssertionError(
                f"flash kernel disagrees with its plain version at "
                f"bh={bh} s={s} d={d} causal={causal} {dtype}: "
                f"max|dO|={err_o:.3e} max|dL|={err_l:.3e} > {tol}")
        return q, k, v, scale, err_o, err_l

    for bh, s, d, causal in TIMED_SHAPES:
        q, k, v, scale, err_o, err_l = compare(bh, s, d, causal,
                                               torch.float32, TOL_KERNEL)
        worst = max(worst, err_o, err_l)
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                    scale=scale))
        plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal,
                                                       scale))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale))
        bound, bound_by = attention_bound(bh, s, d, causal, 4)
        log("kernels", name="flash_attn_fwd", bh=bh, s=s, d=d, causal=causal,
            dtype="f32", max_abs_dO=f"{err_o:.3e}", max_abs_dL=f"{err_l:.3e}",
            ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}", library_ms=f"{lib:.5f}",
            bound_ms=f"{bound:.5f}", bound_by=bound_by,
            roofline=f"{bound / ms:.3f}")
        if slice_row is None:
            slice_row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=bound_by)
    for bh, s, d, causal in EDGE_SHAPES:
        *_, err_o, err_l = compare(bh, s, d, causal, torch.float32, TOL_KERNEL)
        worst = max(worst, err_o, err_l)
        log("kernels", check="edge", bh=bh, s=s, d=d, causal=causal,
            max_abs_dO=f"{err_o:.3e}", max_abs_dL=f"{err_l:.3e}")
    # bf16 in and out (fp32 inside): o rounds to bf16, 8 bits of mantissa.
    *_, err_o, err_l = compare(64, 128, 64, True, torch.bfloat16, 1e-2)
    log("kernels", check="bf16", bh=64, s=128, d=64, causal=True,
        max_abs_dO=f"{err_o:.3e}", max_abs_dL=f"{err_l:.3e}")
    slice_row["max_abs_err"] = worst
    return slice_row


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
        fa.flash_attention_fwd.launches = 0
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


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    row = phase_kernels()
    launches = phase_slice()
    kernels = {"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "pipe_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "pipe_tpu/ops/pallas_attention.py:87",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }]}
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
