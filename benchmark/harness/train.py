"""The flow of a training cell, for any runner's program.

Set-up builds the one training object and drives it from the seed through
steps 1 to 3 with the window's own call, on rows that all differ, reading
the loss of each, step 1's gradient from Adam's first moment
(``exp_avg = (1 - beta1) g`` after one step), and each leaf's distance from
its start after step 3. The window then runs whole steps on that same
object until ``--seconds`` have passed, synchronising after each call;
``train_tokens_per_s`` is its tokens over the time from its start to the
synchronised end of its last step. A traced run profiles a few more steps
after the window. The peak memory is the window's (the benchmark's own copies of the
weights and of step 1's gradient wait on the host). Once it is read and the
program is freed,
the plain reference trains a copy of the same weights on the same three
batches, and the numbers of ``harness/checks.py`` decide ``correct``.

A runner supplies ``Program(plan, weights, seed, device)`` with
``optimizer``, ``tokens_per_step``, ``leaves()``, ``run(first, n)`` (the
losses of batches first .. first+n-1), ``batch(step)``, ``probe(norms)``
(a context that appends each step's global gradient norm before the clip,
where the program clips), ``traced()`` and ``range_prefixes``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable

import torch

from harness import checks, core, plain, trace, yardstick
from harness.core import Outcome, Plan

COMPARED_STEPS = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def readings(prog, weights, device) -> dict:
    """Steps 1-3 through the program's own call, and what the check
    compares of them; step 1's gradient is kept on the host."""
    norms = []
    beta1 = prog.optimizer.param_groups[0]["betas"][0]
    with prog.probe(norms):
        losses = prog.run(0, 1)
        state = prog.optimizer.state
        grad = {n: (state[p]["exp_avg"] / (1 - beta1)
                    if "exp_avg" in state.get(p, {})
                    else torch.zeros_like(p))
                for n, p in prog.leaves()}
        # norms on the device: a float32 norm of a large leaf on the host
        # can be off by 1e-3 to 1e-2 of itself
        leaf_grad = {n: float(g.norm()) for n, g in grad.items()}
        grad = {n: g.cpu() for n, g in grad.items()}
        losses += prog.run(1, COMPARED_STEPS - 1)
    with torch.no_grad():
        leaf_change = {n: float((p.detach() - weights[n]).norm())
                       for n, p in prog.leaves()}
    grad_norm = (float(norms[0]) if norms
                 else math.sqrt(sum(g * g for g in leaf_grad.values())))
    _sync(device)
    return {"losses": [float(x) for x in losses], "grad_norm": grad_norm,
            "leaf_grad": leaf_grad, "leaf_change": leaf_change, "grad": grad}


def reference_readings(plan: Plan, logits_fn: Callable, weights, batches,
                       device, **kw) -> dict:
    """The plain reference's three steps from ``weights`` (wherever they
    are) on ``device``; ``kw`` goes to ``plain.train_steps``."""
    cell = plan.cell
    weights = {n: w.to(device) for n, w in weights.items()}
    return plain.train_steps(
        logits_fn, weights, batches, lr=cell["lr"],
        betas=tuple(cell["betas"]), eps=cell["eps"], clip=cell.get("clip"),
        row_block=cell["reference_rows"], **kw)


def attention_shape(plan: Plan, heads: int, seq: int, d_model: int) -> dict:
    """The shape of every flash-kernel call of the cell: one micro-batch
    of ``batch / chunks`` rows."""
    rows = plan.cell["batch"] // plan.cell["chunks"]
    return {"bh": rows * heads, "s": seq, "d": d_model // heads,
            "causal": True}


def run(plan: Plan, program_cls, logits_fn: Callable, seed: int,
        seconds: float, trace_on: bool, device, t_start: float,
        flops_shape: dict, attn: dict) -> Outcome:
    cell = plan.cell
    cuda = torch.device(device).type == "cuda"
    weights = plan.reference().make_weights(plan.config, seed, device)
    prog = program_cls(plan, weights, seed, device)
    got = readings(prog, weights, device)
    # the benchmark's own copies wait on the host, so that the peak is the
    # program's
    weights = {n: w.cpu() for n, w in weights.items()}
    step, k = COMPARED_STEPS, cell["steps_per_call"]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    core.settle_host()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    window_losses, steps = [], 0
    while True:
        window_losses += prog.run(step, k)
        step, steps = step + k, steps + k
        _sync(device)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds or step + k > cell["max_steps"]:
            break
    tokens_per_s = steps * prog.tokens_per_step / elapsed
    summary = None
    if trace_on:
        with prog.traced(), trace.Stretch() as stretch:
            window_losses += prog.run(step, cell["profile_steps"])
        summary = stretch.summary(prog.range_prefixes)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    batches = [prog.batch(b) for b in range(COMPARED_STEPS)]
    tokens_per_step = prog.tokens_per_step
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(plan, logits_fn, weights, batches, device,
                             against=got["grad"])
    gaps = checks.training_gaps(got, ref, ref["leaf_grad_diff"])
    held = checks.held(gaps, cell["limits"])
    failed = sum(not math.isfinite(x) for x in window_losses)
    required, hardware = yardstick.train_flops_per_token(**flops_shape)
    info = {
        "window_steps": steps, "window_s": elapsed,
        "tokens_per_step": tokens_per_step,
        "losses_compared": got["losses"],
        "reference_losses": ref["losses"],
        "gaps": gaps,
        "mfu_fp32_cuda_core_peak_pct": 100 * required * tokens_per_s
        / yardstick.PEAK_FP32_FLOPS,
        "hfu_fp32_cuda_core_peak_pct": 100 * hardware * tokens_per_s
        / yardstick.PEAK_FP32_FLOPS,
    }
    device_info = _device_info(device, peak)
    ctx = {"train": {"tokens_per_s": tokens_per_s,
                     "step_s": elapsed / steps,
                     "flops_per_token": required,
                     "profiled_steps": cell["profile_steps"],
                     "attention": attn},
           "trace": summary}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    return Outcome(
        correct=checks.passed(held) and failed == 0,
        attempted=steps + (cell["profile_steps"] if trace_on else 0),
        failed=failed, checks=held,
        end_to_end={"train_tokens_per_s": tokens_per_s,
                    "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s},
        layer_ctx=ctx, device=device_info, info=info,
        breakdown=trace.breakdown(summary) if summary else None)


def _device_info(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
