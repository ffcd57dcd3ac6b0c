"""Multi-stage measured-bubble probe over a world of stage ranks.

``python -m pipe_tpu_torch.obs.bubble_probe [n_stages] [chunks]
[--schedules] [--transport] [--no-slope] [--d-model=N ...] [--device
cpu|cuda]`` spawns ``n_stages`` ranks (``runtime.distributed.launch``,
backend ``gloo``: CPU ranks, or ranks sharing the card), one stage each,
times one training step of the tutorial LM at ``m`` and ``2m``
micro-batches (per-micro-batch work held constant) through ``SpmdPipeline``
and prints one JSON line with the measured and analytic bubble (rank 0's
clock; the step's loss all-reduce ends it on every rank at once).
``--schedules`` adds the table executor's step per schedule (1f1b, 1f1b
under ``dots_saveable``, zb-h1 and the structurally split zb-h1 and zb-h2)
beside each table's analytic idle fraction; ``--transport`` adds the
overlapped-transport 1f1b row and the phase-compiled rows (with their ramp
and steady-state cycle counts), and the measured bubble of 1f1b serialized
and overlapped. Counterpart of ``pipe_tpu/obs/bubble_probe.py``, whose keys
it prints; ``platform`` names the device type and the world
(``cuda-gloo4``). ``--name=N`` sets an integer keyword of :func:`main`
(``--d-model``, ``--d-ff``, ``--seq-len``, ``--iters``).
"""

from __future__ import annotations

import json
import os
import sys
import time

# (row, ScheduledPipeline keywords): pipe_tpu's rows, in its order
_SCHEDULE_ROWS = (
    ("1f1b", dict(checkpoint="never", schedule="1f1b")),
    ("1f1b+policy", dict(checkpoint="except_last", schedule="1f1b",
                         remat_policy="dots_saveable")),
    ("zb-h1", dict(checkpoint="never", schedule="zb-h1")),
    ("zb-h1-split", dict(checkpoint="never", schedule="zb-h1",
                         split_stage="auto")),
    ("zb-h2-split", dict(checkpoint="never", schedule="zb-h2",
                         split_stage="auto")),
)
_OVERLAP_ROW = ("1f1b-overlap", dict(checkpoint="never", schedule="1f1b",
                                     overlap_transport=True))
_PHASE_ROWS = (
    ("1f1b-phase", dict(checkpoint="never", schedule="1f1b",
                        phase_compile=True)),
    ("zb-h1-phase", dict(checkpoint="never", schedule="zb-h1",
                         phase_compile=True)),
    ("zb-h1-split-phase", dict(checkpoint="never", schedule="zb-h1",
                               split_stage="auto", phase_compile=True)),
)


def schedule_rows(compare_transport: bool) -> list:
    """The ``--schedules`` rows, with ``--transport``'s in place. Each row
    sets both transport tri-states: the plain rows run serialized and
    interpreted on the card too, where the auto settings would turn both
    on (``pipe_tpu``'s rows rely on their CPU mesh's auto off)."""
    rows = list(_SCHEDULE_ROWS)
    if compare_transport:
        rows.insert(1, _OVERLAP_ROW)
        rows += _PHASE_ROWS
    return [(name, {"overlap_transport": False, "phase_compile": False,
                    **kw}) for name, kw in rows]


def main(n_stages: int = 4, chunks: int = 8,
         compare_schedules: bool = False, d_model: int = 256,
         d_ff: int = 512, seq_len: int = 64, skip_slope: bool = False,
         iters: int = 4, compare_transport: bool = False,
         device: str = "cuda") -> dict:
    """Run the probe on a world of ``n_stages`` ranks; rank 0's record."""
    from ..runtime.distributed import launch
    # the ranks import the rank function by its module's name, also when
    # this file runs as __main__
    from . import bubble_probe

    threads = (max(1, (os.cpu_count() or 1) // n_stages)
               if device == "cpu" else 0)
    kw = dict(compare_schedules=compare_schedules, d_model=d_model,
              d_ff=d_ff, seq_len=seq_len, skip_slope=skip_slope, iters=iters,
              compare_transport=compare_transport)
    return launch(bubble_probe._rank_probe, n_stages, n_stages, chunks, kw,
                  device=device, backend="gloo", threads=threads)[0]


def _rank_probe(n_stages: int, chunks: int, kw: dict) -> dict:
    """One stage rank of the probe (every rank times the same steps)."""
    import warnings

    import torch

    from ..core import microbatch as mb
    from ..core.schedule import bubble_fraction
    from ..models.transformer_lm import LMConfig, PipelinedLM
    from ..inference.pipelined import localize_stage
    from ..parallel.mesh import make_mesh
    from ..parallel.scheduled import ScheduledPipeline
    from ..parallel.spmd import SpmdPipeline
    from .meters import measured_bubble_slope

    iters = kw["iters"]
    mesh = make_mesh(n_stages, 1)
    dev = mesh.device
    cfg = LMConfig(vocab=512, d_model=kw["d_model"], nhead=4,
                   d_ff=kw["d_ff"], n_layers=n_stages,
                   seq_len=kw["seq_len"], dropout=0.0)
    model = localize_stage(PipelinedLM(
        cfg, n_stages, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)), mesh)
    params = [p for p in model.parameters() if p.device.type != "meta"]
    mb_rows = 4

    def make_batch(m: int):
        """One probe batch: m micro-batches of mb_rows, the same recipe for
        the slope and the schedule rows (the same workload)."""
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (mb_rows * m, cfg.seq_len),
                               generator=gen, device=dev)
        x, n_rows = mb.stack_scatter(
            {"tokens": tokens, "targets": torch.roll(tokens, -1, -1)}, m)
        return x, mb.valid_row_mask(x, n_rows)

    def timed(pipe, m: int) -> float:
        x, w = make_batch(m)

        def step():
            for p in params:
                p.grad = None
            loss, _ = pipe.loss_and_grad(x, w, seed=None)
            return loss

        step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / iters

    m = chunks
    out = {
        "platform": f"{dev.type}-gloo{n_stages}",
        "n_stages": n_stages,
        "chunks": m,
        "d_model": kw["d_model"],
        "analytic_bubble": round(bubble_fraction(m, n_stages), 4),
    }
    if not kw["skip_slope"]:
        spmd = SpmdPipeline(model.stage_fn, model.pre_fn,
                            model.loss_post_fn, n_stages, module=model,
                            checkpoint="never", post_with_batch=True,
                            mesh=mesh)
        t_m, t_2m = timed(spmd, m), timed(spmd, 2 * m)
        out.update({
            "t_m_sec": round(t_m, 5),
            "t_2m_sec": round(t_2m, 5),
            "measured_bubble": round(
                measured_bubble_slope(t_m, t_2m, m), 4),
        })
    if kw["compare_schedules"]:
        scheds = {}
        for name, kw_s in schedule_rows(kw["compare_transport"]):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pipe = ScheduledPipeline(
                    model.stage_fn, model.pre_fn, model.loss_post_fn,
                    n_stages=n_stages, module=model, mesh=mesh, **kw_s)
            sec = timed(pipe, m)
            scheds[name] = {
                "sec_per_step": round(sec, 5),
                "analytic_bubble": round(
                    pipe.schedule.bubble(m, n_stages), 4),
            }
            if kw_s.get("phase_compile"):
                prog = pipe._phase_program(m)
                scheds[name]["phase"] = (
                    {"unrolled_cycles": prog.unrolled_cycles,
                     "scan_cycles": prog.scan_cycles}
                    if prog is not None else "rejected")
            if kw["compare_transport"] and name in ("1f1b", "1f1b-overlap"):
                # the m/2m slope through the table executor, so the
                # transport's overlap shows in the number
                sec_2m = timed(pipe, 2 * m)
                scheds[name]["measured_bubble"] = round(
                    measured_bubble_slope(sec, sec_2m, m), 4)
        out["schedules"] = scheds
    return out


def parse_argv(args) -> tuple:
    """``(n_stages, chunks, keywords)`` of the command line."""
    kw = {"compare_schedules": "--schedules" in args,
          "skip_slope": "--no-slope" in args,
          "compare_transport": "--transport" in args}
    pos = []
    it = iter(args)
    for a in it:
        if a in ("--schedules", "--no-slope", "--transport"):
            continue
        if a == "--device":
            kw["device"] = next(it)
        elif a.startswith("--device="):
            kw["device"] = a.split("=", 1)[1]
        elif "=" in a and a.startswith("--"):
            k, v = a[2:].split("=", 1)
            kw[k.replace("-", "_")] = int(v)
        else:
            pos.append(a)
    n = int(pos[0]) if len(pos) > 0 else 4
    m = int(pos[1]) if len(pos) > 1 else 8
    return n, m, kw


if __name__ == "__main__":
    n, m, kw = parse_argv(sys.argv[1:])
    print(json.dumps(main(n, m, **kw)))
