"""The planner's step-fit walls, round by round, in chip_smoke's phase order.

    python3 tools/torch_fit_probe.py

Runs ``chip_smoke.py``'s phases up to and including train_obs (device,
build, kernels, slice, train, then train_obs three times) on one card and
prints one ``[fit]`` line per timed step of ``core/planner.py``'s
``fit_step_costs``: its m, the CUDA-event seconds, the host's seconds around
it, the garbage collections it saw per generation, and the tracked Python
objects. The three train_obs passes run with the collector as it is, with
every object of the earlier phases frozen (``gc.freeze``), and disabled, so
a wall that moves with the collector shows. Each pass's own fit line and
verdict follow (a refused fit is printed, not raised). Shows whether a
large m's step is host-bound and how much a busy host lengthens it beside a
small m's device-bound step.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from pipe_tpu_torch.core import balance  # noqa: E402


def main() -> int:
    real = balance._time_once
    mode = {"gc": "on"}

    def traced(fn, device):
        pipe = (fn.__defaults__ or (None,))[0]
        m = getattr(pipe, "chunks", None)
        before = [s["collections"] for s in gc.get_stats()]
        t0 = time.perf_counter()
        dt = real(fn, device)
        host = time.perf_counter() - t0
        after = [s["collections"] for s in gc.get_stats()]
        if m:
            print(f"[fit] gc={mode['gc']} m={m} event_s={dt:.4f} "
                  f"host_s={host:.4f} collections="
                  f"{[b - a for a, b in zip(before, after)]} "
                  f"objects={len(gc.get_objects())}", flush=True)
        return dt

    balance._time_once = traced
    smi = smoke.phase_device()
    smoke.phase_build()
    smoke.phase_kernels()
    smoke.phase_slice()
    smoke.phase_train()
    for name in ("on", "frozen", "off"):
        mode["gc"] = name
        if name == "frozen":
            gc.collect()
            gc.freeze()
        elif name == "off":
            gc.disable()
        try:
            smoke.phase_train_obs(smi)
            print(f"[fit] gc={name} train_obs passed", flush=True)
        except Exception as e:                 # noqa: BLE001 -- reported
            print(f"[fit] gc={name} train_obs raised {type(e).__name__}: "
                  f"{e}", flush=True)
        torch.cuda.empty_cache()
    gc.enable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
