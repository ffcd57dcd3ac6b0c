"""Serial clock-cycle executor: the pipeline semantics on one device.

Counterpart of ``pipe_tpu/parallel/emulator.py``: iterate the schedule's
wavefront; for each (i, j) run stage j on micro-batch i, under
``torch.utils.checkpoint`` when ``i < checkpoint_stop``. The data dependence
between cycles is plain function composition on one CUDA stream; the first
stage failure propagates at once. The chaos and hop-health hooks and the skip
tracker of ``pipe_tpu`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core import microbatch as mb
from ..core.partition import Stage, StageCtx
from ..core.remat import apply_remat, checkpoint_stop, validate_mode
from ..core.schedule import GPipeSchedule, Schedule

__all__ = ["run"]


def _compute_one(stage: Stage, batch: mb.Batch, ctx: StageCtx,
                 remat: bool) -> mb.Batch:
    """Run one (microbatch, stage) task, optionally rematerialized. The ctx
    (and its seed) is bound into the task, so a recomputed forward sees the
    same seed and replays the same dropout."""

    def task(*inputs):
        return stage(*inputs, ctx=ctx)

    task = apply_remat(task, enabled=remat)
    with torch.profiler.record_function(
            f"chunk{ctx.microbatch}-stage{ctx.stage}"):
        return batch.call(task)


def run(stages: Sequence[Stage],
        batches: List[mb.Batch],
        *,
        schedule: Optional[Schedule] = None,
        checkpoint: str = "never",
        train: bool = False,
        seed: Optional[int] = None) -> List[mb.Batch]:
    """Execute the clock-cycle schedule serially; returns transformed batches.

    Each task's ctx seed is ``seed`` folded over ``(i, j)``.
    """
    validate_mode(checkpoint)
    schedule = schedule or GPipeSchedule()
    m, n = len(batches), len(stages)
    stop = checkpoint_stop(checkpoint, m, train)
    batches = list(batches)

    for cycle in schedule.cycles(m, n):
        for (i, j) in cycle:
            if not (0 <= i < m and 0 <= j < n):
                raise IndexError(
                    f"schedule {schedule.name!r} emitted task (microbatch={i}, "
                    f"stage={j}) outside the {m}x{n} grid")
            ctx = StageCtx(seed=seed, train=train, microbatch=i, stage=j)
            ctx = ctx.fold(i, j)
            batches[i] = _compute_one(stages[j], batches[i], ctx,
                                      remat=i < stop)
    return batches
