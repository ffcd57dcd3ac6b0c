"""Serial clock-cycle executor: the pipeline semantics on one device.

Counterpart of ``pipe_tpu/parallel/emulator.py``: iterate the schedule's
wavefront; for each (i, j) run stage j on micro-batch i, under
``torch.utils.checkpoint`` when ``i < checkpoint_stop`` (selective under a
``remat_policy``). The data dependence between cycles is plain function
composition on one CUDA stream; the first stage failure propagates at once.

With a skip tracker, cross-stage skips and deferred-BatchNorm sums cross each
task (and so its checkpoint) as explicit inputs and outputs: the pops of
stage ``j`` are loaded from the persistent tracker and passed in, a fresh
local tracker serves the stage's ``stash``/``pop`` inside the task, and only
the outer call writes the task's stashes and stat sums back. The recompute of
``torch.utils.checkpoint`` re-runs the task into a local tracker that is
thrown away, so nothing is stashed or counted twice, and a pop's gradient
flows back to its stash site through autograd. Each task's forward runs in
the profiler range ``chunk{i}-stage{j}`` (``obs.meters.stage_scope``); while a
profiler runs, its backward gets the same label (``obs.meters.mark_backward``).
The chaos and hop-health hooks of ``pipe_tpu`` are not ported yet
(ROADMAP.md: A.7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..core import microbatch as mb
from ..core.partition import Stage, StageCtx
from ..core.remat import apply_remat, checkpoint_stop, validate_mode
from ..core.schedule import GPipeSchedule, Schedule
from ..obs.meters import mark_backward, stage_scope

__all__ = ["run"]


def _compute_one(stage: Stage, batch: mb.Batch, ctx: StageCtx,
                 remat: bool, remat_policy=None,
                 skip_tracker=None) -> mb.Batch:
    """Run one (microbatch, stage) task, optionally rematerialized. The ctx
    (and its seed) is bound into the task, so a recomputed forward sees the
    same seed and replays the same dropout."""
    if skip_tracker is None:
        def task(*inputs):
            return stage(*inputs, ctx=ctx)

        task = apply_remat(task, enabled=remat, policy=remat_policy)
        with stage_scope(ctx.microbatch, ctx.stage):
            return _marked(batch.call(task), ctx)

    from ..extras.skip import SkipTracker

    layout = skip_tracker.layout
    pop_keys = layout.pops_of(ctx.stage) if layout else ()
    stash_keys = layout.stashes_of(ctx.stage) if layout else ()
    pop_vals = [skip_tracker.load(ctx.microbatch, ns, name)
                for ns, name in pop_keys]
    n_pops = len(pop_keys)

    def task(*args):
        local = SkipTracker(layout)
        for (ns, name), v in zip(pop_keys, args[:n_pops]):
            local.save(ctx.microbatch, ns, name, v)
        with local.scope(ctx.microbatch, ctx.stage):
            out = stage(*args[n_pops:], ctx=ctx)
        stash_vals = tuple(local.load(ctx.microbatch, ns, name)
                           for ns, name in stash_keys)
        return out, stash_vals, dict(local.accum)

    task = apply_remat(task, enabled=remat, policy=remat_policy)
    with stage_scope(ctx.microbatch, ctx.stage):
        result, stash_vals, accums = task(*pop_vals, *batch.values)
    for (ns, name), v in zip(stash_keys, stash_vals):
        skip_tracker.save(ctx.microbatch, ns, name, v)
    for (ns, name), v in accums.items():
        skip_tracker.accumulate(ns, name, v)
    if isinstance(result, (tuple, list)):
        return _marked(mb.Batch(tuple(result), atomic=False), ctx)
    return _marked(mb.Batch(result, atomic=True), ctx)


def _marked(batch: mb.Batch, ctx: StageCtx) -> mb.Batch:
    """``batch`` with its backward in the task's profiler range while a
    profiler runs (``obs.meters.mark_backward``); ``batch`` itself
    otherwise."""
    values = mark_backward(batch.values, ctx.microbatch, ctx.stage)
    if values is batch.values:
        return batch
    return mb.Batch(values[0] if batch.atomic else values,
                    atomic=batch.atomic)


def run(stages: Sequence[Stage],
        batches: List[mb.Batch],
        *,
        schedule: Optional[Schedule] = None,
        checkpoint: str = "never",
        train: bool = False,
        seed: Optional[int] = None,
        remat_policy=None,
        skip_tracker=None) -> List[mb.Batch]:
    """Execute the clock-cycle schedule serially; returns transformed batches.

    Each task's ctx seed is ``seed`` folded over ``(i, j)``. A
    ``remat_policy`` (``core.remat.checkpoint_policies``) makes the remat of
    the checkpointed micro-batches selective. ``skip_tracker``
    (a :class:`~pipe_tpu_torch.extras.skip.SkipTracker` over the stages'
    skip layout) carries skips and stat sums between tasks.
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
                                      remat=i < stop,
                                      remat_policy=remat_policy,
                                      skip_tracker=skip_tracker)
    return batches
