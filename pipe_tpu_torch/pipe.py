"""The user API: ``Pipe`` wraps a ``Sequential`` and runs it pipelined.

Counterpart of ``pipe_tpu/pipe.py`` without a mesh:

* ``Pipe(module, chunks, checkpoint, ...)`` with the same fail-fast
  validation (chunks type and sign, checkpoint mode, ``Sequential`` only,
  duplicate children);
* ``split_balance`` partitioning into per-stage sub-``Sequential``s;
* the container protocol ``__len__``/``__getitem__``/``__iter__``;
* ``forward(*inputs, train=False, seed=None)`` = check, scatter, run the
  schedule's wavefront (``schedule.cycles``), gather;
* ``@skippable`` layers: ``verify_skippables`` and the static
  ``skip_layout`` at construction, a skip tracker threaded through the
  emulator's tasks;
* ``remat_policy``: a ``core.remat.checkpoint_policies`` member (or its
  name) for the micro-batches the checkpoint mode recomputes, set at
  construction or per call (``forward(..., remat_policy=)``, which wins);
  ``HeteroScheduledPipeline(..., remat_policy=pipe.remat_policy)`` takes it
  for the tables;
* ``plan=``: a planner ``Plan`` (or the path of a saved one,
  ``core/planner.py``) fixes chunks, checkpoint, schedule and balance, with
  ``pipe_tpu``'s conflict errors. A plan with ``split_stage`` set prescribes
  the structural B/W split, which raises (ROADMAP.md A.8; ``pipe_tpu`` warns
  and runs its stored-vjp split instead);
* ``deferred_batch_norm=True``: plain ``BatchNorm`` layers become
  ``DeferredBatchNorm``, and a train forward commits one running-stats
  update per mini-batch, in place on their buffers (``pipe_tpu`` returns
  ``(out, new_params)``; here the weights live in the modules).

``Pipe`` is an ``nn.Module``: the partitions (and their weights) are its
submodules, on ``device``. Every registered schedule is accepted, as by
``pipe_tpu``'s ``Pipe`` without a mesh; the table-only schedules
(``interleaved-1f1b``, ``zb-h1``, ``zb-h2``) raise from ``cycles`` at the
first forward, with ``pipe_tpu``'s message. Training through the op tables
is ``parallel/scheduled.py`` (and ``parallel/hetero_scheduled.py`` for a
``Pipe``'s partitions). The mesh executors are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from torch import nn

from .core import microbatch as mb
from .core.partition import (BalanceError, Stage, split_balance,
                             verify_splitting, verify_stages)
from .core.remat import resolve_policy, validate_mode
from .core.schedule import Schedule, get_schedule
from .extras.norm import (DeferredBatchNorm, commit_batchnorm_stats,
                          convert_deferred_batch_norm)
from .extras.skip import SkipTracker, inspect_skip_layout, verify_skippables
from .ops.layers import Sequential
from .parallel import emulator
from .utils.platform import DEFAULT_DEVICE, resolve_device

__all__ = ["Pipe", "NoChunk", "BalanceError"]

NoChunk = mb.NoChunk


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to pipe_tpu_torch yet (ROADMAP.md: {item})")


class Pipe(nn.Module):
    """Synchronous pipeline over a ``Sequential`` of layers, run by the
    serial clock-cycle emulator on one device."""

    def __init__(self,
                 module: Sequential,
                 chunks: int = 1,
                 checkpoint: str = "except_last",
                 *,
                 n_stages: Optional[int] = None,
                 balance: Optional[Sequence[int]] = None,
                 schedule: str = "gpipe",
                 mesh=None,
                 plan=None,
                 deferred_batch_norm: bool = False,
                 remat_policy=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if mesh is not None:
            raise _not_ported("Pipe(mesh=...)", "multi-device executors")
        # --- auto-planner front door (core/planner.py): the plan fixes
        # chunks/schedule/balance/n_stages and the checkpoint mode it was
        # scored under; config it already decides cannot also be passed.
        if plan is not None:
            from .core.planner import Plan
            if isinstance(plan, str):
                plan = Plan.load(plan)
            if (chunks != 1 or balance is not None or n_stages is not None
                    or schedule != "gpipe"):
                raise ValueError(
                    "Pipe(plan=...) already fixes chunks, schedule, "
                    "balance and n_stages — drop the hand-passed values "
                    "(or drop the plan)")
            if checkpoint != "except_last" \
                    and checkpoint != plan.checkpoint:
                raise ValueError(
                    f"checkpoint={checkpoint!r} conflicts with the plan's "
                    f"{plan.checkpoint!r} (the plan was scored under its "
                    f"own checkpoint mode)")
            if plan.split_stage:
                raise _not_ported(
                    "a plan with split_stage=True (the structural B/W split "
                    "of core/remat.py)", "A.8")
            chunks = plan.m
            checkpoint = plan.checkpoint
            schedule = plan.schedule_obj()
            balance = list(plan.balance)
            n_stages = len(balance)
        self.plan = plan
        # --- fail-fast validation ---
        if not isinstance(chunks, int) or isinstance(chunks, bool):
            raise TypeError("chunks must be an integer")
        if chunks <= 0:
            raise ValueError("number of chunks must be positive")
        validate_mode(checkpoint)
        self.remat_policy = resolve_policy(remat_policy)
        if not isinstance(module, Sequential):
            raise TypeError("module must be a pipe_tpu_torch Sequential")
        seen = set()
        for layer in module:
            if id(layer) in seen:
                raise ValueError("module with duplicate children is not supported")
            seen.add(id(layer))
        sched_obj = (get_schedule(schedule) if isinstance(schedule, str)
                     else schedule)
        if deferred_batch_norm and getattr(sched_obj, "splits_backward",
                                           False):
            raise NotImplementedError(
                "deferred_batch_norm does not compose with "
                "split-backward schedules (zb-h1): the W op's vjp seed "
                "has no stats slot — pick 'gpipe' or '1f1b'")
        if deferred_batch_norm:
            module = convert_deferred_batch_norm(module, chunks)
        self.deferred_batch_norm = deferred_batch_norm

        self.device = resolve_device(device)
        self.chunks = chunks
        self.checkpoint = checkpoint
        if balance is not None and n_stages is None:
            n_stages = len(balance)
        if n_stages is None:
            n_stages = 1
        self.balance = split_balance(len(module), n_stages, balance)
        self.n_stages = n_stages

        parts: List[Sequential] = []
        offset = 0
        for width in self.balance:
            parts.append(module[offset:offset + width])
            offset += width
        self.partitions = nn.ModuleList(parts).to(self.device)
        verify_stages(self.partitions)
        verify_splitting(self.partitions)
        self._schedule: Schedule = sched_obj

        # Skip wiring: the fail-fast check and the static stash->pop layout.
        verify_skippables(module)
        self.skip_layout = inspect_skip_layout(self.partitions)
        self._has_bn = any(isinstance(l, DeferredBatchNorm) for l in self)
        self._needs_tracker = self.skip_layout.num_skips > 0 or self._has_bn

    # --- container protocol ---

    def __len__(self) -> int:
        """Total number of layers across all partitions."""
        return sum(len(p) for p in self.partitions)

    def __getitem__(self, index: int) -> nn.Module:
        layers: List[nn.Module] = []
        for p in self.partitions:
            layers.extend(p)
        return layers[index]

    def __iter__(self):
        for p in self.partitions:
            yield from p

    # --- forward ---

    def forward(self, *inputs, train: bool = False, seed: Optional[int] = None,
                remat_policy=None):
        """Scatter the batch into ``chunks`` micro-batches, run the
        schedule's wavefront over the stages, gather. ``seed`` drives
        dropout when ``train``; checkpointing engages only in training,
        selectively under ``remat_policy`` (this call's, else the
        ``Pipe``'s). A train forward commits the deferred-BatchNorm stats of
        the whole mini-batch once, in place."""
        if remat_policy is None:
            remat_policy = self.remat_policy
        mb.check(*inputs)
        batches = mb.scatter(inputs, self.chunks)
        stages = [Stage(p, name=f"stage{j}")
                  for j, p in enumerate(self.partitions)]
        tracker = (SkipTracker(self.skip_layout) if self._needs_tracker
                   else None)
        batches = emulator.run(stages, batches, schedule=self._schedule,
                               checkpoint=self.checkpoint, train=train,
                               seed=seed, remat_policy=remat_policy,
                               skip_tracker=tracker)
        out = mb.gather(batches)
        if self._has_bn and train:
            commit_batchnorm_stats(self.partitions, tracker.accum)
        return out
