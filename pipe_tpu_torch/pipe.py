"""The user API: ``Pipe`` wraps a ``Sequential`` and runs it pipelined.

Counterpart of ``pipe_tpu/pipe.py`` without a mesh:

* ``Pipe(module, chunks, checkpoint, ...)`` with the same fail-fast
  validation (chunks type and sign, checkpoint mode, ``Sequential`` only,
  duplicate children);
* ``split_balance`` partitioning into per-stage sub-``Sequential``s;
* the container protocol ``__len__``/``__getitem__``/``__iter__``;
* ``forward(*inputs, train=False, seed=None)`` = check, scatter, run the
  GPipe wavefront, gather.

``Pipe`` is an ``nn.Module``: the partitions (and their weights) are its
submodules, on ``device``. The mesh executors, the planner front door,
deferred batch norm and the schedules other than GPipe are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from torch import nn

from .core import microbatch as mb
from .core.partition import (BalanceError, Stage, split_balance,
                             verify_splitting, verify_stages)
from .core.remat import validate_mode
from .core.schedule import Schedule, get_schedule
from .ops.layers import Sequential
from .parallel import emulator
from .utils.platform import DEFAULT_DEVICE, resolve_device

__all__ = ["Pipe", "NoChunk", "BalanceError"]

NoChunk = mb.NoChunk


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to pipe_tpu_torch yet (ROADMAP.md: {item})")


class Pipe(nn.Module):
    """Synchronous GPipe pipeline over a ``Sequential`` of layers, run by the
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
                 device=DEFAULT_DEVICE):
        super().__init__()
        if mesh is not None:
            raise _not_ported("Pipe(mesh=...)", "multi-device executors")
        if plan is not None:
            raise _not_ported("Pipe(plan=...)", "core/planner.py")
        if deferred_batch_norm:
            raise _not_ported("deferred_batch_norm", "extras/norm.py")
        # --- fail-fast validation ---
        if not isinstance(chunks, int) or isinstance(chunks, bool):
            raise TypeError("chunks must be an integer")
        if chunks <= 0:
            raise ValueError("number of chunks must be positive")
        validate_mode(checkpoint)
        if not isinstance(module, Sequential):
            raise TypeError("module must be a pipe_tpu_torch Sequential")
        seen = set()
        for layer in module:
            if id(layer) in seen:
                raise ValueError("module with duplicate children is not supported")
            seen.add(id(layer))
        sched_obj = (get_schedule(schedule) if isinstance(schedule, str)
                     else schedule)
        if not isinstance(sched_obj, Schedule) or sched_obj.name != "gpipe":
            raise _not_ported(f"schedule {getattr(sched_obj, 'name', sched_obj)!r}",
                              "rest of core/schedule.py")

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

    def forward(self, *inputs, train: bool = False, seed: Optional[int] = None):
        """Scatter the batch into ``chunks`` micro-batches, run the GPipe
        wavefront over the stages, gather. ``seed`` drives dropout when
        ``train``; checkpointing engages only in training."""
        mb.check(*inputs)
        batches = mb.scatter(inputs, self.chunks)
        stages = [Stage(p, name=f"stage{j}")
                  for j, p in enumerate(self.partitions)]
        batches = emulator.run(stages, batches, schedule=self._schedule,
                               checkpoint=self.checkpoint, train=train,
                               seed=seed)
        return mb.gather(batches)
