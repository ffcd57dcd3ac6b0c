"""Interleaved virtual stages over the ranks: ``Trainer(schedule="interleaved")``.

Counterpart of ``pipe_tpu/parallel/interleaved.py``. Each of ``d`` stage
ranks hosts ``v`` non-contiguous virtual stages (virtual stage ``s`` on rank
``s % d``). JAX's executor runs a forward wavefront in which device ``p`` at
cycle ``c`` runs task ``k = c - p`` of its queue (group ``k // m``,
micro-batch ``k % m``, virtual stage ``(k // m) * d + p``; ``m >= d``) and
lets AD reverse it. :class:`InterleavedWavefront` is that wavefront and its
mirror as op tables (the backward of task ``k`` on device ``p`` at cycle
``(K + d - 1) + (K - 1 - k) + (d - 1 - p)``, ``K = m * v``), so the table
walk of ``parallel/scheduled.py`` runs it, over ranks or on one device;
:class:`InterleavedSpmdPipeline` is :class:`~.spmd.SpmdPipeline` over those
tables. Every forward finishes before the first backward (GPipe's liveness,
``m`` stashed inputs per virtual stage). :func:`stack_interleaved_params`
and :func:`unstack_interleaved_params` are JAX's device-major layout
(``convert.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.packing import tree_map
from ..core.schedule import BWD, FWD, IDLE, Schedule
from .spmd import SpmdPipeline

__all__ = ["InterleavedWavefront", "InterleavedSpmdPipeline",
           "stack_interleaved_params", "unstack_interleaved_params"]


def stack_interleaved_params(params_per_virtual_stage, n_devices: int):
    """``S = v * d`` trees stacked device-major (numpy): row ``p * v + g``
    holds virtual stage ``g * d + p``."""
    S = len(params_per_virtual_stage)
    if S % n_devices:
        raise ValueError(f"{S} virtual stages not divisible by "
                         f"{n_devices} devices")
    v = S // n_devices
    order = [g * n_devices + p for p in range(n_devices) for g in range(v)]
    return tree_map(lambda *leaves: np.stack([np.asarray(leaves[s])
                                              for s in order]),
                    *params_per_virtual_stage)


def unstack_interleaved_params(stacked, n_devices: int):
    """Inverse of :func:`stack_interleaved_params`: the per-virtual-stage
    list in virtual-stage order."""
    from ..core.packing import tree_leaves
    S = int(np.shape(tree_leaves(stacked)[0])[0])
    if S % n_devices:
        raise ValueError(f"{S} stacked rows not divisible by "
                         f"{n_devices} devices")
    v = S // n_devices
    return [tree_map(lambda a: np.asarray(a)[(vs % n_devices) * v
                                             + vs // n_devices], stacked)
            for vs in range(S)]


@dataclasses.dataclass(frozen=True)
class InterleavedWavefront(Schedule):
    """JAX's interleaved wavefront and its AD mirror as op tables
    ``(op[T, d], mb[T, d], grp[T, d])``, ``T = 2 (m v + d - 1)`` (module
    docstring)."""

    name: str = "interleaved"
    interleave: int = 2

    @property
    def v(self) -> int:
        return self.interleave

    def op_tables(self, m: int, d: int):
        v = self.interleave
        if v < 1:
            raise ValueError("interleave depth v must be >= 1")
        if v > 1 and m < d:
            raise ValueError(
                f"interleaved schedule needs chunks >= n_devices "
                f"(got m={m}, d={d}): an activation for micro-batch i must "
                f"be consumed before its next-group replacement arrives")
        K = m * v
        T = 2 * (K + d - 1)
        op = np.full((T, d), IDLE, np.int32)
        mbi = np.zeros((T, d), np.int32)
        grp = np.zeros((T, d), np.int32)
        for p in range(d):
            for k in range(K):
                g, i = divmod(k, m)
                for t, code in ((k + p, FWD),
                                (K + d - 1 + (K - 1 - k) + (d - 1 - p), BWD)):
                    op[t, p], mbi[t, p], grp[t, p] = code, i, g
        return op, mbi, grp

    def stash_slots(self, m: int, d: int) -> int:
        return m


@dataclasses.dataclass
class InterleavedSpmdPipeline(SpmdPipeline):
    """:class:`~.spmd.SpmdPipeline` over :class:`InterleavedWavefront`
    tables: ``v`` virtual stages per stage rank."""

    v: int = 2

    def __post_init__(self):
        self.schedule = InterleavedWavefront(interleave=self.v)
        super().__post_init__()
