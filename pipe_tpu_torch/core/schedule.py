"""Pipeline schedules as data (plain numpy).

Counterpart of the GPipe part of ``pipe_tpu/core/schedule.py``: the fill-drain
clock-cycle wavefront, where cycle ``k`` runs every ``(i, j)`` with
``i + j == k`` for micro-batch ``i`` of ``m`` on stage ``j`` of ``n`` —
``m + n - 1`` cycles and a bubble of ``(n - 1) / (m + n - 1)``. The other
schedules of ``pipe_tpu`` are not ported yet; :func:`get_schedule` names them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

__all__ = [
    "clock_cycles",
    "bubble_fraction",
    "Schedule",
    "GPipeSchedule",
    "get_schedule",
    "IDLE",
    "FWD",
    "BWD",
]

# Op codes of the (cycle, stage) tables.
IDLE, FWD, BWD = 0, 1, 2


def _place(op: np.ndarray, mbi: np.ndarray, t: int, j: int,
           code: int, i: int) -> None:
    if op[t, j] != IDLE:
        raise AssertionError(
            f"schedule collision at cycle {t}, stage {j}: "
            f"op {op[t, j]} already placed, tried {code} (mb {i})")
    op[t, j] = code
    mbi[t, j] = i


def clock_cycles(m: int, n: int) -> Iterator[List[Tuple[int, int]]]:
    """Anti-diagonal wavefront: cycle k runs {(i, j) : i + j == k};
    m micro-batches over n stages in m + n - 1 cycles."""
    for k in range(m + n - 1):
        yield [(k - j, j) for j in range(max(0, k - m + 1), min(n, k + 1))]


def bubble_fraction(m: int, n: int) -> float:
    """GPipe analytical bubble: (n-1)/(m+n-1) of cycles are idle fill/drain."""
    return (n - 1) / (m + n - 1)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base schedule: maps (micro-batches m, stages n) to an ordered cycle
    list. ``cycles(m, n)[k]`` is the list of (microbatch, stage) pairs that
    may run concurrently at cycle k. Executors rely only on this contract.
    """

    name: str = "base"

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        raise NotImplementedError

    def num_cycles(self, m: int, n: int) -> int:
        return len(self.cycles(m, n))

    def bubble(self, m: int, n: int) -> float:
        total = self.num_cycles(m, n) * n
        busy = m * n
        return (total - busy) / total

    def op_tables(self, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(op[T, n], mb[T, n])``: what stage ``j`` does at cycle ``t``
        (IDLE/FWD/BWD) and on which micro-batch."""
        raise NotImplementedError

    def stash_slots(self, m: int, n: int) -> int:
        """Max simultaneously-live stashed input activations per stage."""
        raise NotImplementedError

    @property
    def splits_backward(self) -> bool:
        return False

    @property
    def v(self) -> int:
        """Interleave depth: virtual stages per device (1 = not interleaved)."""
        return 1


@dataclasses.dataclass(frozen=True)
class GPipeSchedule(Schedule):
    """Synchronous fill-drain (the reference's schedule)."""

    name: str = "gpipe"

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        return [list(c) for c in clock_cycles(m, n)]

    def op_tables(self, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fill-drain forward (FWD of (i, j) at cycle ``i + j``), then the
        mirrored wavefront backward."""
        T = 2 * (m + n - 1)
        op = np.full((T, n), IDLE, np.int32)
        mbi = np.zeros((T, n), np.int32)
        for j in range(n):
            for i in range(m):
                _place(op, mbi, i + j, j, FWD, i)
                _place(op, mbi, (m + n - 1) + (m - 1 - i) + (n - 1 - j),
                       j, BWD, i)
        return op, mbi

    def stash_slots(self, m: int, n: int) -> int:
        """All m forwards complete before any backward: O(m) live inputs."""
        return m


_SCHEDULES = {"gpipe": GPipeSchedule}
# Schedules of pipe_tpu that this package does not have yet (ROADMAP.md).
_NOT_PORTED = ("1f1b", "interleaved", "interleaved-1f1b", "zb-h1", "zb-h2")


def get_schedule(name: str, **kwargs) -> Schedule:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"schedule {name!r} is not ported to pipe_tpu_torch yet "
            f"(ROADMAP.md, 'rest of core/schedule.py'); use 'gpipe'")
    if name not in _SCHEDULES:
        raise ValueError(
            f"unknown schedule {name!r}; options: "
            f"{sorted(_SCHEDULES) + sorted(_NOT_PORTED)}")
    return _SCHEDULES[name](**kwargs)
