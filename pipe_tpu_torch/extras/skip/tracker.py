"""Skip tracker: the runtime store that carries stashed values to their pops.

Counterpart of ``pipe_tpu/extras/skip/tracker.py``. Values are keyed per
micro-batch so the concurrent micro-batches of a schedule never mix, and a
pop consumes its value. The executors give every (micro-batch, stage) task a
fresh local tracker and carry the values that cross stages as the task's
explicit inputs and outputs (``parallel/emulator.py``), so a task that
``torch.utils.checkpoint`` re-runs in the backward writes into a tracker
that is thrown away.

``pipe_tpu``'s ``spec_mode`` is not ported: it serves JAX's shape inference
at ``Pipe.init`` and the sizing of the stat lanes before tracing. Here the
modules build their weights at construction and the one-device executors
learn every shape from the first value they see.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional, Tuple

import torch

from .layout import SkipLayout

__all__ = ["SkipTracker", "accumulate", "current_skip_tracker",
           "use_skip_tracker"]

_current: contextvars.ContextVar[Optional["_Scope"]] = contextvars.ContextVar(
    "pipe_tpu_torch_skip_scope", default=None)


class _Scope:
    __slots__ = ("tracker", "microbatch", "stage")

    def __init__(self, tracker: "SkipTracker", microbatch: int, stage: int):
        self.tracker = tracker
        self.microbatch = microbatch
        self.stage = stage


def _detach(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _detach(v) for k, v in value.items()}
    return value.detach() if isinstance(value, torch.Tensor) else value


def _add(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


class SkipTracker:
    """Stores stashed values per (microbatch, namespace, name); a pop
    consumes its value."""

    def __init__(self, layout: Optional[SkipLayout] = None):
        self.layout = layout
        self._store: Dict[Tuple[int, Any, str], Any] = {}
        # Cross-micro-batch stat accumulators (deferred BatchNorm), keyed
        # (ns, name) only: values add up across tasks.
        self.accum: Dict[Tuple[Any, str], Any] = {}

    # -- used by executors ------------------------------------------------
    @contextlib.contextmanager
    def scope(self, microbatch: int, stage: int):
        """Activate this tracker for one (microbatch, stage) task."""
        token = _current.set(_Scope(self, microbatch, stage))
        try:
            yield self
        finally:
            _current.reset(token)

    # -- used by skippable modules ---------------------------------------
    def save(self, microbatch: int, ns, name: str, value: Any) -> None:
        key = (microbatch, ns, name)
        if key in self._store:
            raise RuntimeError(
                f"skip {(ns, name)!r} stashed twice for microbatch {microbatch}")
        self._store[key] = value

    def load(self, microbatch: int, ns, name: str) -> Any:
        key = (microbatch, ns, name)
        if key not in self._store:
            raise RuntimeError(
                f"skip {(ns, name)!r} popped before stash "
                f"(microbatch {microbatch})")
        return self._store.pop(key)

    def accumulate(self, ns, name: str, value: Any) -> None:
        """Add ``value`` (a tensor or a dict of tensors) into the (ns, name)
        accumulator, detached: gradients are not tracked through stats.

        Stat-bearing layers (``DeferredBatchNorm``) add per-micro-batch
        partial sums here; the executor reads them once after the schedule
        drains."""
        key = (ns, name)
        value = _detach(value)
        self.accum[key] = (_add(self.accum[key], value) if key in self.accum
                           else value)

    def __len__(self) -> int:
        return len(self._store)


def accumulate(ns, name: str, value: Any) -> bool:
    """Accumulate into the active tracker; False (no-op) outside a run."""
    scope = _current.get()
    if scope is None:
        return False
    scope.tracker.accumulate(ns, name, value)
    return True


def current_skip_tracker() -> _Scope:
    """The active (tracker, microbatch, stage) scope, or raise."""
    scope = _current.get()
    if scope is None:
        raise RuntimeError(
            "stash/pop used outside a pipeline run (no active skip tracker); "
            "skippable modules only work under Pipe/emulator execution")
    return scope


@contextlib.contextmanager
def use_skip_tracker(tracker: SkipTracker, microbatch: int = 0, stage: int = 0):
    """Public form of :meth:`SkipTracker.scope`."""
    with tracker.scope(microbatch, stage):
        yield tracker
