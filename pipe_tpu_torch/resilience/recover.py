"""Recovery policies: skip-step aux state, bounded rewind, data retry.

Counterpart of ``pipe_tpu/resilience/recover.py``:

1. **Skip-step** -- an anomalous step's update is dropped inside the guarded
   step (a ``where``-select against pre-step copies, ``train/loop.py``); the
   device-side aux carry ``(loss EWMA, consecutive anomalies, total
   anomalies)`` tracks it with no host involvement.
2. **Rewind** -- when anomalies persist (``consec >= rewind_after``) the
   host restores the last known-good in-memory snapshot (a clone, never the
   live tensors the trainer shares); each successive rewind sleeps an
   exponentially longer backoff, and after ``max_rewinds`` the controller
   raises :class:`TrainingAborted`.
3. **Data retry** -- :class:`RetryingIterator` rebuilds a failed batch
   iterator at its last position with exponential backoff; exhausting the
   budget raises :class:`DataIteratorFailed`.

Everything host-side here is clock- and sleep-injectable, so the tests run
deterministically without real waiting.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

__all__ = ["ResilienceConfig", "ResilienceController", "RetryingIterator",
           "TrainingAborted", "DataIteratorFailed"]


class TrainingAborted(RuntimeError):
    """Anomalies persisted through the rewind budget — the run cannot
    make progress and refuses to pretend otherwise."""


class DataIteratorFailed(RuntimeError):
    """The data iterator kept failing past the retry budget."""


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Detection + recovery knobs (``TrainerConfig.resilience``; None —
    the default — keeps the train step bitwise identical to the
    unguarded build)."""

    # detection (inside the guarded step; detect.step_guard)
    spike_factor: float = 4.0     # loss > factor * EWMA => anomaly
    warmup_steps: int = 10        # spike check disarmed before this step
    ewma_alpha: float = 0.1       # loss-EWMA horizon (~10 accepted steps)
    # host cadence: read the device verdict every N steps (1 = every
    # step; >1 trades detection latency for fewer host syncs on
    # async-dispatch backends)
    check_every: int = 1
    # rewind policy
    rewind_after: int = 3         # consecutive anomalies => rewind
    max_rewinds: int = 3          # then TrainingAborted
    rewind_backoff_s: float = 0.0  # sleep 2**k * this before rewind k
    snapshot_every: int = 10      # known-good snapshot cadence (steps)
    # data-iterator retry
    data_retries: int = 3
    data_backoff_s: float = 0.05

    def __post_init__(self):
        if self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {self.spike_factor}")
        if self.check_every < 1 or self.rewind_after < 1 \
                or self.snapshot_every < 1:
            raise ValueError(
                "check_every, rewind_after and snapshot_every must all "
                "be >= 1")
        if self.max_rewinds < 0 or self.data_retries < 0:
            raise ValueError(
                "max_rewinds and data_retries must be >= 0")


def _copy_tree(tree):
    """A copy of ``tree`` whose tensors are clones: dicts, lists, tuples and
    dataclasses (``TrainState``) are rebuilt, other leaves shared."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _copy_tree(getattr(tree, f.name))
                     for f in dataclasses.fields(tree)})
    return tree


class ResilienceController:
    """Host half of the recovery loop: owns the known-good snapshot (a
    clone), the rewind budget/backoff, and the resilience.* counters/events.

    ``after_step`` is called by ``Trainer.train_epoch`` after each
    guarded step with the fresh ``(state, aux)``; it reads the device
    verdict every ``check_every`` steps and returns the (possibly
    rewound) pair. ``aux`` is the device carry
    ``(loss_ewma f32, consec i32, anomalies i32)``.
    """

    def __init__(self, cfg: ResilienceConfig, registry, events,
                 log_fn: Callable[[str], None] = print,
                 sleep: Callable[[float], None] = time.sleep):
        self.cfg = cfg
        self.registry = registry
        self.events = events
        self.log_fn = log_fn
        self.sleep = sleep
        self.rewinds = 0
        self._snapshot: Optional[Tuple[Any, Any]] = None
        self._snapshot_step: Optional[int] = None
        self._seen_anomalies = 0

    @property
    def anomalies(self) -> int:
        """Total anomalous (skipped) steps observed so far."""
        return self._seen_anomalies

    # -- snapshots ----------------------------------------------------------

    def snapshot(self, state, aux, step: int) -> None:
        """Record (a copy of) a known-good state; never called with an
        anomalous one (the loop snapshots only at consec == 0)."""
        self._snapshot = (_copy_tree(state), _copy_tree(aux))
        self._snapshot_step = step

    # -- the per-step hook --------------------------------------------------

    def after_step(self, b: int, state, aux):
        """Inspect the verdict (on the check cadence), apply the rewind
        policy, refresh the snapshot. Returns ``(state, aux)`` —
        rewound copies when the policy fired, the inputs otherwise."""
        cfg = self.cfg
        if (b + 1) % cfg.check_every:
            return state, aux
        _, consec_a, total_a = aux
        consec = int(consec_a)      # the host sync point (check cadence)
        total = int(total_a)
        if total > self._seen_anomalies:
            fresh = total - self._seen_anomalies
            self._seen_anomalies = total
            self.registry.counter("resilience.anomalies").inc(fresh)
            self.registry.counter("resilience.skipped_steps").inc(fresh)
            self.events.event("resilience", action="skip_step", step=b,
                              consecutive=consec, total=total)
        if consec == 0:
            if self._snapshot is None or (b + 1) % cfg.snapshot_every == 0:
                self.snapshot(state, aux, b)
            return state, aux
        if consec < cfg.rewind_after:
            return state, aux
        # persistent anomalies: rewind (bounded, exponential backoff)
        if self.rewinds >= cfg.max_rewinds:
            raise TrainingAborted(
                f"{consec} consecutive anomalous steps at step {b} after "
                f"{self.rewinds} rewinds (max_rewinds="
                f"{cfg.max_rewinds}) — refusing to continue on "
                f"persistently poisoned state")
        if self._snapshot is None:
            raise TrainingAborted(
                f"{consec} consecutive anomalous steps at step {b} with "
                f"no known-good snapshot to rewind to")
        backoff = cfg.rewind_backoff_s * (2 ** self.rewinds)
        if backoff > 0:
            self.sleep(backoff)
        self.rewinds += 1
        self.registry.counter("resilience.rewinds").inc()
        self.events.event("resilience", action="rewind", step=b,
                          to_step=self._snapshot_step,
                          rewind=self.rewinds, backoff_s=backoff)
        self.log_fn(f"| resilience: rewind #{self.rewinds} at step {b} "
                    f"-> snapshot of step {self._snapshot_step} "
                    f"({consec} consecutive anomalies)")
        snap_state, snap_aux = self._snapshot
        # hand out copies: the trainer loads them into its live tensors,
        # and the snapshot must survive further rewinds
        ewma, consec0, total0 = snap_aux
        fresh_aux = (_copy_tree(ewma), torch.zeros_like(consec0),
                     torch.full_like(total0, self._seen_anomalies))
        return _copy_tree(snap_state), fresh_aux


class RetryingIterator:
    """Iterator wrapper that rebuilds a failed source at its position.

    ``factory(pos)`` must return an iterator yielding items from index
    ``pos`` on (``Trainer._batches(..., start=pos)`` has exactly this
    shape). ``StopIteration`` passes through; any other exception —
    including injected :class:`~.chaos.ChaosError`\\ s via ``chaos`` —
    burns one retry, sleeps an exponential backoff, and rebuilds.
    """

    def __init__(self, factory: Callable[[int], Iterator], *,
                 retries: int = 3, backoff_s: float = 0.05,
                 chaos=None, registry=None, events=None,
                 sleep: Callable[[float], None] = time.sleep,
                 start: int = 0):
        self._factory = factory
        self._retries = retries
        self._backoff_s = backoff_s
        self._chaos = chaos
        self._registry = registry
        self._events = events
        self._sleep = sleep
        self._it: Optional[Iterator] = None
        # ``start`` seeds the position for mid-epoch resumption (the
        # elastic path): chaos/data indices stay GLOBAL batch indices.
        self._pos = int(start)

    def __iter__(self) -> "RetryingIterator":
        return self

    def __next__(self):
        last: Optional[Exception] = None
        for attempt in range(self._retries + 1):
            try:
                if self._it is None:
                    self._it = self._factory(self._pos)
                if self._chaos is not None and attempt == 0:
                    self._chaos.maybe_raise_data(self._pos)
                item = next(self._it)
                self._pos += 1
                return item
            except StopIteration:
                raise
            except Exception as e:           # noqa: BLE001 — retry scope
                last = e
                self._it = None              # rebuild from _pos
                if self._registry is not None:
                    self._registry.counter("resilience.data_retries").inc()
                if self._events is not None:
                    self._events.event("resilience", action="data_retry",
                                       batch=self._pos, attempt=attempt,
                                       error=type(e).__name__)
                if attempt < self._retries:
                    self._sleep(self._backoff_s * (2 ** attempt))
        raise DataIteratorFailed(
            f"data iterator failed {self._retries + 1} times at batch "
            f"{self._pos} (last: {type(last).__name__}: {last})")
