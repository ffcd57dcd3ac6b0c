"""Anomaly detection for the train step.

Counterpart of the train half of ``pipe_tpu/resilience/detect.py``:
:func:`step_guard` runs inside the guarded train step, a finiteness test of
the loss and the global gradient norm fused with a loss-spike test against
an EWMA kept on the device. It reads nothing back to the host: the verdict
is a 0-dim device tensor the step uses to select the pre-step state back in
(``train/loop.py``), and the host reads the aux carry on its own cadence
(``ResilienceConfig.check_every``). :func:`stage_heartbeat` is the per-stage
gradient power of elastic training. :class:`HopHealth` is the emulator's
per-hop failure-streak ledger and :class:`TickWatchdog` the serve tick's
health policy, both host-side bookkeeping copied from ``pipe_tpu``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import torch

__all__ = ["step_guard", "stage_heartbeat", "global_norm", "HopHealth",
           "TickWatchdog"]


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32 (a NaN or
    inf anywhere propagates into it)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads
                          if g is not None))


def step_guard(loss, grads, ewma, step, *, spike_factor: float,
               warmup_steps: int, ewma_alpha: float,
               gnorm: Optional[torch.Tensor] = None):
    """Fused finiteness + loss-spike check.

    Returns ``(ok, new_ewma)`` as 0-dim device tensors: ``ok`` is False when
    the loss or any gradient is non-finite, or (past warm-up, ``step >=
    warmup_steps``, and once the EWMA holds an accepted loss) the loss
    exceeds ``spike_factor`` x the EWMA of accepted losses. The EWMA folds
    only accepted steps, so a rejected spike does not drag the baseline
    toward itself. ``pipe_tpu`` arms the spike test at warm-up even with an
    empty EWMA (0), so an epoch that starts past warm-up (the carry starts
    empty in every ``train_epoch``: a second epoch, a resumed run) rejects
    every step and aborts; here an empty EWMA is seeded first (ROADMAP.md
    C.10). ``gnorm`` is the global gradient norm
    when the caller has it already (the trainer's clip computes it, so the
    gradients are not reduced twice); else it is computed from ``grads``.
    ``step`` is an int or a tensor.
    """
    loss32 = loss.float()
    if gnorm is None:
        gnorm = global_norm(grads)
    finite = torch.isfinite(loss32) & torch.isfinite(gnorm)
    # a non-finite loss fails `finite` already; the compare is guarded so a
    # NaN loss cannot pass through compare-False semantics
    seeded = ewma > 0.0
    spike = finite & seeded & (loss32 > ewma * spike_factor)
    warmed = step >= warmup_steps
    if isinstance(warmed, torch.Tensor):
        spike = spike & warmed
    elif not warmed:
        spike = torch.zeros_like(spike)
    ok = finite & ~spike
    new_ewma = torch.where(
        ok,
        torch.where(seeded,
                    ewma_alpha * loss32 + (1.0 - ewma_alpha) * ewma, loss32),
        ewma)
    return ok, new_ewma


def stage_heartbeat(stage_grads: Iterable[torch.Tensor],
                    n_stages: int) -> torch.Tensor:
    """Per-stage gradient power: ``[n_stages]`` float32 sums of squared
    gradients, over tensors whose leading axis is the stage (the stacked
    layout of ``pipe_tpu``). A killed stage ``j`` (output zeroed) gives
    exactly 0.0 for every stage ``<= j``."""
    total = None
    for g in stage_grads:
        g32 = g.float()
        part = (g32 * g32).sum(dim=tuple(range(1, g32.dim()))) \
            if g32.dim() > 1 else g32 * g32
        total = part if total is None else total + part
    if total is None:
        return torch.zeros(n_stages)
    return total


@dataclasses.dataclass
class HopHealth:
    """Per-hop failure-streak ledger for the emulator executor.

    The emulator records every stage-boundary crossing
    (:meth:`record`): a chaos-faulted hop bumps that hop's consecutive
    streak, a clean crossing resets it. A transient ``transport_drop``
    (one micro-batch) therefore never accumulates, while a
    ``persistent_hop_drop`` marches the streak up by the full
    micro-batch count every run — once it reaches ``dead_after`` the
    hop lands in :attr:`dead_hops` and the caller escalates to the
    elastic rung instead of retrying forever.
    """

    dead_after: int = 2
    _streaks: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)
    _faults: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def __post_init__(self):
        if self.dead_after < 1:
            raise ValueError(
                f"dead_after must be >= 1, got {self.dead_after}")

    def record(self, stage: int, faulted: bool) -> None:
        """Fold one crossing of the hop leaving ``stage``."""
        if faulted:
            self._streaks[stage] = self._streaks.get(stage, 0) + 1
            self._faults[stage] = self._faults.get(stage, 0) + 1
        else:
            self._streaks[stage] = 0

    def streak(self, stage: int) -> int:
        """Current consecutive-fault streak for the hop leaving
        ``stage`` (0 = healthy or never crossed)."""
        return self._streaks.get(stage, 0)

    def faults(self, stage: int) -> int:
        """Total faulted crossings of the hop since construction."""
        return self._faults.get(stage, 0)

    @property
    def dead_hops(self) -> list:
        """Hops whose streak has reached ``dead_after``, ascending."""
        return sorted(j for j, s in self._streaks.items()
                      if s >= self.dead_after)


@dataclasses.dataclass
class TickWatchdog:
    """Serve-tick health policy (host-side; no device program change).

    ``tick_budget_s`` — a tick slower than this is counted and evented
    (``resilience.watchdog_slow_ticks``); None disables.
    ``stuck_slack_ticks`` — a live slot is declared stuck (and retired
    ``status="error"``) once its age exceeds the ticks its token budget
    can possibly need (``ceil(max_new / decode_chunk)``) plus this
    slack; None disables.
    ``shed_ewma_threshold`` — deadline-miss EWMA (per retirement,
    ``shed_ewma_alpha`` horizon) above which the engine enters degraded
    mode and sheds lowest-priority queued requests; None disables.

    Beyond the thresholds, the watchdog is the engine's health ledger:
    the engine feeds every verdict back through ``record_tick`` /
    ``record_outcome`` / ``record_stuck``, and the read-only properties
    (``miss_ewma``, ``slow_streak``, ``slow_ticks``, ``stuck_slots``,
    ``last_tick_s``) are the public health surface the fleet router's
    state machine consumes — no reaching into engine privates, and the
    signals are all host-side bookkeeping the engine already computed
    (never an extra device sync). One watchdog instance per engine.
    """

    tick_budget_s: Optional[float] = None
    stuck_slack_ticks: Optional[int] = 8
    shed_ewma_threshold: Optional[float] = None
    shed_ewma_alpha: float = 0.1
    _miss_ewma: float = dataclasses.field(default=0.0, init=False,
                                          repr=False, compare=False)
    _slow_streak: int = dataclasses.field(default=0, init=False,
                                          repr=False, compare=False)
    _slow_ticks: int = dataclasses.field(default=0, init=False,
                                         repr=False, compare=False)
    _stuck_slots: int = dataclasses.field(default=0, init=False,
                                          repr=False, compare=False)
    _last_tick_s: float = dataclasses.field(default=0.0, init=False,
                                            repr=False, compare=False)

    def __post_init__(self):
        if self.tick_budget_s is not None and self.tick_budget_s <= 0:
            raise ValueError(
                f"tick_budget_s must be > 0, got {self.tick_budget_s}")
        if self.stuck_slack_ticks is not None and self.stuck_slack_ticks < 1:
            raise ValueError(
                f"stuck_slack_ticks must be >= 1, got "
                f"{self.stuck_slack_ticks}")
        if self.shed_ewma_threshold is not None and \
                not 0.0 < self.shed_ewma_threshold <= 1.0:
            raise ValueError(
                f"shed_ewma_threshold must be in (0, 1], got "
                f"{self.shed_ewma_threshold}")

    def stuck_after(self, max_new_tokens: int, decode_chunk: int) -> \
            Optional[int]:
        """Tick-age ceiling for a slot with this token budget (None when
        stuck detection is disabled)."""
        if self.stuck_slack_ticks is None:
            return None
        need = math.ceil(max_new_tokens / max(decode_chunk, 1))
        return need + self.stuck_slack_ticks

    # -- recording (engine-side feed) ---------------------------------------

    def record_tick(self, duration_s: float) -> bool:
        """Fold one tick's wall clock. Returns True when the tick blew
        ``tick_budget_s`` (always False with the budget disabled);
        consecutive overruns accumulate in ``slow_streak``, a healthy
        tick resets it."""
        self._last_tick_s = float(duration_s)
        over = self.tick_budget_s is not None \
            and duration_s > self.tick_budget_s
        if over:
            self._slow_ticks += 1
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        return over

    def record_outcome(self, missed_deadline: bool) -> float:
        """Fold one served retirement into the deadline-miss EWMA
        (``shed_ewma_alpha`` horizon) and return the new value. Only
        *served* outcomes (ok/timeout) belong here — shed work is the
        response to misses and must not latch degraded mode."""
        miss = 1.0 if missed_deadline else 0.0
        a = self.shed_ewma_alpha
        self._miss_ewma = a * miss + (1.0 - a) * self._miss_ewma
        return self._miss_ewma

    def record_stuck(self) -> None:
        """Count one stuck-slot retirement."""
        self._stuck_slots += 1

    # -- read-only health surface (what the router consumes) ----------------

    @property
    def miss_ewma(self) -> float:
        """Deadline-miss EWMA over served retirements."""
        return self._miss_ewma

    @property
    def slow_streak(self) -> int:
        """Consecutive ticks over ``tick_budget_s`` (0 = on budget)."""
        return self._slow_streak

    @property
    def slow_ticks(self) -> int:
        """Total ticks over budget since construction."""
        return self._slow_ticks

    @property
    def stuck_slots(self) -> int:
        """Total stuck-slot retirements since construction."""
        return self._stuck_slots

    @property
    def last_tick_s(self) -> float:
        """Wall-clock duration of the most recent tick."""
        return self._last_tick_s
