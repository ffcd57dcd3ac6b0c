"""Fault injection, anomaly detection and recovery, on one device and over
a mesh of ranks: counterpart of ``pipe_tpu/resilience``.

* :mod:`.chaos` -- deterministic, seeded, step/tick-indexed fault injection
  (:class:`ChaosPlan`): NaN/inf into grads or activations, loss spikes,
  data-iterator raises, emulator hop faults, serve-tick faults, fleet
  replica and wire faults;
* :mod:`.detect` -- :func:`step_guard`, the fused finiteness + loss-spike
  check of the guarded step (no host sync of its own); :class:`HopHealth`,
  the emulator's per-hop failure streaks; :class:`TickWatchdog`, the serve
  tick's health policy;
* :mod:`.recover` -- skip-step happens inside the guarded step;
  :class:`ResilienceController` adds bounded rewind-to-snapshot with
  exponential backoff, :class:`RetryingIterator` retries the data iterator;
* :mod:`.elastic` -- the top rung: :class:`BuddyStore` replication one hop
  round the stage ring, :class:`ElasticController`'s dead-stage verdict
  from the gradient heartbeat, :func:`replan_after_loss` over the ``n-1``
  survivors and :func:`train_elastic`, which drives the ladder.

With ``TrainerConfig.resilience=None`` and no :class:`ChaosPlan` (the
defaults) the train step is the unguarded step, kernel for kernel; with
``elastic=None`` it is the guarded one.
"""

from .chaos import (KILL_NONE, ChaosError, ChaosPlan, Fault, current_kill,
                    kill_scope, wrap_stage_fn)
from .detect import HopHealth, TickWatchdog, stage_heartbeat, step_guard
from .elastic import (BuddyStore, ElasticConfig, ElasticController,
                      StageLost, replan_after_loss, restack_state,
                      train_elastic)
from .recover import (DataIteratorFailed, ResilienceConfig,
                      ResilienceController, RetryingIterator,
                      TrainingAborted)

__all__ = [
    "ChaosError", "ChaosPlan", "Fault", "KILL_NONE", "current_kill",
    "kill_scope", "wrap_stage_fn", "stage_heartbeat", "step_guard",
    "HopHealth", "TickWatchdog",
    "DataIteratorFailed", "ResilienceConfig", "ResilienceController",
    "RetryingIterator", "TrainingAborted",
    "ElasticConfig", "StageLost", "BuddyStore", "ElasticController",
    "restack_state", "replan_after_loss", "train_elastic",
]
