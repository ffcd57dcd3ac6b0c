"""Fault injection, anomaly detection and recovery on one device:
counterpart of ``pipe_tpu/resilience`` without elastic training.

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
  exponential backoff, :class:`RetryingIterator` retries the data iterator.

With ``TrainerConfig.resilience=None`` and no :class:`ChaosPlan` (the
defaults) the train step is the unguarded step, kernel for kernel. Elastic
training (``resilience/elastic.py``) is not ported yet (ROADMAP.md A.8).
"""

from .chaos import (KILL_NONE, ChaosError, ChaosPlan, Fault, current_kill,
                    kill_scope, wrap_stage_fn)
from .detect import HopHealth, TickWatchdog, stage_heartbeat, step_guard
from .recover import (DataIteratorFailed, ResilienceConfig,
                      ResilienceController, RetryingIterator,
                      TrainingAborted)

__all__ = [
    "ChaosError", "ChaosPlan", "Fault", "KILL_NONE", "current_kill",
    "kill_scope", "wrap_stage_fn", "stage_heartbeat", "step_guard",
    "HopHealth", "TickWatchdog",
    "DataIteratorFailed", "ResilienceConfig", "ResilienceController",
    "RetryingIterator", "TrainingAborted",
]
