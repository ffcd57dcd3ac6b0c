"""Fault injection, anomaly detection and recovery for training on one
device: counterpart of the train half of ``pipe_tpu/resilience``.

* :mod:`.chaos` -- deterministic, seeded, step-indexed fault injection
  (:class:`ChaosPlan`): NaN/inf into grads or activations, loss spikes,
  data-iterator raises;
* :mod:`.detect` -- :func:`step_guard`, the fused finiteness + loss-spike
  check of the guarded step (no host sync of its own);
* :mod:`.recover` -- skip-step happens inside the guarded step;
  :class:`ResilienceController` adds bounded rewind-to-snapshot with
  exponential backoff, :class:`RetryingIterator` retries the data iterator.

With ``TrainerConfig.resilience=None`` and no :class:`ChaosPlan` (the
defaults) the train step is the unguarded step, kernel for kernel. The serve
watchdog, the emulator's hop health and elastic training
(``resilience/elastic.py``) are not ported yet (ROADMAP.md A.7, A.8).
"""

from .chaos import (KILL_NONE, ChaosError, ChaosPlan, Fault, current_kill,
                    kill_scope, wrap_stage_fn)
from .detect import stage_heartbeat, step_guard
from .recover import (DataIteratorFailed, ResilienceConfig,
                      ResilienceController, RetryingIterator,
                      TrainingAborted)

__all__ = [
    "ChaosError", "ChaosPlan", "Fault", "KILL_NONE", "current_kill",
    "kill_scope", "wrap_stage_fn", "stage_heartbeat", "step_guard",
    "DataIteratorFailed", "ResilienceConfig", "ResilienceController",
    "RetryingIterator", "TrainingAborted",
]
