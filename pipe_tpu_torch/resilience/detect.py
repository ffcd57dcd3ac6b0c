"""Anomaly detection for the train step.

Counterpart of the train half of ``pipe_tpu/resilience/detect.py``:
:func:`step_guard` runs inside the guarded train step, a finiteness test of
the loss and the global gradient norm fused with a loss-spike test against
an EWMA kept on the device. It reads nothing back to the host: the verdict
is a 0-dim device tensor the step uses to select the pre-step state back in
(``train/loop.py``), and the host reads the aux carry on its own cadence
(``ResilienceConfig.check_every``). :func:`stage_heartbeat` is the per-stage
gradient power of elastic training. ``HopHealth`` and ``TickWatchdog`` (the
emulator's hops and the serve tick) are not ported yet (ROADMAP.md A.7).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

__all__ = ["step_guard", "stage_heartbeat", "global_norm"]


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
