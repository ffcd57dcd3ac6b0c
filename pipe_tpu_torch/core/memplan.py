"""Shared memory-plan arithmetic: slot counts → estimated bytes.

Counterpart of ``pipe_tpu/core/memplan.py``, copied (it imports only the
standard library). In the port its consumer is the table executor's
``memory_plan``; the planner is not ported yet.

One formula, two consumers. The scheduled executor's ``memory_plan``
(``parallel/scheduled.py``) reports its static per-device buffer counts,
and the auto-planner (``core/planner.py``) must PREDICT peak memory for
candidate configs it has not built yet — if each derived the slot
arithmetic independently the two would drift, and the planner's memory
cap would gate on a formula the executor no longer implements. So the
checkpoint-mode → slot-count mapping lives here:

* ``stash``: the schedule's live stashed-input window, per virtual stage
  (``Schedule.stash_slots``), times the interleave depth ``v``;
* ``residual``: stored-backward residuals — all ``v * stash`` under
  ``checkpoint='never'``, one per virtual stage under ``'except_last'``
  (only the in-flight micro-batch's), none under ``'always'``;
* ``policy residual``: the remat-policy-saved subset parked by RECOMPUTE
  micro-batches (same FIFO lifetime as the stash), present only when a
  policy is installed under a recompute mode;
* ``wstash``: deferred-W cotangent parks of split-backward tables —
  live only under ``checkpoint='never'`` (recompute modes run the fused
  backward at B and the W slots park nothing);
* ``taps``: the structural-split tap store (``split_stage``), one slot
  per stash window per virtual stage;
* ``grad park``: overlapped transport's one-cycle cotangent park.

:func:`estimate_memory` then prices the slots: activation-sized windows
at ``act_bytes``, residual windows at ``residual_bytes``, plus the
static ``param_bytes`` replicated across weights, grads, and optimizer
moments. It is an ESTIMATE — XLA fusion slack and transport double
buffers are not modeled — but it is monotone in the knobs the planner
searches (m, schedule, v, checkpoint), which is what a pruning cap
needs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

__all__ = ["MemoryPlanInputs", "activation_slot_plan", "estimate_memory"]

_CHECKPOINT_MODES = ("always", "except_last", "never")


@dataclasses.dataclass(frozen=True)
class MemoryPlanInputs:
    """Per-virtual-stage slot counts plus the mode switches that gate
    them. ``stash_slots``/``wstash_slots`` are the schedule's RAW
    per-virtual-stage windows (``Schedule.stash_slots``/``wstash_slots``
    or their comm-shifted widenings) — the checkpoint gating happens in
    :func:`activation_slot_plan`, not in the caller."""

    v: int
    stash_slots: int
    wstash_slots: int = 0
    checkpoint: str = "except_last"
    has_remat_policy: bool = False
    split_stage: bool = False
    overlap: bool = False
    grad_park_slots: int = 0    # per virtual stage, overlapped transport

    def __post_init__(self):
        if self.checkpoint not in _CHECKPOINT_MODES:
            raise ValueError(
                f"checkpoint must be one of {_CHECKPOINT_MODES}, "
                f"got {self.checkpoint!r}")
        if self.v < 1:
            raise ValueError(f"v must be >= 1, got {self.v}")


def activation_slot_plan(inputs: MemoryPlanInputs) -> dict:
    """The executor's static per-device buffer counts for one config —
    the exact dict ``ScheduledPipeline.memory_plan`` reports (minus the
    executor-only ``cycles``/``transport``/phase/skip keys)."""
    v, Sg = inputs.v, inputs.stash_slots
    Wg = inputs.wstash_slots if inputs.checkpoint == "never" else 0
    R = {"always": 0, "except_last": v, "never": v * Sg}[inputs.checkpoint]
    # Policy-shaped residual slots (dynamic path): recompute micro-batches
    # park their policy-saved subset here, one FIFO slot per (virtual
    # stage, stash window) — same lifetime as the stash.
    Rp = (v * Sg if inputs.has_remat_policy
          and inputs.checkpoint != "never" else 0)
    plan = {"stash_slots": v * Sg,
            "stash_slots_per_virtual_stage": Sg,
            "residual_slots": R,
            "policy_residual_slots": Rp,
            "h_last_slots": Sg,
            "wstash_slots": v * Wg,
            "taps_slots": v * Sg if inputs.split_stage else 0,
            "virtual_stages_per_device": v}
    if inputs.overlap:
        plan["grad_park_slots"] = v * inputs.grad_park_slots
    return plan


def estimate_memory(plan_inputs: Union[MemoryPlanInputs, dict], *,
                    act_bytes: int,
                    residual_bytes: Optional[int] = None,
                    param_bytes: int = 0,
                    opt_moments: int = 2) -> int:
    """Estimated peak per-device bytes of one pipeline config.

    ``plan_inputs`` is either :class:`MemoryPlanInputs` or an
    already-computed slot-plan dict (``activation_slot_plan`` /
    ``ScheduledPipeline.memory_plan`` output — both spell the keys the
    same way, by construction). ``act_bytes`` prices one micro-batch
    boundary activation; ``residual_bytes`` one stored-backward residual
    tree (defaults to ``act_bytes`` — exact for matmul-chain stages whose
    residual is dominated by the stashed input); ``param_bytes`` the
    device's weight shard, counted once for weights, once for grads, and
    ``opt_moments`` more times for the optimizer (2 = Adam)."""
    plan = (activation_slot_plan(plan_inputs)
            if isinstance(plan_inputs, MemoryPlanInputs) else plan_inputs)
    if residual_bytes is None:
        residual_bytes = act_bytes
    act_slots = (plan["stash_slots"] + plan["h_last_slots"]
                 + plan["wstash_slots"] + plan["taps_slots"]
                 + plan.get("grad_park_slots", 0))
    res_slots = plan["residual_slots"] + plan["policy_residual_slots"]
    return int(act_slots * act_bytes + res_slots * residual_bytes
               + (2 + opt_moments) * param_bytes)
