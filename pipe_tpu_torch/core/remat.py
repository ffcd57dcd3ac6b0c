"""Activation-checkpoint (rematerialization) policy.

Counterpart of the checkpoint modes of ``pipe_tpu/core/remat.py``:
``always`` / ``except_last`` / ``never`` remat micro-batches ``[0, m)`` /
``[0, m-1)`` / ``[]``, computed against the number of micro-batches that
``scatter`` actually produced. Eval mode turns checkpointing off. A stage body
is wrapped in ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
dropout replays identically because its seed is an argument of the body. The
split-backward machinery of ``pipe_tpu`` is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Callable

from torch.utils.checkpoint import checkpoint

__all__ = ["CHECKPOINT_MODES", "validate_mode", "checkpoint_stop", "apply_remat"]

CHECKPOINT_MODES = ("always", "except_last", "never")


def validate_mode(checkpoint: str) -> str:
    if checkpoint not in CHECKPOINT_MODES:
        raise ValueError(
            f"checkpoint is not one of {' | '.join(CHECKPOINT_MODES)!r}: "
            f"{checkpoint!r}")
    return checkpoint


def checkpoint_stop(checkpoint: str, num_microbatches: int, train: bool) -> int:
    """First micro-batch index NOT rematerialized (0 in eval mode)."""
    validate_mode(checkpoint)
    if not train:
        return 0
    m = num_microbatches
    return {"always": m, "except_last": max(m - 1, 0), "never": 0}[checkpoint]


def apply_remat(fn: Callable, *, enabled: bool) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` when enabled: its activations
    are dropped after the forward and recomputed in the backward."""
    if not enabled:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)
