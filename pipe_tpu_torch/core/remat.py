"""Activation-checkpoint (rematerialization) policy.

Counterpart of the checkpoint modes of ``pipe_tpu/core/remat.py``:
``always`` / ``except_last`` / ``never`` remat micro-batches ``[0, m)`` /
``[0, m-1)`` / ``[]``, computed against the number of micro-batches that
``scatter`` actually produced. Eval mode turns checkpointing off. A stage body
is wrapped in ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
dropout replays identically because its seed is an argument of the body. The
split-backward machinery of ``pipe_tpu`` is not ported yet.

**Selective remat** (``remat_policy``): :data:`checkpoint_policies` names the
``jax.checkpoint_policies`` members the port has, each a selective-checkpoint
policy over aten ops (``torch.utils.checkpoint.create_selective_checkpoint_contexts``):
``dots_saveable`` saves the outputs of ``mm``, ``addmm``, ``bmm`` and
``baddbmm`` (JAX's ``dot_general``); ``dots_with_no_batch_dims_saveable``
those of ``mm`` and ``addmm`` only; ``nothing_saveable`` and
``everything_saveable`` save nothing and everything. The backward of a
checkpointed body still re-runs its forward, but a saved op hands back its
stored output instead of computing it again. The flash-attention kernels are
ctypes calls inside an ``autograd.Function``, not aten ops, so no policy can
save their outputs: they are recomputed at the backward under every policy,
as ``pipe_tpu``'s ``dots_saveable`` recomputes the Pallas calls, and a
recompute micro-batch launches the forward kernel as often as without a
policy.
"""

from __future__ import annotations

import contextlib
import functools
import types
from typing import Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["CHECKPOINT_MODES", "validate_mode", "checkpoint_stop",
           "apply_remat", "checkpoint_policies", "resolve_policy",
           "count_dots"]

CHECKPOINT_MODES = ("always", "except_last", "never")

_aten = torch.ops.aten
# The aten ops of a matrix product: with a batch dimension, and without.
_BATCHED_DOTS = frozenset({_aten.bmm.default, _aten.baddbmm.default})
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default}) | _BATCHED_DOTS


class RematPolicy:
    """A named selective-checkpoint policy: ``MUST_SAVE`` for the ops it
    saves, ``PREFER_RECOMPUTE`` for the rest. Called as
    ``policy(ctx, op, *args, **kwargs)`` by ``torch.utils.checkpoint``."""

    def __init__(self, name: str, saves: Callable[[object], bool]):
        self.name = name
        self._saves = saves

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        return (CheckpointPolicy.MUST_SAVE if self._saves(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def __repr__(self) -> str:
        return f"checkpoint_policies.{self.name}"


checkpoint_policies = types.SimpleNamespace(
    dots_saveable=RematPolicy("dots_saveable", lambda op: op in _DOTS),
    dots_with_no_batch_dims_saveable=RematPolicy(
        "dots_with_no_batch_dims_saveable",
        lambda op: op in _DOTS and op not in _BATCHED_DOTS),
    nothing_saveable=RematPolicy("nothing_saveable", lambda op: False),
    everything_saveable=RematPolicy("everything_saveable", lambda op: True),
)


def resolve_policy(policy) -> Optional[RematPolicy]:
    """``policy`` as a :class:`RematPolicy`: one of :data:`checkpoint_policies`
    or its name; None stays None. Anything else raises ``ValueError``."""
    if policy is None or isinstance(policy, RematPolicy):
        return policy
    names = sorted(vars(checkpoint_policies))
    if isinstance(policy, str) and policy in names:
        return getattr(checkpoint_policies, policy)
    raise ValueError(f"remat_policy must be one of {' | '.join(names)} "
                     f"(or pipe_tpu_torch.core.remat.checkpoint_policies."
                     f"<name>), got {policy!r}")


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


def apply_remat(fn: Callable, *, enabled: bool, policy=None) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` when enabled: its activations
    are dropped after the forward and recomputed in the backward, all of
    them, or under ``policy`` (a :data:`checkpoint_policies` member or its
    name) all but what the policy saves."""
    policy = resolve_policy(policy)
    if not enabled:
        return fn
    if policy is None:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


class _DotCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in _DOTS
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def count_dots() -> Iterator[_DotCounter]:
    """Count the matrix products (the ops ``dots_saveable`` saves) dispatched
    inside the block, backward passes it runs included: ``.count``."""
    counter = _DotCounter()
    with counter:
        yield counter
