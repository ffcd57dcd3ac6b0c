"""Stage partitioning and fail-fast validation.

Counterpart of ``pipe_tpu/core/partition.py``. Stage placement is explicit: a
stage count plus an optional ``balance`` list (the ceil-split default mirrors
the tutorial's split). The per-invocation context carries an optional integer
seed instead of a JAX key; :meth:`StageCtx.fold` derives new seeds from it
deterministically, so a recomputed forward replays the same dropout.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, List, Optional, Sequence, Tuple

from torch import nn

__all__ = [
    "BalanceError",
    "StageCtx",
    "Stage",
    "verify_stages",
    "verify_splitting",
    "split_balance",
    "fold_seed",
]

_MASK64 = (1 << 64) - 1


class BalanceError(ValueError):
    """Raised when layers cannot be split into the requested stages."""


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 mixing).

    Deterministic and order-sensitive, like ``jax.random.fold_in``; the bits
    differ from JAX's, which no test relies on."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class StageCtx:
    """Per-invocation context threaded to stage bodies.

    ``seed`` (an optional integer) seeds dropout: the same seed is passed
    again to a recomputed forward, so its masks are the same. ``microbatch``
    and ``stage`` name the task (profiler ranges ``chunk{i}-stage{j}``).

    On a mesh (``parallel/mesh.py``) with more than one data rank,
    ``data_axis`` is the :class:`~pipe_tpu_torch.parallel.mesh.Mesh`, whose
    ``psum`` sums over the data group (batch statistics), and ``rows`` is
    ``(offset, total)``: this rank's rows are rows ``offset ..`` of the
    whole micro-batch of ``total`` rows. Dropout draws its mask for the whole
    micro-batch and keeps this rank's rows, so a data-sharded step drops
    what the one-device step drops (ROADMAP.md C.16).
    """

    seed: Optional[int] = None
    train: bool = False
    microbatch: int = 0
    stage: int = 0
    data_axis: Any = None
    rows: Optional[Tuple[int, int]] = None

    def fold(self, *data: int) -> "StageCtx":
        """Derive a ctx whose seed is folded over the given integers."""
        if self.seed is None:
            return self
        seed = self.seed
        for d in data:
            seed = fold_seed(seed, d)
        return dataclasses.replace(self, seed=seed)


def _accepts_ctx(fn: Callable) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_KEYWORD or p.name == "ctx":
            return True
    return False


@dataclasses.dataclass
class Stage:
    """One pipeline stage: a callable (usually a partition ``Sequential``)
    mapping the micro-batch payload to the stage output. Callables without a
    ``ctx`` parameter are adapted automatically; weights live in the module.
    """

    fn: Callable
    name: str = "stage"

    def __post_init__(self):
        self._takes_ctx = _accepts_ctx(self.fn)

    def __call__(self, *inputs, ctx: Optional[StageCtx] = None):
        if self._takes_ctx:
            return self.fn(*inputs, ctx=ctx or StageCtx())
        return self.fn(*inputs)


def verify_stages(stages: Sequence[Any]) -> None:
    """No duplicate stage objects."""
    if len(stages) == 0:
        raise ValueError("pipeline needs at least one stage")
    seen = set()
    for s in stages:
        if id(s) in seen:
            raise ValueError("module with duplicate stages is not supported")
        seen.add(id(s))


def verify_splitting(partitions: Sequence[nn.Module]) -> None:
    """No ``nn.Parameter`` object belongs to two partitions: one weight in two
    stages would count its gradient twice."""
    seen: dict = {}
    for j, part in enumerate(partitions):
        for param in part.parameters():
            key = id(param)
            if key in seen and seen[key] != j:
                raise ValueError(
                    "module with duplicate parameters on distinct stages is "
                    "not supported")
            seen[key] = j


def split_balance(n_layers: int, n_stages: int,
                  balance: Optional[Sequence[int]] = None,
                  costs: Optional[Sequence[float]] = None) -> List[int]:
    """Layers per stage. Uniform ceil-split by default; ``balance`` pins the
    split; ``costs`` makes a greedy contiguous split of equal cost."""
    if n_stages <= 0:
        raise BalanceError("number of stages must be positive")
    if balance is not None:
        balance = list(balance)
        if len(balance) != n_stages:
            raise BalanceError(
                f"balance length {len(balance)} != number of stages {n_stages}")
        if sum(balance) != n_layers:
            raise BalanceError(
                f"balance {balance} does not sum to the layer count {n_layers}")
        if any(b <= 0 for b in balance):
            raise BalanceError("all balance entries must be positive")
        return balance
    if n_stages > n_layers:
        raise BalanceError(
            f"cannot split {n_layers} layers into {n_stages} stages")
    if costs is not None:
        if len(costs) != n_layers:
            raise BalanceError("costs length must equal layer count")
        total = float(sum(costs))
        out, acc, taken = [], 0.0, 0
        remaining_stages = n_stages
        for i, c in enumerate(costs):
            acc += c
            taken += 1
            remaining_layers = n_layers - i - 1
            if (acc >= total / n_stages and remaining_stages > 1
                    and remaining_layers >= remaining_stages - 1):
                out.append(taken)
                total -= acc
                remaining_stages = n_stages - len(out)
                acc, taken = 0.0, 0
        out.append(taken)
        while len(out) < n_stages:
            out.append(0)
        if any(b <= 0 for b in out):
            raise BalanceError("cost-based split produced an empty stage")
        return out
    # First (n_layers % n_stages) stages take one extra layer.
    base, rem = divmod(n_layers, n_stages)
    return [base + 1 if j < rem else base for j in range(n_stages)]
