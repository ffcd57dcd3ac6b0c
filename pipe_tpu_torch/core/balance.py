"""Layer re-balancing over one fewer stage (plain Python).

Counterpart of the stage-loss part of ``pipe_tpu/core/balance.py``
(``_bottleneck_split`` and ``rebalance_stage_loss``, copied), which
``core/schedule.py``'s ``replan_stage_loss`` re-cuts a balance with. The
profiling balancers of ``pipe_tpu`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .partition import BalanceError

__all__ = ["rebalance_stage_loss"]


def _bottleneck_split(costs: Sequence[float], n_stages: int) -> List[int]:
    """Contiguous split minimizing the max per-stage cost (binary search)."""
    costs = list(costs)
    if n_stages > len(costs):
        raise BalanceError(
            f"cannot split {len(costs)} layers into {n_stages} stages")

    def feasible(cap: float) -> Optional[List[int]]:
        out, acc, taken = [], 0.0, 0
        for c in costs:
            if c > cap:
                return None
            if acc + c > cap:
                out.append(taken)
                acc, taken = 0.0, 0
            acc += c
            taken += 1
        out.append(taken)
        if len(out) > n_stages:
            return None
        # pad by stealing single layers off the largest groups
        while len(out) < n_stages:
            j = max(range(len(out)), key=lambda k: out[k])
            if out[j] < 2:
                return None
            out[j] -= 1
            out.insert(j + 1, 1)
        return out

    lo, hi = max(costs), sum(costs)
    best = feasible(hi)
    for _ in range(60):
        mid = (lo + hi) / 2
        f = feasible(mid)
        if f is not None:
            best, hi = f, mid
        else:
            lo = mid
    if best is None:
        raise BalanceError("no feasible balanced split")
    return best


def rebalance_stage_loss(balance: Sequence[int],
                         costs: Optional[Sequence[float]] = None
                         ) -> List[int]:
    """Re-cut an existing stage balance over one fewer stage: the same
    contiguous bottleneck solver fed the per-layer ``costs`` (uniform unit
    costs when none are known). Raises :class:`BalanceError` when the
    original balance has fewer than two stages."""
    n = len(balance)
    if n < 2:
        raise BalanceError(
            f"cannot rebalance a {n}-stage pipeline over stage loss")
    total = sum(int(w) for w in balance)
    if costs is None:
        costs = [1.0] * total
    elif len(costs) != total:
        raise BalanceError(
            f"costs cover {len(costs)} layers but balance sums to {total}")
    return _bottleneck_split(costs, n - 1)
