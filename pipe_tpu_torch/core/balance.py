"""Automatic stage balancing: profile layers, split stages by cost.

Counterpart of ``pipe_tpu/core/balance.py`` (torchgpipe's ``balance_by_time``
and ``balance_by_size``, which the reference's error text points users at):

* :func:`profile_times` -- per-layer forward (or forward+backward) time,
  each layer run alone on inputs of the shapes it sees in the pipeline:
  median of ``repeat`` runs after ``warmup`` discarded ones, timed with CUDA
  events around a synchronized call on a card and with ``perf_counter`` on
  the CPU;
* :func:`profile_sizes` -- per-layer parameter + output bytes;
* :func:`balance_by_time` / :func:`balance_by_size` -- those costs into the
  contiguous bottleneck solver :func:`_bottleneck_split` (binary search +
  greedy feasibility, optimal for the max-stage objective);
* :func:`stage_costs` / :func:`balance_cost` -- the per-stage cost vector of a
  balance and its max (the planner's inputs), and
  :func:`rebalance_stage_loss`, the re-cut over one fewer stage that
  ``core/schedule.py``'s ``replan_stage_loss`` uses.

The weights live in the modules, so the profilers take ``(module, sample)``
where ``pipe_tpu``'s take ``(module, params, sample)``.
"""

from __future__ import annotations

import statistics
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .partition import BalanceError, StageCtx

__all__ = ["profile_times", "profile_sizes", "balance_by_time",
           "balance_by_size", "balance_cost", "stage_costs",
           "rebalance_stage_loss"]


def _as_tuple(x) -> Tuple:
    return x if isinstance(x, tuple) else (x,)


def _layer_io(module, sample) -> List[Tuple[Tuple, Tuple]]:
    """(inputs, outputs) of each layer, chained from ``sample`` through an
    eval forward without a graph."""
    out, cur = [], _as_tuple(sample)
    with torch.no_grad():
        for layer in module:
            res = _as_tuple(layer(*cur, ctx=StageCtx()))
            out.append((cur, res))
            cur = res
    return out


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor)))


def _time_once(fn, device: torch.device) -> float:
    """Seconds of one synchronized call of ``fn`` (CUDA events on the
    card, the host clock elsewhere)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _timed(fn, device: torch.device, repeat: int, warmup: int) -> float:
    """Median seconds of ``repeat`` synchronized calls of ``fn`` after one
    untimed call and ``warmup`` discarded timed ones."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    samples = [_time_once(fn, device) for _ in range(warmup + repeat)]
    return statistics.median(samples[warmup:])


def profile_times(module, sample, *, backward: bool = True, repeat: int = 3,
                  warmup: int = 1, seed: int = 0) -> List[float]:
    """Measured per-layer step time in seconds.

    Each layer is timed alone, in eval mode, on inputs of the shapes and
    dtypes it sees in the pipeline: floating inputs drawn from a normal
    distribution (a generator seeded ``seed + i`` for layer ``i``), integer
    inputs zeros. With ``backward`` a layer that has parameters is timed
    forward and backward (the parameter gradients of the sum of squares of
    its output, as ``pipe_tpu`` differentiates); a layer without, forward
    only. The first call and ``warmup`` timed calls are discarded (allocator
    warm-up); the figure is the median of the remaining ``repeat``, which a
    one-sided outlier (a GC pause) does not move.
    """
    times: List[float] = []
    for i, (layer, (inputs, _)) in enumerate(zip(module,
                                                  _layer_io(module, sample))):
        gen = torch.Generator(device=inputs[0].device).manual_seed(seed + i)
        xs = tuple(torch.randn(x.shape, generator=gen, device=x.device,
                               dtype=x.dtype) if x.is_floating_point()
                   else torch.zeros_like(x) for x in inputs)
        params = [p for p in layer.parameters() if p.requires_grad]

        if backward and params:
            def fn(_layer=layer, _xs=xs, _params=params):
                out = _as_tuple(_layer(*_xs, ctx=StageCtx()))[0]
                return torch.autograd.grad(out.float().square().sum(),
                                           _params)
        else:
            def fn(_layer=layer, _xs=xs):
                with torch.no_grad():
                    return _layer(*_xs, ctx=StageCtx())
        times.append(_timed(fn, xs[0].device, repeat, warmup))
    return times


def profile_sizes(module, sample) -> List[int]:
    """Per-layer bytes: parameters + output activation (balance_by_size)."""
    return [_nbytes(layer.parameters()) + _nbytes(outputs)
            for layer, (_, outputs) in zip(module, _layer_io(module, sample))]


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


def balance_by_time(n_stages: int, module, sample, **profile_kw) -> List[int]:
    """Stage balance from measured per-layer times (torchgpipe parity API)."""
    return _bottleneck_split(profile_times(module, sample, **profile_kw),
                             n_stages)


def balance_by_size(n_stages: int, module, sample) -> List[int]:
    """Stage balance from parameter+activation bytes (torchgpipe parity
    API)."""
    return _bottleneck_split(profile_sizes(module, sample), n_stages)


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


def stage_costs(balance: Sequence[int], costs: Sequence[float]
                ) -> List[float]:
    """Per-stage cost vector of a balance: ``out[j]`` sums the layer costs
    assigned to stage ``j``. The planner prices each stage's ops by it;
    :func:`balance_cost` is its max."""
    if sum(int(w) for w in balance) != len(costs):
        raise BalanceError(
            f"balance sums to {sum(int(w) for w in balance)} layers but "
            f"costs cover {len(costs)}")
    out, off = [], 0
    for w in balance:
        out.append(float(sum(costs[off:off + w])))
        off += w
    return out


def balance_cost(balance: Sequence[int], costs: Sequence[float],
                 *, per_stage: bool = False):
    """Bottleneck (max stage) cost of a balance -- lower is better.
    ``per_stage=True`` returns the per-stage vector (:func:`stage_costs`)."""
    vec = stage_costs(balance, costs)
    return vec if per_stage else max(vec)
