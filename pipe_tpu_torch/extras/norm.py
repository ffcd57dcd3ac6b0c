"""Deferred BatchNorm: micro-batching-safe batch normalization.

Counterpart of ``pipe_tpu/extras/norm.py``. Splitting a mini-batch into
``chunks`` micro-batches would update BN running statistics ``chunks`` times
with momentum each time: other numbers than the unpipelined model's.
``DeferredBatchNorm`` accumulates per-micro-batch partial sums across the
whole mini-batch and commits ONE running-stats update per mini-batch.

The sums ride the tracker's accumulator channel (crossing checkpoint
boundaries as explicit task outputs, ``parallel/emulator.py``); ``Pipe``
commits them in place on the layers' ``mean``/``var`` buffers under
``torch.no_grad()``, which is the reference's own torch idiom (``pipe_tpu``
returns new params instead, its layers being pure).

Normalization in training uses the micro-batch's biased variance (as
``jnp.var``); the commit folds in the unbiased whole-mini-batch variance (as
torch's ``BatchNorm``). On a mesh of several data ranks
(``StageCtx.data_axis``) a micro-batch's statistics are summed over the data
group with a differentiable all-reduce (``Mesh.psum``), so each rank
normalizes by the whole micro-batch's statistics and the backward sees
them, as ``pipe_tpu``'s ``psum`` over ``DATA_AXIS`` does; the deferred sums
are summed over the data group by the executor before the commit.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ..core.partition import StageCtx
from ..ops.layers import Sequential
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .skip.namespace import Namespace
from .skip.tracker import accumulate

__all__ = ["BatchNorm", "DeferredBatchNorm", "convert_deferred_batch_norm",
           "commit_batchnorm_stats"]

_STATS = "deferred_stats"


class BatchNorm(nn.Module):
    """Plain batch norm over all axes but the last (feature) axis.

    Train mode (``ctx.train``) normalizes by the micro-batch's own
    statistics: exactly the behavior that makes naive micro-batching unsafe.
    ``scale``/``bias`` are parameters, the running ``mean``/``var`` buffers;
    eval mode uses the running stats.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, *, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, dtype=dtype,
                                             device=dev))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype,
                                             device=dev))
        self.register_buffer("mean", torch.zeros(features, dtype=dtype,
                                                 device=dev))
        self.register_buffer("var", torch.ones(features, dtype=dtype,
                                               device=dev))

    def _normalize(self, x, mean, var):
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias

    def _batch_stats(self, x, ctx: StageCtx):
        """Micro-batch (mean, biased var) over every axis but the last:
        over the whole micro-batch across the data group when ``ctx``
        carries one (the centered two-pass variance, as ``pipe_tpu``)."""
        axes = tuple(range(x.dim() - 1))
        mesh = ctx.data_axis
        if mesh is None:
            return x.mean(dim=axes), x.var(dim=axes, unbiased=False)
        n = 1
        for a in axes:
            n *= x.shape[a]
        n_tot = n * mesh.n_data
        mean = mesh.psum(x.sum(dim=axes)) / n_tot
        var = mesh.psum((x - mean).square().sum(dim=axes)) / n_tot
        return mean, var

    def forward(self, x, ctx: StageCtx = StageCtx()):
        if not ctx.train:
            return self._normalize(x, self.mean, self.var)
        return self._normalize(x, *self._batch_stats(x, ctx))


class DeferredBatchNorm(BatchNorm):
    """BatchNorm whose running-stat update is deferred to once per
    mini-batch.

    Each train-mode call normalizes by its micro-batch statistics and
    accumulates ``(sum, sum_sq, count)``; :meth:`commit` folds the
    accumulated whole-mini-batch statistics into ``mean``/``var`` with one
    momentum step, with torch's unbiased-variance update.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, *, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__(features, momentum, eps, dtype=dtype, device=device)
        self.ns = Namespace()  # instance identity for the accumulator channel

    def forward(self, x, ctx: StageCtx = StageCtx()):
        if not ctx.train:
            return self._normalize(x, self.mean, self.var)
        axes = tuple(range(x.dim() - 1))
        n = 1
        for a in axes:
            n *= x.shape[a]
        accumulate(self.ns, _STATS, {
            "sum": x.sum(dim=axes),
            "sum_sq": x.square().sum(dim=axes),
            "count": torch.tensor(float(n), dtype=torch.float32,
                                  device=x.device),
        })
        return self._normalize(x, *self._batch_stats(x, ctx))

    @torch.no_grad()
    def commit(self, stats: Dict[str, torch.Tensor]) -> None:
        """One momentum update of the running stats, in place, from
        accumulated whole-mini-batch sums."""
        n = stats["count"]
        mean = stats["sum"] / n
        var = stats["sum_sq"] / n - mean.square()
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        m = self.momentum
        self.mean.copy_((1 - m) * self.mean + m * mean.to(self.mean.dtype))
        self.var.copy_((1 - m) * self.var + m * unbiased.to(self.var.dtype))


def convert_deferred_batch_norm(module: Sequential, chunks: int) -> Sequential:
    """Replace every plain :class:`BatchNorm` of ``module`` with a
    :class:`DeferredBatchNorm` that shares its parameters and buffers (as
    the reference's converter does). ``chunks`` is there for signature
    parity: the tracker-based accumulator needs no per-chunk state."""
    del chunks
    layers = []
    for layer in module:
        if isinstance(layer, BatchNorm) and not isinstance(layer,
                                                           DeferredBatchNorm):
            d = DeferredBatchNorm(layer.features, layer.momentum, layer.eps,
                                  dtype=layer.scale.dtype,
                                  device=layer.scale.device)
            d.scale, d.bias = layer.scale, layer.bias
            d.mean, d.var = layer.mean, layer.var
            layers.append(d)
        else:
            layers.append(layer)
    return Sequential(layers)


def commit_batchnorm_stats(partitions: Sequence[Sequential],
                           stats: Dict[Any, Any]) -> None:
    """Commit every :class:`DeferredBatchNorm` of ``partitions`` in place.

    ``stats`` maps ``(ns, "deferred_stats")`` to the sums collected while
    the schedule ran (a tracker's ``accum``, or a table executor's stats);
    layers without accumulated stats keep their running stats."""
    for part in partitions:
        for layer in part:
            if isinstance(layer, DeferredBatchNorm):
                st = stats.get((layer.ns, _STATS))
                if st is not None:
                    layer.commit(st)
