"""GPipe over the ranks of a mesh: the wavefront forward and its training step.

Counterpart of ``pipe_tpu/parallel/spmd.py``'s ``SpmdPipeline``, the JAX
trainer's gpipe path and every schedule's eval executor
(``pipe_tpu/train/loop.py``). JAX compiles one ``lax.scan`` over clock
cycles and differentiates it; torch's autograd does not cross processes, so
here the forward is the FWD rows of the gpipe table walked over the ranks
(``parallel/scheduled.py``: micro-batch ``i`` at stage ``j`` in cycle
``i + j``, boundaries sent each cycle) and training is the same table's walk
with its reverse wavefront. The checkpoint policy is the exact
per-micro-batch one of the table walk: JAX's static ``except_last`` (it
remats every micro-batch, ``spmd.py:19-26``) computes the same numbers and
is not kept. :func:`stack_stage_params` and :func:`unstack_stage_params`
are JAX's stage-stacked layout, for carrying weights between the packages
(``convert.py``).

``context_axis="context"`` (over ``make_mesh(..., n_context=)``) shards dim
``context_dim`` of the input leaves over the context line
(``ScheduledPipeline``'s context parallelism); the post must then return a
context-invariant value, such as ``ContextParallelLM.loss_post_fn``'s loss
averaged over the line. ``debug_context_check`` checks that at run time:
an output that differs across the line by more than 1e-5 is poisoned with
NaN and one line is printed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ..core.packing import tree_map
from ..core.partition import StageCtx
from ..utils.platform import DEFAULT_DEVICE
from .scheduled import ScheduledPipeline, _index

__all__ = ["SpmdPipeline", "stack_stage_params", "unstack_stage_params"]


def stack_stage_params(params_per_stage):
    """Per-stage trees of one structure, stacked on a leading stage axis
    (numpy)."""
    return tree_map(lambda *leaves: np.stack([np.asarray(l) for l in leaves]),
                    *params_per_stage)


def unstack_stage_params(stacked, n_stages: int):
    """Inverse of :func:`stack_stage_params`: a per-stage list."""
    return [tree_map(lambda a: np.asarray(a)[i], stacked)
            for i in range(n_stages)]


@dataclasses.dataclass
class SpmdPipeline:
    """GPipe over ``n_stages`` stages (``mesh=``: one stage rank each), the
    contract of ``pipe_tpu``'s: ``stage_fn(s, h, ctx)``, ``pre_fn(x_mb,
    ctx)`` on stage 0, ``post_fn`` on the last stage (``post_fn(h, x_mb,
    ctx)`` with ``post_with_batch``, else ``post_fn(h, ctx)``); ``module``
    holds the weights (this rank's, on a mesh). Calling it is the forward:
    the post's outputs of every micro-batch, ``[m, rows, ...]``, the whole
    batch's on every rank. :meth:`loss_and_grad` is the training step."""

    stage_fn: Callable
    pre_fn: Callable
    post_fn: Callable
    n_stages: int
    module: nn.Module
    checkpoint: str = "never"
    post_with_batch: bool = False
    mesh: Optional[Any] = None
    device: Any = DEFAULT_DEVICE
    schedule: Any = dataclasses.field(default="gpipe", init=False)
    context_axis: Optional[str] = None
    context_dim: int = 2
    debug_context_check: bool = False

    def __post_init__(self):
        if self.context_axis and self.post_fn is None:
            raise ValueError(
                "context_axis requires a post_fn whose output is context-"
                "invariant (e.g. a pmean'd loss); the identity post would "
                "silently return one context shard's activations")
        # pipe_tpu's SpmdPipeline is no table executor: its transport is
        # never overlapped nor phase-compiled
        self.executor = ScheduledPipeline(
            self.stage_fn, self.pre_fn, self._post, n_stages=self.n_stages,
            module=self.module, checkpoint=self.checkpoint,
            schedule=self.schedule, device=self.device, mesh=self.mesh,
            overlap_transport=False, phase_compile=False,
            context_axis=self.context_axis, context_dim=self.context_dim)
        self.device = self.executor.device

    def _post(self, h, x_mb, ctx):
        if self.post_with_batch:
            out = self.post_fn(h, x_mb, ctx)
        else:
            out = self.post_fn(h, ctx)
        if self.context_axis and self.debug_context_check:
            out = self._context_checked(out)
        return out

    def _context_checked(self, out):
        """The context-invariance contract, made loud: the largest deviation
        of a float output from its mean over the context line (the line's
        largest, so every rank agrees); past 1e-5 every float output is
        poisoned with NaN and context rank 0 prints one line."""
        from ..parallel.mesh import CONTEXT_AXIS

        leaves = [o for o in (out if isinstance(out, (tuple, list))
                              else (out,))
                  if isinstance(o, torch.Tensor) and o.is_floating_point()]
        if not leaves or self.mesh is None:
            return out
        with torch.no_grad():
            dev = []
            for o in leaves:
                mean = o.detach().float().clone()
                self.mesh.all_reduce(mean, CONTEXT_AXIS)
                mean /= self.mesh.context_size
                dev.append((o.detach().float() - mean).abs().max())
            delta = torch.stack(dev).max().reshape(1)
            self.mesh.all_reduce(delta, CONTEXT_AXIS, op="max")
        if float(delta) <= 1e-5:
            return out
        if self.mesh.context == 0:
            print(f"pipe_tpu context-invariance VIOLATION: post_fn output "
                  f"differs across context shards by {float(delta):.3e}; it "
                  f"must end in a pmean/psum over the context axis. Outputs "
                  f"are poisoned with NaN.", flush=True)
        poison = lambda o: (o + float("nan") if isinstance(o, torch.Tensor)
                            and o.is_floating_point() else o)
        if isinstance(out, (tuple, list)):
            return type(out)(poison(o) for o in out)
        return poison(out)

    def __call__(self, x, *, seed: Optional[int] = None,
                 train: bool = False):
        ex = self.executor
        hs = ex.forward(x, seed=seed, train=train)
        outs = None
        if hs is not None:
            x_local, _ = ex._shard_rows(x.to(self.device) if isinstance(
                x, torch.Tensor) else {k: v.to(self.device)
                                       for k, v in x.items()})
            outs = torch.stack([
                self._post(h, _index(x_local, i),
                           StageCtx(train=train, microbatch=i,
                                    stage=ex.n_virtual - 1))
                for i, h in enumerate(hs)])
        if self.mesh is None:
            return outs
        return self.mesh.gather_outputs(None if outs is None
                                        else (outs,))[0]

    def loss_and_grad(self, x, w, *, seed: Optional[int] = 0):
        """The gpipe table's step (``ScheduledPipeline.loss_and_grad``)."""
        return self.executor.loss_and_grad(x, w, seed=seed)

    def stage_passes(self, m: int, column: Optional[int] = None):
        return self.executor.stage_passes(m, column)
