"""pipe_tpu_torch's table executor against pipe_tpu's ``ScheduledPipeline``
on the toy ``Linear`` + ``tanh`` stage of tests/test_scheduled.py, at the
four geometries of its ``test_loss_and_grad_transparency`` (one stage
included), for gpipe, 1f1b, zb-h1 and interleaved-1f1b in every checkpoint
mode: loss within 1e-5 relative, gradients within rtol 1e-4 / atol 1e-5,
``memory_plan`` equal. Inputs from a numpy seed; dropout 0.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.schedule import InterleavedOneFOneBSchedule
from pipe_tpu.ops.layers import Linear as JLinear
from pipe_tpu.parallel.interleaved import (stack_interleaved_params,
                                           unstack_interleaved_params)
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

WIDTH = 8
SCHEDULES = ["gpipe", "1f1b", "zb-h1", "interleaved-1f1b"]


class Toy(nn.Module):
    """One ``Linear(WIDTH)`` + tanh per virtual stage; identity pre; the
    post is ``sum((h - 1)^2)`` per row (tests/test_scheduled.py)."""

    def __init__(self, params):
        super().__init__()
        self.lins = nn.ModuleList(tl.Linear(WIDTH, WIDTH, device="cpu")
                                  for _ in params)
        for lin, p in zip(self.lins, params):
            convert.load_params(lin, p)

    def stage_fn(self, s, h, ctx):
        return torch.tanh(self.lins[s](h))

    @staticmethod
    def pre_fn(x, ctx):
        return x

    @staticmethod
    def post_fn(h, x_mb, ctx):
        return ((h - 1.0) ** 2).sum(-1)


def _jax_stage(p, h, ctx):
    return jnp.tanh(JLinear(WIDTH).apply(p, h))


@pytest.mark.parametrize("mode", ["always", "except_last", "never"])
@pytest.mark.parametrize("n,m", [(1, 4), (2, 8), (4, 8), (4, 2)])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_toy_stage_matches_pipe_tpu(schedule, n, m, mode):
    v = 2 if schedule == "interleaved-1f1b" else 1
    layer = JLinear(WIDTH)
    params = [jax.tree_util.tree_map(np.asarray, layer.init(
        jax.random.key(s), jnp.zeros((1, WIDTH)))) for s in range(n * v)]
    x = np.random.default_rng(n * 100 + m).standard_normal(
        (m, 2, WIDTH)).astype(np.float32)
    w = np.ones((m, 2), np.float32)

    sched = InterleavedOneFOneBSchedule(interleave=v) if v > 1 else schedule
    stacked = (stack_interleaved_params(params, n) if v > 1
               else stack_stage_params(params))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # zb-h1 under recompute
        jpipe = JPipeline(make_mesh(n, 1), _jax_stage,
                          pre_fn=lambda p, a, ctx: a,
                          post_fn=lambda p, h, a, ctx: jnp.sum((h - 1.0) ** 2,
                                                               -1),
                          checkpoint=mode, schedule=sched)
        want, (gs, _, _) = jax.jit(jpipe.loss_and_grad)(
            stacked, {}, {}, jnp.asarray(x), jnp.asarray(w),
            key=jax.random.key(9))
    gs = jax.tree_util.tree_map(np.asarray, gs)
    per_stage = (unstack_interleaved_params(gs, n) if v > 1
                 else [jax.tree_util.tree_map(lambda a: a[s], gs)
                       for s in range(n)])

    toy = Toy(params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = ScheduledPipeline(toy.stage_fn, toy.pre_fn, toy.post_fn,
                                 n_stages=n, module=toy, checkpoint=mode,
                                 schedule=schedule, device="cpu")
        loss, grads = pipe.loss_and_grad(torch.from_numpy(x),
                                         torch.from_numpy(w))
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    for s, g in enumerate(per_stage):
        np.testing.assert_allclose(grads[f"lins.{s}.weight"].numpy(),
                                   np.asarray(g["w"]).T, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(grads[f"lins.{s}.bias"].numpy(),
                                   np.asarray(g["b"]), rtol=1e-4, atol=1e-5)
    assert pipe.memory_plan(m) == jpipe.memory_plan(m)
