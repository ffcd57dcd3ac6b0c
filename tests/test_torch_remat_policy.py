"""``remat_policy`` in pipe_tpu_torch's table executor against pipe_tpu's
``ScheduledPipeline`` with ``jax.checkpoint_policies.dots_saveable``, from
converted weights and the same numpy inputs (the emulator ``Pipe``, the
hetero executor, the kernels and the names: test_torch_remat_policy_pipe.py).

* The tiny LM through 1f1b under ``always`` and ``except_last`` and
  interleaved-1f1b (v = 2) under ``except_last``: loss within 1e-5 relative
  and gradients within rtol 1e-4 / atol 1e-5 of JAX's policy step
  (tests/test_torch_scheduled.py's tolerances), bit for bit the port's own
  policy-free step, and fewer matrix products dispatched (``count_dots``:
  the policy's saved outputs are not recomputed at B).
* zb-h1 under ``except_last`` with the policy (one stage): the whole
  backward runs at B and W is idle, as in pipe_tpu's one-device executor,
  whose step it matches.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.schedule import InterleavedOneFOneBSchedule
from pipe_tpu.parallel.interleaved import (stack_interleaved_params,
                                           unstack_interleaved_params)
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.core.remat import count_dots
from test_torch_scheduled import (ROWS, TOL_GRAD, TOL_LOSS, _torch_x,
                                  lm_case, port_pipeline)

DOTS = jax.checkpoint_policies.dots_saveable


def _jax_policy_step(schedule, mode, n, m):
    """JAX's ``ScheduledPipeline`` step under ``dots_saveable`` on
    ``lm_case``: ``(loss, grads by port name, port model, x)``."""
    jm, params, tm, x = lm_case(schedule, n, m)
    sp, pre, post = params
    v = 2 if schedule == "interleaved-1f1b" else 1
    sched = InterleavedOneFOneBSchedule(interleave=v) if v > 1 else schedule
    stacked = (stack_interleaved_params(sp, n) if v > 1
               else stack_stage_params(sp))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")             # zb-h1 under recompute
        pipe = JPipeline(make_mesh(n, 1, devices=jax.devices()[:n]),
                         jm.stage_fn, pre_fn=jm.pre_fn,
                         post_fn=jm.loss_post_fn, checkpoint=mode,
                         schedule=sched, remat_policy=DOTS)
    loss, (gs, gpre, gpost) = jax.jit(pipe.loss_and_grad)(
        stacked, pre, post, jax.tree_util.tree_map(jnp.asarray, x),
        jnp.ones((m, ROWS), jnp.float32), key=jax.random.key(1))
    gs = jax.tree_util.tree_map(np.asarray, gs)
    if v > 1:
        gs = unstack_interleaved_params(gs, n)
    grads = convert.pipelined_lm_arrays(
        tm, (gs, *jax.tree_util.tree_map(np.asarray, (gpre, gpost))))
    return float(loss), grads, tm, x


def _port_step(tm, n, schedule, mode, x, m, policy):
    tm.zero_grad(set_to_none=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")             # zb-h1 under recompute
        pipe = port_pipeline(tm, n, schedule, mode, remat_policy=policy)
    with count_dots() as dots:
        loss, grads = pipe.loss_and_grad(_torch_x(x), torch.ones(m, ROWS))
    return loss.item(), {k: g.clone() for k, g in grads.items()}, dots.count


@pytest.mark.parametrize("schedule,mode,n,m", [
    ("1f1b", "always", 2, 4), ("1f1b", "except_last", 2, 4),
    ("interleaved-1f1b", "except_last", 2, 4), ("zb-h1", "except_last", 1, 2)])
def test_scheduled_policy_matches_pipe_tpu(schedule, mode, n, m):
    want_loss, want_grads, tm, x = _jax_policy_step(schedule, mode, n, m)
    loss, grads, dots = _port_step(tm, n, schedule, mode, x, m,
                                   "dots_saveable")
    assert loss == pytest.approx(want_loss, rel=TOL_LOSS)
    assert sorted(grads) == sorted(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), want, **TOL_GRAD,
                                   err_msg=name)
    # the policy changes what is stored, never the math: the policy-free
    # step gives the same bits, and dispatches more matrix products (the
    # recompute micro-batches' forwards at B)
    loss0, grads0, dots0 = _port_step(tm, n, schedule, mode, x, m, None)
    assert loss0 == loss
    for name in grads:
        assert torch.equal(grads[name], grads0[name]), name
    assert dots < dots0
