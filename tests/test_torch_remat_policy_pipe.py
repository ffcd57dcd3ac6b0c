"""``remat_policy`` in pipe_tpu_torch's ``Pipe``, its hetero table executor
and core/remat.py, against pipe_tpu's with
``jax.checkpoint_policies.dots_saveable`` (the table executor's own cases:
test_torch_remat_policy.py).

* ``HeteroScheduledPipeline`` over tests/test_pipe_1f1b.py's ``_skip_seq``
  (balance [2, 1, 1, 2], a 0 -> 3 lane) with the policy against pipe_tpu's
  ``Pipe(mesh=stage_mesh(4), remat_policy=)``: loss within 1e-5 relative,
  gradients within rtol 1e-4 / atol 1e-6 (tests/test_torch_scheduled_skip.py),
  the park depths of ``memory_plan`` equal (no re-read window under a
  policy, so a shallower forward park than without one).
* The emulator ``Pipe(remat_policy=)`` and ``Pipe.__call__(remat_policy=)``
  against pipe_tpu's emulator with the policy (loss within 1e-5 relative,
  gradients within rtol 1e-4 / atol 1e-5), and the matrix products the
  policy spares in the backward, counted exactly.
* Under ``never`` the policy is inert: the table executor warns (pipe_tpu's
  text), the hetero executor drops it without a warning.
* The attention kernels' launches (their wrappers routed as on the card)
  are the same with the policy as without: the policy cannot save a kernel's
  output, so a recompute micro-batch runs the forward kernel again.
* Names: the four policies by object or by name; any other name is refused;
  what each saves, on one function.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
from pipe_tpu_torch import convert
from pipe_tpu_torch.core import remat
from pipe_tpu_torch.core.remat import checkpoint_policies, count_dots
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops import flash_attention as tfa
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
from test_torch_scheduled import TOL_GRAD, TOL_LOSS, port_pipeline
from test_torch_scheduled_skip import (BALANCE, PARK_KEYS, _check_grads,
                                       _jskip_seq, _tskip_seq, _xy, jmse,
                                       stage_mesh, tmse)

DOTS = jax.checkpoint_policies.dots_saveable
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv")


def test_policy_on_the_skip_lane_matches_pipe_tpu_and_frees_the_park():
    x, y = _xy()
    jpipe = pipe_tpu.Pipe(_jskip_seq(), chunks=4, checkpoint="except_last",
                          mesh=stage_mesh(4), schedule="1f1b",
                          balance=BALANCE, remat_policy=DOTS)
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))
    jloss, jgrads = jax.jit(lambda p: jpipe.loss_and_grad(
        p, jnp.asarray(x), targets=jnp.asarray(y),
        loss_fn=jmse))(jpipe.shard_params(params))
    jplan = jpipe.memory_plan()
    pipe = pipe_tpu_torch.Pipe(_tskip_seq(), chunks=4,
                               checkpoint="except_last", balance=BALANCE,
                               remat_policy="dots_saveable", device="cpu")
    convert.load_stage_params(pipe, jax.tree_util.tree_map(np.asarray,
                                                           params))
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                 "except_last", "1f1b", device="cpu",
                                 remat_policy=pipe.remat_policy)
    loss, _ = ex.loss_and_grad(torch.from_numpy(x),
                               targets=torch.from_numpy(y), loss_fn=tmse)
    assert loss.item() == pytest.approx(float(jloss), rel=TOL_LOSS)
    _check_grads(pipe, jax.tree_util.tree_map(
        np.asarray, jpipe.unshard_grads(jgrads)))
    plan = ex.memory_plan()
    assert {k: plan[k] for k in PARK_KEYS} == {k: jplan[k]
                                               for k in PARK_KEYS}
    assert plan["policy_residual_slots"] == jplan["policy_residual_slots"]
    # without the policy, the recompute micro-batches re-read the park at B
    # and hold it longer
    plain = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                    "except_last", "1f1b", device="cpu")
    assert (plain.memory_plan()["skip_fwd_park_slots"]
            > plan["skip_fwd_park_slots"])
    assert ex.last_slots["skip_fwd_park"] <= plan["skip_fwd_park_slots"]


@pytest.fixture(scope="module")
def jax_emulator_step():
    """pipe_tpu's emulator ``Pipe`` step under ``dots_saveable`` on the tiny
    LM: ``(params, tokens, targets, loss, grads)`` as numpy."""
    from pipe_tpu.models import transformer_lm as jlm
    cfg = jlm.LMConfig().tiny()
    jpipe = pipe_tpu.Pipe(jlm.build_sequential(cfg), chunks=4,
                          checkpoint="except_last", balance=[4, 3],
                          remat_policy=DOTS)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab,
                                               (8, cfg.seq_len))
    params = jpipe.init(jax.random.key(0), jnp.asarray(tokens))
    targets = np.roll(tokens, -1, -1)

    def jloss(p):
        logits = jpipe(p, jnp.asarray(tokens), train=True)
        return jnp.mean(jlm.cross_entropy(logits, jnp.asarray(targets)))

    loss, grads = jax.value_and_grad(jloss)(params)
    return jax.tree_util.tree_map(np.asarray, (params, tokens, targets,
                                               loss, grads))


@pytest.mark.parametrize("per_call", [False, True])
def test_emulator_pipe_policy_matches_pipe_tpu(jax_emulator_step, per_call):
    params, tokens, targets, want_loss, want = jax_emulator_step
    cfg = tlm.LMConfig().tiny()
    seq = tlm.build_sequential(cfg, device="cpu")
    pipe = pipe_tpu_torch.Pipe(
        seq, chunks=4, checkpoint="except_last", balance=[4, 3],
        remat_policy=None if per_call else checkpoint_policies.dots_saveable,
        device="cpu")
    convert.load_stage_params(pipe, params)
    kw = {"remat_policy": "dots_saveable"} if per_call else {}
    logits = pipe(torch.from_numpy(tokens).long(), train=True, **kw)
    loss = tlm.cross_entropy(logits, torch.from_numpy(targets).long())
    with count_dots() as dots:
        loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=TOL_LOSS)
    want = convert.stage_arrays(pipe, want)
    for name, p in pipe.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], **TOL_GRAD,
                                   err_msg=name)
    # without saving, the backward recomputes the 3 checkpointed
    # micro-batches' products: a block's 4 projections, 2 attention products
    # and 2 feed-forward ones (not the decoder's: the recompute stops once
    # the tensors the backward saved are back, and the decoder's output is
    # not one of them)
    pipe.zero_grad()
    logits = pipe(torch.from_numpy(tokens).long(), train=True,
                  remat_policy=None if per_call else "nothing_saveable")
    loss = tlm.cross_entropy(logits, torch.from_numpy(targets).long())
    with count_dots() as dots0:
        loss.backward()
    assert dots0.count - dots.count == 3 * cfg.n_layers * 8


def test_policy_is_inert_under_never():
    tm = tlm.PipelinedLM(tlm.LMConfig().tiny(), 2, device="cpu")
    with pytest.warns(UserWarning, match="inert"):
        port_pipeline(tm, 2, "1f1b", "never", remat_policy="dots_saveable")
    pipe = pipe_tpu_torch.Pipe(_tskip_seq(), chunks=4, checkpoint="never",
                               balance=BALANCE, device="cpu",
                               remat_policy="dots_saveable")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                     "never", "1f1b", device="cpu",
                                     remat_policy=pipe.remat_policy)
    assert ex._exec.remat_policy is None
    assert ex.memory_plan()["policy_residual_slots"] == 0


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_kernel_launches_are_unchanged_by_the_policy(monkeypatch, schedule):
    """Dropout 0.1, except_last, the attention wrappers routed as on the
    card: the forward, dQ and dK/dV launch ``stage_passes`` times per block
    with the policy as without, and the step's loss and gradients agree."""
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), dropout=0.1)
    monkeypatch.setattr(tl, "_flash_route", lambda *a, **k: True)
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        def counted(*a, _f=getattr(tfa, name), _k=name, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len),
                           generator=torch.Generator().manual_seed(4))
    x = {"tokens": tokens, "targets": torch.roll(tokens, -1, -1)}
    from pipe_tpu_torch.core import microbatch as tmb
    x, rows = tmb.stack_scatter(x, 4)
    w = tmb.valid_row_mask(x, rows)
    runs = []
    for policy in (None, "dots_saveable"):
        model = tlm.PipelinedLM(cfg, 2, device="cpu")
        pipe = port_pipeline(model, 2, schedule, "except_last",
                             remat_policy=policy)
        calls.update(dict.fromkeys(calls, 0))
        loss, grads = pipe.loss_and_grad(x, w, seed=5)
        lps = cfg.n_layers // 2
        passes = pipe.stage_passes(4)
        assert calls == {"flash_attention_fwd": lps * passes["forward"],
                         "flash_attention_bwd_dq": lps * passes["backward"],
                         "flash_attention_bwd_dkv":
                             lps * passes["backward"]}
        runs.append((dict(calls), loss.item(),
                     {k: g.clone() for k, g in grads.items()}))
    (c0, l0, g0), (c1, l1, g1) = runs
    assert c0 == c1
    assert l0 == l1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_policy_names_and_refusals():
    names = ("dots_saveable", "dots_with_no_batch_dims_saveable",
             "nothing_saveable", "everything_saveable")
    for name in names:
        assert hasattr(jax.checkpoint_policies, name)
        policy = getattr(checkpoint_policies, name)
        assert remat.resolve_policy(name) is policy
        assert remat.resolve_policy(policy) is policy
    assert remat.resolve_policy(None) is None
    tm = tlm.PipelinedLM(tlm.LMConfig().tiny(), 2, device="cpu")
    for bad in ("checkpoint_dots", "save_anything_except_these_names",
                DOTS):
        with pytest.raises(ValueError, match=" \\| ".join(sorted(names))):
            port_pipeline(tm, 2, "1f1b", "always", remat_policy=bad)
    with pytest.raises(ValueError, match="remat_policy"):
        pipe_tpu_torch.Pipe(tl.Sequential([tl.Linear(4, 4, device="cpu")]),
                            remat_policy="dots", device="cpu")
    # what each saves, on one function: a batched product and two plain
    w = torch.randn(6, 6, requires_grad=True)

    def f(x):
        h = torch.tanh(x @ w)
        return torch.bmm(h, h.transpose(1, 2)).sum() + (h @ w).sum()

    x = torch.randn(2, 4, 6)
    counts = {}
    for name in (None,) + names:
        loss = remat.apply_remat(f, enabled=True, policy=name)(x)
        with count_dots() as dots:
            loss.backward()
        counts[name] = dots.count
    assert counts["nothing_saveable"] == counts[None]
    assert (counts["everything_saveable"] == counts["dots_saveable"]
            < counts["dots_with_no_batch_dims_saveable"] < counts[None])
