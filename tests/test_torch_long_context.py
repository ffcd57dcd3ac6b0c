"""pipe_tpu_torch's ``ContextParallelLM`` (``models/long_context_lm.py``)
through ``SpmdPipeline`` and the 1f1b table with ``context_axis``, against
pipe_tpu's.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_context_cases.py`` (no JAX there); each rank takes
its stage of ``pipe_tpu``'s ``ContextParallelLM.init`` params
(``convert.load_ring_stage``) on a (stage, data, context) mesh of (2, 1, 2)
or (1, 1, 4). The JAX references are computed once per module on the
virtual CPU devices: ``SpmdPipeline(context_axis="context")`` over
``make_mesh(S, 1, n_context=C)`` for the per-row losses (rtol 2e-4, atol
2e-5, as ``test_pp_cp_forward_transparency``), and ``jax.grad`` of the mean
of tests/test_long_context.py's independent one-device loss for the
gradients (rtol 2e-3, atol 2e-4, as
``test_pp_cp_gradient_flows_and_matches``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_context_cases as cases
from test_long_context import plain_reference_loss
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.models.long_context_lm import ContextParallelLM as JCPLM
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.spmd import SpmdPipeline as JSpmd
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.models.long_context_lm import ContextParallelLM
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
from pipe_tpu_torch.parallel.spmd import SpmdPipeline
from pipe_tpu_torch.runtime import World

CFG = dict(vocab=101, d_model=16, nhead=4, d_ff=32, n_layers=2, seq_len=32,
           dropout=0.0)
M, ROWS = 2, 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


def _batch():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG["vocab"], (M, ROWS, CFG["seq_len"]))
    return {"tokens": toks.astype(np.int64),
            "targets": np.roll(toks, -1, -1).astype(np.int64)}


_JAX = {}


def _params(n_stages):
    """``pipe_tpu``'s ``ContextParallelLM.init`` params (numpy, per-stage
    lists) and the gradients of the mean one-device loss, once."""
    if ("params", n_stages) not in _JAX:
        jmodel = JCPLM(JLMConfig(**CFG), n_stages)
        params = jax.tree_util.tree_map(np.asarray,
                                        jmodel.init(jax.random.key(0)))
        x = _batch()
        tokens = jnp.asarray(x["tokens"].reshape(M * ROWS, -1))
        targets = jnp.asarray(x["targets"].reshape(M * ROWS, -1))
        grads = jax.grad(lambda p: jnp.mean(plain_reference_loss(
            jmodel, p, tokens, targets)))(params)
        _JAX[("params", n_stages)] = (
            params, jax.tree_util.tree_map(np.asarray, grads))
    return _JAX[("params", n_stages)]


def _jax_per_row(n_stages, n_context, sp_impl):
    """JAX's pipeline per-row losses ``[m, rows]``, once per config."""
    key = ("rows", n_stages, n_context, sp_impl)
    if key not in _JAX:
        params, _ = _params(n_stages)
        jmodel = JCPLM(JLMConfig(**CFG), n_stages, sp_impl=sp_impl)
        mesh = jmake_mesh(n_stages, 1, n_context=n_context)
        pipe = JSpmd(mesh, jmodel.stage_fn, pre_fn=jmodel.pre_fn,
                     post_fn=jmodel.loss_post_fn, post_with_batch=True,
                     context_axis="context")
        sp, pre, post = params
        x = {k: jnp.asarray(v, jnp.int32) for k, v in _batch().items()}
        _JAX[key] = np.asarray(jax.jit(pipe.__call__)(
            stack_stage_params(sp), pre, post, x))
    return _JAX[key]


def _port_names(n_stages, grads):
    """JAX's gradient triple by the port model's parameter names."""
    model = ContextParallelLM(LMConfig(**CFG), n_stages, device="cpu")
    return convert.pipelined_lm_arrays(model, grads)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
@pytest.mark.parametrize("n_stages,n_context", [(2, 2), (1, 4)])
def test_spmd_pipeline_matches_pipe_tpu(world, n_stages, n_context,
                                        sp_impl):
    """Per-row losses of every rank against JAX's ``SpmdPipeline`` with
    ``context_axis``; every rank's gradients (summed over its stage's
    context line) against ``jax.grad`` of the one-device loss; the loss is
    the per-row mean."""
    params, jgrads = _params(n_stages)
    want = _jax_per_row(n_stages, n_context, sp_impl)
    res = world.run(cases.spmd_step, params, CFG, (n_stages, 1, n_context),
                    _batch(), sp_impl)
    named = _port_names(n_stages, jgrads)
    for r in res:
        np.testing.assert_allclose(r["per_row"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["loss"], want.mean(), rtol=2e-4,
                                   atol=2e-5)
        assert r["grads"] and set(r["grads"]) <= set(named)
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, named[name], rtol=2e-3, atol=2e-4,
                                       err_msg=name)
    held = {n for r in res for n in r["grads"]}
    assert held == set(named)


def test_table_walks_with_context_axis(world):
    """The 1f1b table (except_last) with ``context_axis`` on a (2, 1, 2)
    mesh: its gradients are the gpipe step's within float rounding, and
    the overlapped and phase-compiled walks are the serialized walk's bit
    for bit (losses and gradients)."""
    params, jgrads = _params(2)
    res = world.run(cases.table_steps, params, CFG, (2, 1, 2), _batch())
    named = _port_names(2, jgrads)
    for r in res:
        ser = r["serialized"]
        assert (r["overlapped"]["transport"], r["phase"]["transport"]) == (
            "overlapped", "phase-compiled")
        for walk in ("overlapped", "phase"):
            assert r[walk]["loss"] == ser["loss"]
            for name, g in ser["grads"].items():
                np.testing.assert_array_equal(r[walk]["grads"][name], g)
        np.testing.assert_allclose(ser["loss"], r["gpipe"]["loss"],
                                   rtol=1e-6)
        for name, g in ser["grads"].items():
            np.testing.assert_allclose(g, r["gpipe"]["grads"][name],
                                       rtol=1e-5, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(g, named[name], rtol=2e-3, atol=2e-4)


def test_debug_context_check_passes_and_poisons(world):
    """``debug_context_check``: the model's averaged loss passes untouched
    and prints nothing; JAX's ``bad_post`` (each shard's first token, no
    reduction) is poisoned with NaN on every rank, and context rank 0 of
    the last stage prints the violation."""
    params, _ = _params(2)
    res = world.run(cases.debug_check, params, CFG, (2, 1, 2), _batch())
    for r in res:
        assert np.isfinite(r["good"]["out"]).all()
        assert r["good"]["printed"] == ""
        assert np.isnan(r["bad"]["out"]).all()
    printed = [r["bad"]["printed"] for r in res]
    assert sum("context-invariance VIOLATION" in p for p in printed) >= 1
    assert all(p == "" for r, p in zip(res, printed) if r["context"] != 0)


def test_context_axis_refusals_are_pipe_tpus(world):
    """JAX's refusals: a mesh without the axis (and no mesh), and
    ``context_axis`` without a post."""
    assert world.run(cases.axis_refusal)[0] == (
        "mesh has no 'context' axis for context_axis")
    model = ContextParallelLM(LMConfig().tiny(), 2, device="cpu")
    with pytest.raises(ValueError,
                       match="mesh has no 'context' axis for context_axis"):
        ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                          n_stages=2, module=model, device="cpu",
                          context_axis="context")
    with pytest.raises(ValueError, match="context_axis requires a post_fn"):
        SpmdPipeline(model.stage_fn, model.pre_fn, None, n_stages=2,
                     module=model, device="cpu", context_axis="context")
    with pytest.raises(ValueError, match="sp_impl must be ring|ulysses"):
        ContextParallelLM(LMConfig().tiny(), 2, "tree", device="cpu")


def test_one_device_is_the_tutorial_lm():
    """Without a mesh the model is the tutorial LM's math on the whole
    sequence: its per-row loss is ``PipelinedLM.loss_post_fn``'s on the
    same weights, for both attentions."""
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM

    cfg = dataclasses.replace(LMConfig(**CFG), attn_impl="xla")
    x = {k: torch.from_numpy(v[0]) for k, v in _batch().items()}
    ref = PipelinedLM(cfg, 2, device="cpu")
    with torch.no_grad():
        h = ref.pre_fn(x)
        for s in range(2):
            h = ref.stage_fn(s, h)
        want = ref.loss_post_fn(h, x)
        for impl in ("ring", "ulysses"):
            model = ContextParallelLM(cfg, 2, impl, device="cpu")
            model.load_state_dict(ref.state_dict())
            h = model.pre_fn(x)
            for s in range(2):
                h = model.stage_fn(s, h)
            torch.testing.assert_close(model.loss_post_fn(h, x), want,
                                       rtol=1e-5, atol=1e-6)
