"""pipe_tpu_torch's MoE over a (stage, data, model) world: the expert-sharded
layer and ``ScheduledPipeline(stage_param_specs=)`` over ``MoEPipelinedLM``,
against pipe_tpu's.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_moe_cases.py`` (no JAX there). tests/test_moe.py's
cases: the ep = 2 layer's output, aux loss and every gradient of
``sum(out ** 2) + 0.01 * aux`` (gathered over the model line) against
JAX's unsharded layer, with its two all-reduces a direction; the full PP x
DP x EP step at (2, 1, 2) and (1, 2, 2), each rank loading its stage of
``pipe_tpu``'s ``MoEPipelinedLM.init`` params (``convert.load_ring_stage``)
and the executor cutting its heads and experts, against JAX's
``loss_and_grad`` on the same mesh shape and on the ``ep_axis=None`` model
(loss within rtol 1e-5, gradients within rtol 3e-4 / atol 1e-5, at
tests/test_moe.py's drop-free capacity factor 2.0, so that a data rank's
capacity drops nothing the whole batch keeps); the replicated gradients of
a model line bit for bit; at dropout 0.1 the port's one-device step; the
refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.models.moe_lm import MoELMConfig as JMoECfg
from pipe_tpu.models.moe_lm import MoEPipelinedLM as JMoELM
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.ops import moe as jmoe
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.models.moe_lm import MoELMConfig, MoEPipelinedLM
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
from pipe_tpu_torch.runtime import World

D, FF, E, ROWS, SEQ = 8, 16, 4, 2, 8
M, MB_ROWS = 2, 4
CFG = dict(dataclasses.asdict(JLMConfig().tiny()), d_model=D, nhead=2,
           d_ff=FF, n_layers=2, seq_len=SEQ, dropout=0.0, n_experts=E,
           top_k=2, capacity_factor=2.0)
CFG.pop("compute_dtype")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


_JAX = {}


@pytest.mark.parametrize("k", [1, 2])
def test_ep_layer_matches_unsharded(world, k):
    """The layer over a model line of 2 (each rank E/2 experts and their
    router columns) against JAX's unsharded layer: output and aux within
    1e-5, every gradient gathered over the line within rtol 3e-4 / atol
    1e-5; two all-reduces forward and two backward, nothing else."""
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_ffn_init(jax.random.key(0), D, FF, E))
    h = np.asarray(jax.random.normal(jax.random.key(1), (ROWS, SEQ, D)))

    def loss(p, x):
        out, aux = jmoe.moe_ffn_apply(p, x, JCtx(), n_experts=E, k=k,
                                      ep_axis=None)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (out, aux)), (g, gh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h))
    res = world.run(cases.ep_layer, params, h, E, k, 1.25)
    for r in res:
        np.testing.assert_allclose(r["out"], np.asarray(out), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["aux"], float(aux), rtol=1e-5)
        np.testing.assert_allclose(r["h_grad"], np.asarray(gh), rtol=3e-4,
                                   atol=1e-5)
        for n, want in g.items():
            np.testing.assert_allclose(r["grads"][n], np.asarray(want),
                                       rtol=3e-4, atol=1e-5, err_msg=n)
        assert r["local"]["w1"] == (E // 2, D, FF)
        assert r["local"]["wr"] == (D, E // 2)
        assert (r["fwd_allreduces"], r["allreduces"]) == (2, 4)
        assert r["collectives"] == 4          # no all-to-all, nothing else


def _batch():
    toks = np.random.default_rng(1).integers(0, CFG["vocab"],
                                             (M, MB_ROWS, SEQ))
    return ({"tokens": toks.astype(np.int64),
             "targets": np.roll(toks, -1, -1).astype(np.int64)},
            np.ones((M, MB_ROWS), np.float32))


def _reference(shape):
    """``pipe_tpu``'s params of ``MoEPipelinedLM`` at ``shape``'s stage
    count and its 1f1b/never ``loss_and_grad`` on the ``ep_axis=None``
    model over a stage mesh and on the same (stage, data, model) mesh with
    ``stage_param_specs``: losses and gradients by the port's names, once
    per shape."""
    if shape not in _JAX:
        n_stages = shape[0]
        cfg = JMoECfg(**CFG)
        ref = JMoELM(cfg, n_stages, ep_axis=None)
        params = jax.tree_util.tree_map(np.asarray,
                                        ref.init(jax.random.key(0)))
        x, w = _batch()
        jx = {k: jnp.asarray(v, jnp.int32) for k, v in x.items()}
        sp, pre, post = params
        port = MoEPipelinedLM(MoELMConfig(**CFG), n_stages, ep_axis=None,
                              device="cpu")
        out = {}
        for name, model, mesh, kw in (
                ("unsharded", ref,
                 jmake_mesh(n_stages, 1, devices=jax.devices()[:n_stages]),
                 {}),
                ("ep", JMoELM(cfg, n_stages),
                 jmake_mesh(shape[0], shape[1], n_model=shape[2],
                            devices=jax.devices()[:4]),
                 {"stage_param_specs": JMoELM(cfg, n_stages)
                  .stage_param_specs()})):
            pipe = JPipeline(mesh, model.stage_fn, pre_fn=model.pre_fn,
                             post_fn=model.loss_post_fn, checkpoint="never",
                             schedule="1f1b", **kw)
            loss, grads = jax.jit(pipe.loss_and_grad)(
                stack_stage_params(sp), pre, post, jx, jnp.asarray(w),
                key=jax.random.key(9))
            out[name] = (float(loss), convert.pipelined_lm_arrays(
                port, jax.tree_util.tree_map(np.asarray, grads)))
        _JAX[shape] = (params, out)
    return _JAX[shape]


def _hold(res, loss, grads):
    for r in res:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert r["full"] and set(r["full"]) <= set(grads)
        for n, g in r["full"].items():
            np.testing.assert_allclose(g, grads[n], rtol=3e-4, atol=1e-5,
                                       err_msg=f"rank {r['rank']} {n}")


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
def test_moe_loss_and_grad_match_pipe_tpu(world, shape):
    """Every rank's loss and its gradients, gathered over its model line,
    against JAX's step on the same mesh shape and JAX's unsharded step
    (which agree); every parameter of the model is some rank's; the
    executor cut the heads and every expert leaf under ``moe.*`` to the
    rank's block; the two ranks of a model line hold equal replicated
    gradients and different shards of the sharded ones, bit for bit."""
    params, ref = _reference(shape)
    x, w = _batch()
    res = world.run(cases.moe_step, params, CFG, shape, x, w, "never")
    for name in ("unsharded", "ep"):
        loss, grads = ref[name]
        _hold(res, loss, grads)
    assert set().union(*(r["full"] for r in res)) == set(ref["ep"][1])
    lps = CFG["n_layers"] // shape[0]
    for r in res:
        for i in range(lps):
            b = f"blocks.{r['stage'] * lps + i}"
            assert r["local"][f"{b}.moe.w1"] == (E // 2, D, FF)
            assert r["local"][f"{b}.moe.wr"] == (D, E // 2)
            assert r["local"][f"{b}.wqkv"][2] == 1
            assert {f"{b}.moe.{n}" for n in ("wr", "br", "w1", "b1", "w2",
                                             "b2")} <= set(r["sharded"])
    for a in res:
        for b in res:
            if (a["stage"], a["data"]) != (b["stage"], b["data"]) or \
                    a["model"] >= b["model"]:
                continue
            for n in a["grads"]:
                same = np.array_equal(a["grads"][n], b["grads"][n])
                assert same == (n not in a["sharded"]), n


def _one_device_step(n_stages, params, x, w, dropout, seed):
    model = MoEPipelinedLM(MoELMConfig(**dict(CFG, dropout=dropout)),
                           n_stages, ep_axis=None, device="cpu")
    convert.load_pipelined_lm(model, params)
    ex = ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                           n_stages, model, checkpoint="except_last",
                           schedule="1f1b", device="cpu")
    loss, g = ex.loss_and_grad({k: torch.from_numpy(v) for k, v in x.items()},
                               torch.from_numpy(w), seed=seed)
    return float(loss), {k: v.numpy() for k, v in g.items()}


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
def test_moe_dropout_step_is_the_one_device_step(world, shape):
    """Dropout 0.1: the ep=2 step (its data ranks too) against the port's
    one-device ``ep_axis=None`` step of the same parameters and seed (the
    residual masks alike on a model line, a data rank's rows of the whole
    micro-batch's)."""
    params, _ = _reference(shape)
    x, w = _batch()
    loss, grads = _one_device_step(shape[0], params, x, w, 0.1, 5)
    free, _ = _one_device_step(shape[0], params, x, w, 0.0, 5)
    assert abs(loss - free) > 1e-4          # the masks do act
    res = world.run(cases.moe_step, params, CFG, shape, x, w,
                    "except_last", 0.1, 5)
    _hold(res, loss, grads)


def test_refusals_are_pipe_tpus(world):
    """A spec tree that does not match the MoE stage, ``split_stage`` with
    specs (``pipe_tpu`` has no split MoE stage), in JAX's words; a block
    with whole experts over a model line of 2."""
    params, _ = _reference((1, 2, 2))
    res = world.run(cases.spec_refusals, params, CFG, (1, 2, 2))[0]
    assert res["structure"][0] == "ValueError"
    assert res["structure"][1].startswith("stage_param_specs structure ")
    assert "does not match the stacked stage params" in res["structure"][1]
    assert res["split"] == (
        "ValueError", "split_stage does not compose with stage_param_specs "
        "(tensor-parallel sharded stage params): the tapped/wgrad fns are "
        "written for unsharded math and would silently drop the "
        "cross-shard psums")
    assert res["whole"][0] == "ValueError"
    assert "holds 4 of 4 experts over a model line of 2" in res["whole"][1]
