"""pipe_tpu_torch's tensor-parallel stages over a (stage, data, model) world:
``make_mesh(n_model=)``, ``ScheduledPipeline(stage_param_specs=)`` over
``TPPipelinedLM``, against pipe_tpu's.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_tp_cases.py`` (no JAX there); each rank loads its
stage of ``pipe_tpu``'s ``TPPipelinedLM.init`` params
(``convert.load_ring_stage``), and the executor cuts its sharded leaves to
the rank's model block. The JAX reference is tests/test_tp.py's: the
``tp_axis=None`` model through JAX's 1f1b ``ScheduledPipeline``
(except_last) on a stage mesh, computed once per stage count. Loss within
rtol 1e-5, every gradient (gathered over the model line into whole leaves)
within rtol 2e-4 / atol 1e-5, as tests/test_tp.py holds JAX's own tp=2
run. At dropout 0.1 the tp=2 step equals the port's one-device
``tp_axis=None`` step (every rank of a model line draws the same residual
masks, a data rank its rows: ROADMAP.md C.16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.models.tp_lm import TPPipelinedLM as JTPLM
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.models.tp_lm import TPPipelinedLM
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
from pipe_tpu_torch.runtime import World

D, HEADS, FF, SEQ = 16, 4, 32, 8
M, ROWS = 4, 2


def _cfg(n_layers):
    return dict(vocab=61, d_model=D, nhead=HEADS, d_ff=FF, seq_len=SEQ,
                n_layers=n_layers, dropout=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


def _batch():
    toks = np.random.default_rng(1).integers(0, 61, (M, ROWS, SEQ))
    return ({"tokens": toks.astype(np.int64),
             "targets": np.roll(toks, -1, -1).astype(np.int64)},
            np.ones((M, ROWS), np.float32))


_JAX = {}


def _reference(n_stages):
    """``pipe_tpu``'s params of ``TPPipelinedLM(n_layers=n_stages)`` and
    the ``tp_axis=None`` 1f1b/except_last step's loss and gradients by the
    port's names, once per stage count."""
    if n_stages not in _JAX:
        cfg = JLMConfig(**_cfg(n_stages))
        jref = JTPLM(cfg, n_stages, tp_axis=None)
        params = jax.tree_util.tree_map(np.asarray,
                                        jref.init(jax.random.key(0)))
        x, w = _batch()
        jx = {k: jnp.asarray(v, jnp.int32) for k, v in x.items()}
        pipe = JPipeline(
            jmake_mesh(n_stages, 1, devices=jax.devices()[:n_stages]),
            jref.stage_fn, pre_fn=jref.pre_fn, post_fn=jref.loss_post_fn,
            checkpoint="except_last", schedule="1f1b")
        sp, pre, post = params
        loss, grads = jax.jit(pipe.loss_and_grad)(
            stack_stage_params(sp), pre, post, jx, jnp.asarray(w),
            key=jax.random.key(9))
        model = TPPipelinedLM(LMConfig(**_cfg(n_stages)), n_stages,
                              tp_axis=None, device="cpu")
        _JAX[n_stages] = (params, float(loss), convert.pipelined_lm_arrays(
            model, jax.tree_util.tree_map(np.asarray, grads)))
    return _JAX[n_stages]


def _hold(res, loss, grads):
    for r in res:
        walk = r["walks"]["serialized"]
        np.testing.assert_allclose(walk["loss"], loss, rtol=1e-5)
        assert r["full"] and set(r["full"]) <= set(grads)
        for n, g in r["full"].items():
            np.testing.assert_allclose(g, grads[n], rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r['rank']} {n}")


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
def test_tp_loss_and_grad_match_pipe_tpu(world, shape):
    """Every rank's loss and its gradients, gathered over its model line,
    against JAX's unsharded step; every parameter of the model is some
    rank's; the two ranks of a model line hold equal replicated gradients
    and different shards of the sharded ones, bit for bit."""
    params, loss, grads = _reference(shape[0])
    x, w = _batch()
    res = world.run(cases.tp_step, params, _cfg(shape[0]), shape, x, w)
    _hold(res, loss, grads)
    assert set().union(*(r["full"] for r in res)) == set(grads)
    for a in res:
        for b in res:
            if (a["stage"], a["data"]) != (b["stage"], b["data"]) or \
                    a["model"] >= b["model"]:
                continue
            ga, gb = a["walks"]["serialized"]["grads"], \
                b["walks"]["serialized"]["grads"]
            for n in ga:
                same = np.array_equal(ga[n], gb[n])
                assert same == (n not in a["sharded"]), n


def _one_device_step(n_stages, params, x, w, dropout, seed):
    model = TPPipelinedLM(LMConfig(**dict(_cfg(n_stages), dropout=dropout)),
                          n_stages, tp_axis=None, device="cpu")
    convert.load_pipelined_lm(model, params)
    ex = ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                           n_stages, model, checkpoint="except_last",
                           schedule="1f1b", device="cpu")
    loss, g = ex.loss_and_grad({k: torch.from_numpy(v) for k, v in x.items()},
                               torch.from_numpy(w), seed=seed)
    return float(loss), {k: v.numpy() for k, v in g.items()}


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
def test_tp_dropout_step_is_the_one_device_step(world, shape):
    """Dropout 0.1: the tp=2 step (its data ranks too) against the port's
    one-device ``tp_axis=None`` step of the same parameters and seed."""
    params, _, _ = _reference(shape[0])
    x, w = _batch()
    loss, grads = _one_device_step(shape[0], params, x, w, 0.1, 5)
    free, _ = _one_device_step(shape[0], params, x, w, 0.0, 5)
    assert abs(loss - free) > 1e-4          # the masks do act
    res = world.run(cases.tp_step, params, _cfg(shape[0]), shape, x, w,
                    "except_last", 0.1, 5)
    _hold(res, loss, grads)


def test_tp_walks_are_bitwise_the_serialized_walk(world):
    """Over (2, 1, 2) the overlapped transport and the phase-compiled walk
    (asked for explicitly) give the serialized walk's loss and gradients
    bit for bit; the model line's all-reduces never cross the stage
    messages."""
    params, loss, grads = _reference(2)
    x, w = _batch()
    res = world.run(cases.tp_step, params, _cfg(2), (2, 1, 2), x, w,
                    "except_last", 0.0, 0,
                    ("serialized", "overlapped", "phase"))
    _hold(res, loss, grads)
    for r in res:
        ser = r["walks"]["serialized"]
        assert ser["stats"]["collectives"] > 0
        for name, transport in (("overlapped", "overlapped"),
                                ("phase", "phase-compiled")):
            wk = r["walks"][name]
            assert wk["transport"] == transport
            assert wk["loss"] == ser["loss"]
            for n, g in ser["grads"].items():
                assert np.array_equal(wk["grads"][n], g), (name, n)


def test_mesh_grid_model_line_and_plane(world):
    """``make_mesh(S, D, n_model=M)``: JAX's device grid over ranks
    (model innermost), the model line, the data group and the plane at
    this rank's model index, the stage column at it, the world."""
    for shape in ((2, 1, 2), (1, 2, 2), (1, 1, 4)):
        want = np.asarray(jmake_mesh(*shape[:2], n_model=shape[2],
                                     devices=jax.devices()[:4]).devices)
        ids = np.vectorize(lambda d: d.id)(want)
        res = world.run(cases.mesh_units, shape)
        for r in res:
            assert np.array_equal(np.asarray(r["grid"]), ids - ids.min())
            g = np.asarray(r["grid"])
            i, j, k = r["stage"], r["data"], r["model"]
            assert r["axis_names"] == ["stage", "data", "model"]
            assert g[i, j, k] == r["rank"]
            assert r["gathered"] == [float(v) for v in g[i, j, :]]
            assert r["sum_model"] == float(g[i, j, :].sum())
            assert r["size_model"] == shape[2]
            assert r["sum_data"] == r["sum_plane"] == float(g[i, :, k].sum())
            assert r["size_data"] == r["size_plane"] == shape[1]
            assert r["sum_stage"] == float(g[:, j, k].sum())
            assert r["size_stage"] == shape[0]
            assert r["sum_world"] == 6.0 and r["size_world"] == 4
            assert r["rank_of"] == int(g[0, 0, shape[2] - 1])
            assert r["next"] == int(g[(i + 1) % shape[0], j, k])
            assert f"model={k}/{shape[2]}" in r["repr"]


def test_refusals_are_pipe_tpus(world):
    """``stage_param_specs``' structure error and ``split_stage`` with
    specs in ``pipe_tpu``'s words; ``make_mesh(n_model=)``'s bad shapes;
    ``survivor_mesh`` and ``carve_meshes`` refuse the model axis; a block
    with whole heads over a line of 2 refuses to run."""
    params, _, _ = _reference(2)
    res = world.run(cases.spec_mismatch, params, _cfg(2), (1, 2, 2))[0]
    assert res["structure"][0] == "ValueError"
    assert res["structure"][1].startswith(
        "stage_param_specs structure {'wrong': '*'} does not match the "
        "stacked stage params [")
    assert res["split"] == (
        "ValueError", "split_stage does not compose with stage_param_specs "
        "(tensor-parallel sharded stage params): the tapped/wgrad fns are "
        "written for unsharded math and would silently drop the "
        "cross-shard psums")
    res = world.run(cases.refusals, (1, 2, 2))[0]
    assert res["survivor"][0] == "NotImplementedError"
    assert "no context or model axis" in res["survivor"][1]
    assert res["carve"][0] == "ValueError"
    assert res["n_model"] == ("ValueError", "n_model must be positive (or "
                              "None for no axis)")
    assert res["divides"] == ("ValueError", "4 ranks not divisible by "
                              "n_stages*n_model=3")
    assert res["shape"] == ("ValueError", "mesh 1x1x2 needs 2 ranks, the "
                            "world has 4")
    assert res["unsharded"][0] == "ValueError"
    assert "holds 2 of 2 heads over a model line of 2" in res["unsharded"][1]
