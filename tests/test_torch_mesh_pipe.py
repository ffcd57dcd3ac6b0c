"""``Pipe(mesh=...)`` over a 4-rank gloo world of CPU ranks, against pipe_tpu's
``Pipe(mesh=make_mesh(2, 2))`` on the virtual CPU devices.

One world of 4 ranks (2 stages x 2 data, ``torch.set_num_threads(1)``, a
``FileStore`` rendezvous in the test's tmp dir) is spawned once for the
module and fed every case (``tests/torch_mesh_cases.py``, which imports no
JAX):

* the ranks' coordinates, neighbours and grid;
* the tiny LM (dropout 0, plain attention on both sides: the kernels'
  parity is pinned in tests/test_torch_flash*.py, and Pallas interpret mode
  is what makes tests/test_torch_pipe.py slow) through gpipe, 1f1b, zb-h1
  (never) and interleaved-1f1b (2 stage ranks x v 2) from converted
  weights: the loss within 1e-5 relative and every partition's gradient
  (``unshard_grads``) within 1e-4 x max(1, max|g|) of ``pipe_tpu``'s,
  the eval forward within the same bound, the packed rows' shapes and
  ``memory_plan`` as ``pipe_tpu``'s;
* deferred BatchNorm with the data axis (``_batch_stats`` psum'd over the
  data group): loss, gradients and the committed running stats against
  ``pipe_tpu``'s (stats within 1e-5 / 1e-6, as tests/test_torch_norm.py);
* a cross-stage skip lane (GPT-2 tiny with the embedding skip) against the
  port's one-device table executor, which tests/test_torch_skip.py holds to
  ``pipe_tpu``;
* C.16: the mesh table step with dropout equals the one-device step, and
  so does the structural B/W split's zb-h1 step (W on each rank's own
  column, the gradients summed over the data group);
* a rank that raises fails the call within seconds and the world serves
  the next call.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
import torch_mesh_cases as cases
from pipe_tpu.extras import norm as jnorm
from pipe_tpu.models import common as jcommon
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.ops import layers as jl
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu_torch import convert
from pipe_tpu_torch.models import gpt2 as tgpt2
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.models.common import per_row_ce
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
from pipe_tpu_torch.runtime import World, WorldError

TOL_LOSS = 1e-5              # relative
TOL_GRAD = 1e-4              # of max(1, max|g|), per array


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    """Every array within TOL_GRAD x max(1, max|want|)."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        err = np.abs(np.asarray(got[name]) - w).max()
        assert err <= TOL_GRAD * max(1.0, np.abs(w).max()), (what, name, err)


def _named(trees):
    """``partitions.{j}.{name}`` over per-partition ``{name: array}``."""
    return {f"partitions.{j}.{n}": a for j, t in enumerate(trees)
            for n, a in t.items()}


_JAX_EVAL = {}


def _jax_eval(n_parts, jpipe, packed, x):
    """``pipe_tpu``'s eval forward, once per partition count: every case's
    weights come from one key, and the forward does not depend on the
    schedule's backward."""
    if n_parts not in _JAX_EVAL:
        _JAX_EVAL[n_parts] = np.asarray(jpipe(packed, jnp.asarray(x)))
    return _JAX_EVAL[n_parts]


def _lm_batch(seed=2, rows=8, seq=16, vocab=101):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (rows, seq)).astype(np.int64)
    return x, np.roll(x, -1, -1)


def test_world_coordinates_and_groups(world):
    got = world.run(cases.ranks_and_grid, 2, 2)
    grid = np.arange(4).reshape(2, 2)
    for r, res in enumerate(got):
        assert res["rank"] == r and res["grid"] == grid.tolist()
        assert (res["stage"], res["data"]) == divmod(r, 2)
        assert res["next"] == grid[(res["stage"] + 1) % 2, res["data"]]
        assert res["prev"] == grid[(res["stage"] - 1) % 2, res["data"]]
        # pipe_tpu's global placement: a pipeline on consecutive ranks
        assert (res["global_stage"], res["global_data"]) == (r % 2, r // 2)


def test_init_sharded_draws_each_partition_from_its_fold(world):
    """``init_sharded(seed)``: partition ``j`` from ``fold_seed(seed, j)``,
    each layer by its own rule, on the rank that holds it only; gathered,
    every partition is the one-process draw."""
    from pipe_tpu_torch.core.partition import fold_seed
    from pipe_tpu_torch.pipe import init_weights

    res = world.run(cases.init_sharded, 5)
    ref = pipe_tpu_torch.Pipe(tlm.build_sequential(cases.tiny_lm(),
                                                   device="cpu"),
                              chunks=4, n_stages=2, device="cpu")
    for j, part in enumerate(ref.partitions):
        init_weights(part, torch.Generator().manual_seed(fold_seed(5, j)))
    want = {f"partitions.{j}.{n}": p.detach().numpy()
            for j, part in enumerate(ref.partitions)
            for n, p in part.named_parameters()}
    for r in res:
        got = _named(r["all"])
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
        assert r["own"] and all(np.array_equal(a, want[n])
                                for n, a in r["own"].items())


@pytest.mark.parametrize("schedule,checkpoint,n_parts", [
    ("gpipe", "except_last", 2), ("1f1b", "always", 2),
    ("zb-h1", "never", 2), ("interleaved-1f1b", "except_last", 4)])
def test_pipe_mesh_matches_pipe_tpu(world, schedule, checkpoint, n_parts):
    x, y = _lm_batch()
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), attn_impl="xla")
    jpipe = pipe_tpu.Pipe(jlm.build_sequential(jcfg), chunks=4,
                          n_stages=n_parts, checkpoint=checkpoint,
                          schedule=schedule, mesh=make_mesh(2, 2))
    params = _np(jpipe.init(jax.random.key(1), jnp.asarray(x)))
    packed = jpipe.shard_params(params)
    jloss, jgrads = jax.jit(lambda p: jpipe.loss_and_grad(
        p, jnp.asarray(x), targets=jnp.asarray(y),
        loss_fn=jcommon.per_row_ce))(packed)
    jout = _jax_eval(n_parts, jpipe, packed, x)
    # the port's template: converted weights as per-partition state dicts
    tpipe = pipe_tpu_torch.Pipe(
        tlm.build_sequential(cases.tiny_lm(), device="cpu"), chunks=4,
        n_stages=n_parts, device="cpu")
    convert.load_stage_params(tpipe, params)
    state = [{n: t.numpy() for n, t in p.state_dict().items()}
             for p in tpipe.partitions]
    res = world.run(cases.lm_pipe_step, schedule, checkpoint, n_parts,
                    state, x, y)
    want = convert.stage_arrays(tpipe, _np(jpipe.unshard_grads(jgrads)))
    v = n_parts // 2
    for r in res:
        assert r["loss"] == pytest.approx(float(jloss), rel=TOL_LOSS)
        _close(_named(r["grads"]), want, f"rank {r['stage'], r['data']}")
        np.testing.assert_allclose(r["out"], jout, rtol=0, atol=TOL_GRAD)
        assert r["rows"] == {dt: (v, a.shape[1])
                             for dt, a in packed.items()}
        assert r["plan"]["stash_slots"] == jpipe.memory_plan()["stash_slots"]
    # the gradients go back into pipe_tpu's per-stage trees
    back = convert.stage_trees(tpipe, _named(res[0]["grads"]), params)
    jtrees = _np(jpipe.unshard_grads(jgrads))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtrees)):
        assert np.abs(a - b).max() <= TOL_GRAD * max(1.0, np.abs(b).max())


def _jbn_stack(width=6):
    return jl.Sequential([jl.Linear(width), jnorm.BatchNorm(),
                          jl.Linear(width), jnorm.BatchNorm(), jl.Linear(3)])


def test_pipe_mesh_batch_norm_over_data_matches_pipe_tpu(world):
    """Deferred BN with a data axis: each data rank normalizes by the whole
    micro-batch's statistics (the differentiable all-reduce), and the
    committed running stats are the whole mini-batch's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = rng.standard_normal((16, 3)).astype(np.float32)

    def jloss_fn(out, tgt):
        return jnp.mean(jnp.square(out - tgt), axis=-1)

    jpipe = pipe_tpu.Pipe(_jbn_stack(), chunks=2, n_stages=2,
                          schedule="1f1b", mesh=make_mesh(2, 2),
                          deferred_batch_norm=True)
    params = _np(jpipe.init(jax.random.key(0), jnp.asarray(x)))
    packed = jpipe.shard_params(params)
    jloss, jgrads, jnew = jax.jit(lambda p: jpipe.loss_and_grad(
        p, jnp.asarray(x), targets=jnp.asarray(y), loss_fn=jloss_fn))(packed)
    tpipe = pipe_tpu_torch.Pipe(cases.bn_stack(), chunks=2, n_stages=2,
                                deferred_batch_norm=True, device="cpu")
    convert.load_stage_params(tpipe, params)
    state = [{n: t.numpy() for n, t in p.state_dict().items()}
             for p in tpipe.partitions]
    res = world.run(cases.seq_pipe_step, "bn", 2, state, x, y)
    want = convert.stage_arrays(tpipe, _np(jpipe.unshard_grads(jgrads)))
    stats = convert.stage_arrays(tpipe, _np(jpipe.unshard_params(jnew)))
    for r in res:
        assert r["loss"] == pytest.approx(float(jloss), rel=TOL_LOSS)
        _close(_named(r["grads"]), {k: v for k, v in want.items()
                                    if k in _named(r["grads"])}, "bn grads")
        assert r["buffers"]
        for name, buf in r["buffers"].items():
            np.testing.assert_allclose(buf, stats[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_pipe_mesh_skip_lane_matches_the_one_device_tables(world):
    """GPT-2 tiny with the embedding skip over two stage ranks: the skip
    lane crosses ranks beside the boundary; loss and gradients equal the
    one-device table executor's, and the plan counts the lane."""
    gcfg = dataclasses.replace(tgpt2.GPT2Config().tiny(), attn_impl="xla")
    seq = tgpt2.build_sequential(gcfg, embed_skip=True, device="cpu")
    pipe = pipe_tpu_torch.Pipe(seq, chunks=2, n_stages=2, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.integers(0, gcfg.vocab, (4, gcfg.seq_len)).astype(np.int64)
    y = np.roll(x, -1, -1)
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 2,
                                 "except_last", "1f1b", device="cpu")
    loss, grads = ex.loss_and_grad(torch.from_numpy(x),
                                   targets=torch.from_numpy(y),
                                   loss_fn=per_row_ce, seed=None)
    want = {f"partitions.{n}": g.numpy() for n, g in grads.items()}
    state = [{n: t.numpy() for n, t in p.state_dict().items()}
             for p in pipe.partitions]
    res = world.run(cases.seq_pipe_step, "skip", 2, state, x, y)
    for r in res:
        assert r["loss"] == pytest.approx(loss.item(), rel=TOL_LOSS)
        _close(_named(r["grads"]), want, "skip grads")
        assert r["plan"]["skip_lanes"] == ex.memory_plan()["skip_lanes"] == 1


def test_mesh_dropout_step_is_the_one_device_step_c16(world):
    """C.16 repaired: with dropout 0.3, each data rank draws its rows of the
    whole micro-batch's masks, so the (2 x 2) table step equals the
    one-device step with the same seed."""
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 101, (4, 4, 16)).astype(np.int64)
    x = {"tokens": toks, "targets": np.roll(toks, -1, -1)}
    w = np.ones((4, 4), np.float32)
    ref = cases.table_step("1f1b", "except_last", x, w, seed=7, shape=None)
    res = world.run(cases.dropout_pair)
    for r in res:
        assert r["loss"] == pytest.approx(ref["loss"], rel=TOL_LOSS)
        _close(r["grads"], {k: ref["grads"][k] for k in r["grads"]},
               "dropout grads")
        assert r["stats"]["p2p_messages"] > 0
    nodrop = cases.table_step("1f1b", "except_last", x, w, seed=None,
                              shape=None)
    assert nodrop["loss"] != pytest.approx(ref["loss"], rel=1e-3)


def test_mesh_structural_split_step_is_the_one_device_step(world):
    """zb-h1 under never with ``split_stage="auto"`` and dropout 0.3: the
    (2 x 2) step equals the one-device structural step, which equals the
    one-device 1f1b step."""
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 101, (4, 4, 16)).astype(np.int64)
    x = {"tokens": toks, "targets": np.roll(toks, -1, -1)}
    w = np.ones((4, 4), np.float32)
    ref = cases.table_step("zb-h1", "never", x, w, seed=7, shape=None,
                           split_stage="auto")
    fused = cases.table_step("1f1b", "never", x, w, seed=7, shape=None)
    assert ref["loss"] == pytest.approx(fused["loss"], rel=TOL_LOSS)
    _close(ref["grads"], fused["grads"], "structural vs 1f1b")
    res = world.run(cases.structural_pair)
    for r in res:
        assert r["loss"] == pytest.approx(ref["loss"], rel=TOL_LOSS)
        _close(r["grads"], {k: ref["grads"][k] for k in r["grads"]},
               "structural mesh grads")
        assert r["stats"]["p2p_messages"] > 0


def test_a_rank_that_raises_fails_the_call_and_the_world_recovers(world):
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 raised") as err:
        world.run(cases.raise_on_rank, 1, timeout=30)
    assert "fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 30
    assert not world.procs                       # every rank ended
    got = world.run(cases.ranks_and_grid, 4, 1)  # a new world serves
    assert [r["stage"] for r in got] == [0, 1, 2, 3]
