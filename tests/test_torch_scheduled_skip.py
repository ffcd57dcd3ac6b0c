"""The skip lanes of pipe_tpu_torch's table executor (parallel/scheduled.py)
and its one-device ``HeteroScheduledPipeline`` against pipe_tpu's.

* The raw ``ScheduledPipeline(skip_lanes=)`` on the geometry of
  tests/test_scheduled.py's ``test_skip_lanes_raw_executor`` (4 stages, 4
  micro-batches, a 0 -> 3 lane) against pipe_tpu's executor on 4 virtual
  CPU devices, gpipe and 1f1b in every checkpoint mode: loss within 1e-5
  relative, gradients within rtol 1e-4 / atol 1e-6, ``memory_plan`` (park
  slots included) equal.
* ``HeteroScheduledPipeline`` over the ``Pipe`` partitions of
  tests/test_pipe_1f1b.py's ``_skip_seq`` (balance [2, 1, 1, 2]) against
  ``Pipe(mesh=stage_mesh(4), schedule=...).loss_and_grad``, gpipe and 1f1b
  in every checkpoint mode, same tolerances, and its ``memory_plan``'s park
  counts equal to pipe_tpu's; the uneven, multi-value boundary case on 2
  stages; the FWD-only forward against the emulator; dropout masks equal to
  the emulator's (seeds fold as ``ctx.fold(i, j)``): loss within 1e-5,
  gradients within 1e-4 x max(1, max|g|).
* The refusals: zb-h1, fewer than 2 stages, an integer lane, a lane out of
  range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.extras import skip as jskip
from pipe_tpu.ops import layers as jl
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.scheduled import SkipLanes as JLanes
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.core.partition import StageCtx
from pipe_tpu_torch.extras import skip as tskip
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline, SkipLanes

MODES = ["never", "except_last", "always"]
SCHEDULES = ["gpipe", "1f1b"]
TOL_LOSS = 1e-5
TOL_GRAD = dict(rtol=1e-4, atol=1e-6)
WIDTH = 8
PARK_KEYS = ("skip_lanes", "skip_fwd_park_slots", "skip_bwd_park_slots")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def stage_mesh(n):
    return make_mesh(n, 1, devices=jax.devices()[:n])


# --- the raw executor -----------------------------------------------------------

D, M = 4, 4


def _raw_params():
    rng = np.random.default_rng(0)
    return [{"w": (rng.standard_normal((WIDTH, WIDTH)) * 0.3
                   ).astype(np.float32),
             "b": np.zeros((WIDTH,), np.float32)} for _ in range(D)]


def _raw_x():
    return np.random.default_rng(1).standard_normal(
        (M, 2, WIDTH)).astype(np.float32)


_JAX_RAW = {}


def jax_raw(schedule, mode):
    if (schedule, mode) not in _JAX_RAW:
        lanes = JLanes(pairs=((0, 3),), specs=(jax.ShapeDtypeStruct(
            (2, WIDTH), jnp.float32),))

        def stage_fn(p, h, ctx, pops):
            h1 = jnp.tanh(h @ p["w"] + p["b"])
            out = jnp.where(jnp.asarray(ctx.stage == 3), h1 + pops[0], h1)
            sk = jnp.where(jnp.asarray(ctx.stage == 0), h1,
                           jnp.zeros_like(h1))
            return out, (sk,)

        pipe = JPipeline(stage_mesh(D), stage_fn,
                         pre_fn=lambda p, x, ctx: x,
                         post_fn=lambda p, h, x, ctx: jnp.sum(
                             (h - 1.0) ** 2, axis=-1),
                         checkpoint=mode, schedule=schedule,
                         skip_lanes=lanes)
        xs = jnp.asarray(_raw_x())
        loss, (gsp, _, _) = jax.jit(pipe.loss_and_grad)(
            stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                for p in _raw_params()]),
            {}, {}, xs, jnp.ones(xs.shape[:2], jnp.float32))
        _JAX_RAW[(schedule, mode)] = (float(loss), _np(gsp),
                                      pipe.memory_plan(M))
    return _JAX_RAW[(schedule, mode)]


def port_raw(schedule, mode):
    lins = nn.ModuleList(tl.Linear(WIDTH, WIDTH, device="cpu")
                         for _ in range(D))
    with torch.no_grad():
        for lin, p in zip(lins, _raw_params()):
            lin.weight.copy_(torch.from_numpy(p["w"].T))
            lin.bias.copy_(torch.from_numpy(p["b"]))

    def stage_fn(s, h, ctx, pops):
        h1 = torch.tanh(lins[s](h))
        return (h1 + pops[0] if s == 3 else h1), (h1 if s == 0 else None,)

    return ScheduledPipeline(
        stage_fn, lambda x, ctx: x,
        lambda h, x, ctx: ((h - 1.0) ** 2).sum(-1), n_stages=D,
        module=lins, checkpoint=mode, schedule=schedule, device="cpu",
        skip_lanes=SkipLanes(((0, 3),), (torch.zeros(2, WIDTH),)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_raw_skip_lanes_match_pipe_tpu(schedule, mode):
    want_loss, want_g, want_plan = jax_raw(schedule, mode)
    pipe = port_raw(schedule, mode)
    loss, grads = pipe.loss_and_grad(torch.from_numpy(_raw_x()),
                                     torch.ones(M, 2))
    assert loss.item() == pytest.approx(want_loss, rel=TOL_LOSS)
    for j in range(D):
        np.testing.assert_allclose(grads[f"{j}.weight"].numpy(),
                                   want_g["w"][j].T, **TOL_GRAD)
        np.testing.assert_allclose(grads[f"{j}.bias"].numpy(),
                                   want_g["b"][j], **TOL_GRAD)
    assert pipe.memory_plan(M) == want_plan
    assert want_plan["skip_lanes"] == 1
    # the parks never held more than the plan's slots
    assert 0 < pipe.last_slots["skip_fwd_park"] <= want_plan[
        "skip_fwd_park_slots"]
    assert 0 < pipe.last_slots["skip_bwd_park"] <= want_plan[
        "skip_bwd_park_slots"]


def test_raw_forward_takes_the_lanes():
    """FWD-only: the lane carries the stash into stage 3, no reverse park;
    the output equals the plain chain's."""
    pipe = port_raw("1f1b", "never")
    x = torch.from_numpy(_raw_x())
    with torch.no_grad():
        out = pipe.forward(x)
        h = torch.tanh(pipe.module[0](x))
        saved = h
        for j in range(1, D):
            h = torch.tanh(pipe.module[j](h))
        h = h + saved
    torch.testing.assert_close(out, h, rtol=1e-6, atol=1e-6)


# --- HeteroScheduledPipeline over Pipe partitions ---------------------------------

@jskip.skippable(stash=["z"])
class JS(jl.Module):
    def init(self, key, *a):
        return {}

    def apply(self, p, x, ctx=JCtx()):
        jskip.stash("z", x)
        return x


@jskip.skippable(pop=["z"])
class JPo(jl.Module):
    def init(self, key, *a):
        return {}

    def apply(self, p, x, ctx=JCtx()):
        return x + jskip.pop("z")


@tskip.skippable(stash=["z"])
class TS(nn.Module):
    def forward(self, x, ctx=StageCtx()):
        tskip.stash("z", x)
        return x


@tskip.skippable(pop=["z"])
class TPo(nn.Module):
    def forward(self, x, ctx=StageCtx()):
        return x + tskip.pop("z")


BALANCE = [2, 1, 1, 2]


def _jskip_seq():
    return jl.Sequential([jl.Linear(WIDTH), JS(), jl.Linear(WIDTH),
                          jl.Linear(WIDTH), JPo(), jl.Linear(WIDTH)])


def _tskip_seq(dropout=0.0):
    gen = torch.Generator().manual_seed(0)

    def lin():
        return tl.Linear(WIDTH, WIDTH, device="cpu", generator=gen)

    extra = [tl.Dropout(dropout)] if dropout else []
    return tl.Sequential([lin(), TS(), *extra, lin(), lin(), TPo(), lin()])


def jmse(out, tgt):
    return jnp.mean((out - tgt[:, None]) ** 2, axis=-1)


def tmse(out, tgt):
    return ((out - tgt[:, None]) ** 2).mean(-1)


def _xy(rows=8, width=WIDTH):
    x = np.random.default_rng(1).standard_normal((rows, width)).astype(
        np.float32)
    return x, np.sin(x).sum(-1).astype(np.float32)


_JAX_HETERO = {}


def jax_hetero(schedule, mode):
    if (schedule, mode) not in _JAX_HETERO:
        x, y = _xy()
        pipe = pipe_tpu.Pipe(_jskip_seq(), chunks=4, checkpoint=mode,
                             mesh=stage_mesh(4), schedule=schedule,
                             balance=BALANCE)
        params = pipe.init(jax.random.key(0), jnp.asarray(x))
        loss, grads = jax.jit(lambda p: pipe.loss_and_grad(
            p, jnp.asarray(x), targets=jnp.asarray(y),
            loss_fn=jmse))(pipe.shard_params(params))
        _JAX_HETERO[(schedule, mode)] = (
            _np(params), float(loss), _np(pipe.unshard_grads(grads)),
            pipe.memory_plan())
    return _JAX_HETERO[(schedule, mode)]


def _check_grads(pipe, want_grads):
    want = convert.stage_arrays(pipe, want_grads)
    got = {n: p.grad.numpy() for n, p in pipe.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, **TOL_GRAD, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_hetero_skip_matches_pipe_tpu_mesh(schedule, mode):
    params, want_loss, want_grads, want_plan = jax_hetero(schedule, mode)
    x, y = _xy()
    pipe = pipe_tpu_torch.Pipe(_tskip_seq(), chunks=4, checkpoint=mode,
                               balance=BALANCE, device="cpu")
    convert.load_stage_params(pipe, params)
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4, mode,
                                 schedule, device="cpu")
    assert ex.lane_pairs == ((0, 3),)
    loss, _ = ex.loss_and_grad(torch.from_numpy(x),
                               targets=torch.from_numpy(y), loss_fn=tmse)
    assert loss.item() == pytest.approx(want_loss, rel=TOL_LOSS)
    _check_grads(pipe, want_grads)
    plan = ex.memory_plan()
    assert {k: plan[k] for k in PARK_KEYS} == {k: want_plan[k]
                                               for k in PARK_KEYS}


def test_uneven_balance_and_multi_value_boundary_1f1b():
    """A tuple boundary and an uneven split: the stage handing on two
    values carries them as a tuple, each leaf on its own ring entry."""
    def jsplit(x):
        return x, jnp.sum(x, axis=-1, keepdims=True)

    jseq = jl.Sequential([jl.Linear(WIDTH), jl.Lambda(jsplit),
                          jl.Lambda(lambda x, s: x * s), jl.Linear(16),
                          jl.Linear(WIDTH)])
    x, _ = _xy()
    y = np.sin(x).sum(-1).astype(np.float32)
    jpipe = pipe_tpu.Pipe(jseq, chunks=4, checkpoint="except_last",
                          mesh=stage_mesh(2), schedule="1f1b",
                          balance=[2, 3])
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))
    loss, grads = jpipe.loss_and_grad(jpipe.shard_params(params),
                                      jnp.asarray(x), targets=jnp.asarray(y),
                                      loss_fn=jmse)
    gen = torch.Generator().manual_seed(0)
    tseq = tl.Sequential([
        tl.Linear(WIDTH, WIDTH, device="cpu", generator=gen),
        tl.Lambda(lambda x: (x, x.sum(-1, keepdim=True))),
        tl.Lambda(lambda x, s: x * s),
        tl.Linear(WIDTH, 16, device="cpu", generator=gen),
        tl.Linear(16, WIDTH, device="cpu", generator=gen)])
    pipe = pipe_tpu_torch.Pipe(tseq, chunks=4, checkpoint="except_last",
                               balance=[2, 3], device="cpu")
    convert.load_stage_params(pipe, _np(params))
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                 "except_last", "1f1b", device="cpu")
    got, _ = ex.loss_and_grad(torch.from_numpy(x),
                              targets=torch.from_numpy(y), loss_fn=tmse)
    assert got.item() == pytest.approx(float(loss), rel=TOL_LOSS)
    _check_grads(pipe, _np(jpipe.unshard_grads(grads)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hetero_forward_matches_emulator(train):
    """The FWD-masked walk gives the emulator's outputs, the lane's stash
    popped at stage 3; under dropout the same masks (the seeds fold as the
    emulator's)."""
    x, _ = _xy(rows=7)                        # a padded last micro-batch
    pipe = pipe_tpu_torch.Pipe(_tskip_seq(dropout=0.5), chunks=4,
                               balance=[3, 1, 1, 2], device="cpu")
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                 "never", "1f1b", device="cpu")
    with torch.no_grad():
        want = pipe(torch.from_numpy(x), train=train, seed=5)
        got = ex.forward(torch.from_numpy(x), train=train, seed=5)
    # the padded micro-batch runs 2 rows where the emulator's runs 1: the
    # matmuls round differently there
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_hetero_dropout_step_equals_emulator(mode):
    """Dropout 0.5 after the stash: one 1f1b step of the table walk gives
    the emulator ``Pipe``'s loss and gradients, from one seed."""
    x, y = _xy()
    results = []
    for table in (False, True):
        pipe = pipe_tpu_torch.Pipe(_tskip_seq(dropout=0.5), chunks=4,
                                   checkpoint=mode, balance=[3, 1, 1, 2],
                                   device="cpu")
        if table:
            ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout,
                                         4, mode, "1f1b", device="cpu")
            loss, _ = ex.loss_and_grad(torch.from_numpy(x),
                                       targets=torch.from_numpy(y),
                                       loss_fn=tmse, seed=9)
        else:
            loss = tmse(pipe(torch.from_numpy(x), train=True, seed=9),
                        torch.from_numpy(y)).mean()
            loss.backward()
        results.append((loss.item(), [p.grad for p in pipe.parameters()]))
    (l_e, g_e), (l_t, g_t) = results
    # only the order in which micro-batches' gradients add up differs
    assert l_t == pytest.approx(l_e, rel=TOL_LOSS)
    for a, b in zip(g_t, g_e):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


# --- refusals ---------------------------------------------------------------------

def _skip_pipe(balance):
    return pipe_tpu_torch.Pipe(_tskip_seq(), chunks=4, balance=balance,
                               device="cpu")


def test_refusals_match_pipe_tpu():
    lane = JLanes(((0, 1),), (jax.ShapeDtypeStruct((2, WIDTH), jnp.float32),))
    kw = dict(pre_fn=None, post_fn=None)
    with pytest.raises(NotImplementedError, match="split-backward") as jerr:
        JPipeline(stage_mesh(2), None, schedule="zb-h1", skip_lanes=lane,
                  checkpoint="never", **kw)
    pipe = _skip_pipe([2, 4])
    with pytest.raises(NotImplementedError, match="split-backward") as terr:
        HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                "never", "zb-h1", device="cpu")
    assert str(terr.value) == str(jerr.value)

    def port(n, pairs, spec, **extra):
        return ScheduledPipeline(
            lambda s, h, c, p: (h, ()), lambda x, c: x, lambda h, x, c: h,
            n_stages=n, module=nn.Linear(2, 2), device="cpu",
            skip_lanes=SkipLanes(pairs, (spec,)), **extra)

    f32, i32 = torch.zeros(2), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=">=2-device") as jerr:
        JPipeline(stage_mesh(1), None, skip_lanes=lane, **kw)
    with pytest.raises(ValueError, match=">=2-device") as terr:
        port(1, ((0, 1),), f32)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="out of range"):
        port(2, ((1, 2),), f32)
    with pytest.raises(ValueError, match="out of range"):
        port(2, ((1, 0),), f32)
    bad = JLanes(((0, 1),), (jax.ShapeDtypeStruct((2,), jnp.int32),))
    with pytest.raises(NotImplementedError, match="must be float") as jerr:
        JPipeline(stage_mesh(2), None, skip_lanes=bad, **kw)
    with pytest.raises(NotImplementedError, match="must be float") as terr:
        port(2, ((0, 1),), i32)
    assert str(terr.value) == str(jerr.value)
    assert port(2, (), f32).skip_lanes is None        # empty lanes: none


def test_integer_stash_refused_at_run_time():
    """A lane without a spec learns its dtype from the first stash."""
    @tskip.skippable(stash=["i"])
    class SI(nn.Module):
        def forward(self, x, ctx=StageCtx()):
            tskip.stash("i", x.long())
            return x

    @tskip.skippable(pop=["i"])
    class PI(nn.Module):
        def forward(self, x, ctx=StageCtx()):
            return x + tskip.pop("i")

    pipe = pipe_tpu_torch.Pipe(tl.Sequential([SI(), PI()]), chunks=2,
                               n_stages=2, device="cpu")
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 2,
                                 "never", "1f1b", device="cpu")
    with pytest.raises(NotImplementedError, match="must be float"):
        ex.loss_and_grad(torch.ones(4, 2), loss_fn=lambda o: o.sum(-1))
