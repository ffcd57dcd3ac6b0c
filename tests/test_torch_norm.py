"""pipe_tpu_torch's deferred BatchNorm (extras/norm.py) against pipe_tpu's,
through the emulator ``Pipe`` and through the one-device table executor.

* The emulator cases of tests/test_norm.py, both packages from converted
  weights and the same numpy batch: running stats after one train step equal
  one whole-batch momentum update and pipe_tpu's new params (buffers within
  rtol 1e-5 / atol 1e-6) for chunks x checkpoint, with the outputs and
  gradients (rtol 1e-4 / atol 1e-5); chunks invariance; eval on the running stats; the
  per-micro-batch train normalization; ``convert`` replacing only plain BN;
  momentum over steps.
* The table-executor cases of tests/test_norm.py: the port's
  ``HeteroScheduledPipeline`` (gpipe, 1f1b) against pipe_tpu's
  ``Pipe(mesh=stage_mesh(2), deferred_batch_norm=True).loss_and_grad`` in
  every checkpoint mode: loss within 1e-5 relative, gradients within rtol
  1e-4 / atol 1e-6, committed stats within rtol 1e-5 / atol 1e-6. The
  padded-row refusal; the zb-h1 refusal. The data-axis case belongs to the
  multi-device executors (ROADMAP.md: A.8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
from pipe_tpu.extras import norm as jnorm
from pipe_tpu.ops import layers as jl
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu_torch import convert
from pipe_tpu_torch.extras import norm as tnorm
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

STATS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
# The Linear before a BN has a bias gradient of zero in exact arithmetic
# (BN removes the mean); in float32 it is rounding noise of ~1e-6, so the
# emulator comparison takes tests/test_norm.py's interleaved atol, 1e-5.
GRADS_EMU = dict(rtol=1e-4, atol=1e-5)
W = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(rows=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, W)).astype(np.float32),
            rng.standard_normal((rows, 3)).astype(np.float32))


def _tlinear(i, o, gen):
    return tl.Linear(i, o, device="cpu", generator=gen)


def _pair_lin_bn(**kw):
    """[Linear(6), BatchNorm] in both packages (port weights unconverted)."""
    gen = torch.Generator().manual_seed(0)
    jmod = jl.Sequential([jl.Linear(W), jnorm.BatchNorm()])
    tmod = tl.Sequential([_tlinear(W, W, gen), tnorm.BatchNorm(W,
                                                                device="cpu")])
    return jmod, tmod


def _check_named(got: dict, want: dict, tol, what=""):
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, **tol,
                                   err_msg=f"{what} {name}")


def whole_batch_reference_stats(h, momentum=0.1):
    """One torch-style BN update from the full mini-batch."""
    n = h.shape[0]
    mean, var = h.mean(axis=0), h.var(axis=0)
    return momentum * mean, (1 - momentum) + momentum * var * n / (n - 1)


# --- the emulator ---------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("checkpoint", ["never", "always"])
def test_running_stats_match_whole_batch_and_pipe_tpu(chunks, checkpoint):
    x, _ = _data()
    jmod, tmod = _pair_lin_bn()
    kw = dict(chunks=chunks, checkpoint=checkpoint, n_stages=2,
              deferred_batch_norm=True)
    jpipe = pipe_tpu.Pipe(jmod, **kw)
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))

    # a fixed random projection: sum(out ** 2) of a normalized output is
    # nearly constant in the weights, and its gradient is rounding noise
    r = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        out, new = jpipe(p, jnp.asarray(x), train=True, key=jax.random.key(2))
        return jnp.sum(out * r), (out, new)

    (_, (jout, jnew)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    tpipe = pipe_tpu_torch.Pipe(tmod, device="cpu", **kw)
    convert.load_stage_params(tpipe, _np(params))
    out = tpipe(torch.from_numpy(x), train=True, seed=2)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    want = convert.stage_arrays(tpipe, _np(jnew))
    bufs = {n: b.numpy() for n, b in tpipe.named_buffers()}
    _check_named(bufs, {n: want[n] for n in bufs}, STATS, "stats")
    grads = {n: p.grad.numpy() for n, p in tpipe.named_parameters()}
    wantg = convert.stage_arrays(tpipe, _np(jgrads))
    _check_named(grads, {n: wantg[n] for n in grads}, GRADS_EMU, "grad")
    # the whole-batch update, from the Linear's output
    lin = tpipe[0]
    h = (torch.from_numpy(x) @ lin.weight.T + lin.bias).detach().numpy()
    exp_mean, exp_var = whole_batch_reference_stats(h)
    bn = tpipe[1]
    assert isinstance(bn, tnorm.DeferredBatchNorm)
    np.testing.assert_allclose(bn.mean.numpy(), exp_mean, **STATS)
    np.testing.assert_allclose(bn.var.numpy(), exp_var, **STATS)


def test_chunks_invariance():
    """Stats identical whether the batch ran as 1, 2, or 4 micro-batches."""
    x, _ = _data()
    results = []
    for chunks in (1, 2, 4):
        _, tmod = _pair_lin_bn()
        pipe = pipe_tpu_torch.Pipe(tmod, chunks=chunks, n_stages=2,
                                   deferred_batch_norm=True, device="cpu")
        pipe(torch.from_numpy(x), train=True)
        results.append((pipe[1].mean.clone(), pipe[1].var.clone()))
    for mean, var in results[1:]:
        torch.testing.assert_close(mean, results[0][0], **STATS)
        torch.testing.assert_close(var, results[0][1], **STATS)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_single_bn_forward_matches_pipe_tpu(train):
    """Eval normalizes by the running stats (init: the identity); a train
    forward by each micro-batch's own statistics (biased variance)."""
    x = (np.random.default_rng(1).standard_normal((8, 4)) * 5.0 + 1.0
         ).astype(np.float32)
    jpipe = pipe_tpu.Pipe(jl.Sequential([jnorm.BatchNorm()]), chunks=2,
                          n_stages=1, deferred_batch_norm=True)
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))
    jout = jpipe(params, jnp.asarray(x), train=train)
    jout = jout[0] if train else jout
    tpipe = pipe_tpu_torch.Pipe(tl.Sequential([tnorm.BatchNorm(
        4, device="cpu")]), chunks=2, deferred_batch_norm=True, device="cpu")
    with torch.no_grad():
        out = tpipe(torch.from_numpy(x), train=train).numpy()
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)
    if not train:
        np.testing.assert_allclose(out, x, rtol=1e-4, atol=1e-4)
        assert float(tpipe[0].mean.abs().max()) == 0.0     # no commit
    else:
        for half in (out[:4], out[4:]):
            np.testing.assert_allclose(half.mean(axis=0), 0.0, atol=1e-5)
            np.testing.assert_allclose(half.var(axis=0), 1.0, atol=1e-3)


def test_convert_replaces_only_plain_bn():
    gen = torch.Generator().manual_seed(0)
    bn = tnorm.BatchNorm(4, device="cpu")
    module = tl.Sequential([_tlinear(4, 4, gen), bn,
                            tl.Lambda(lambda x: x * 2)])
    converted = tnorm.convert_deferred_batch_norm(module, chunks=4)
    kinds = [type(l).__name__ for l in converted]
    jkinds = [type(l).__name__ for l in jnorm.convert_deferred_batch_norm(
        jl.Sequential([jl.Linear(4), jnorm.BatchNorm(),
                       jl.Lambda(lambda x: x * 2)]), chunks=4)]
    assert kinds == jkinds == ["Linear", "DeferredBatchNorm", "Lambda"]
    d = converted[1]
    assert d.scale is bn.scale and d.bias is bn.bias       # shared weights
    assert d.mean is bn.mean and d.var is bn.var           # and stats
    again = tnorm.convert_deferred_batch_norm(converted, chunks=4)
    assert again[1] is d                                   # already deferred


def test_momentum_accumulates_over_steps():
    """Two train steps move stats twice (one commit per mini-batch each)."""
    x = np.full((8, 4), 2.0, np.float32)
    jpipe = pipe_tpu.Pipe(jl.Sequential([jnorm.BatchNorm()]), chunks=2,
                          n_stages=1, deferred_batch_norm=True)
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))
    _, p1 = jpipe(params, jnp.asarray(x), train=True)
    _, p2 = jpipe(p1, jnp.asarray(x), train=True)
    tpipe = pipe_tpu_torch.Pipe(tl.Sequential([tnorm.BatchNorm(
        4, device="cpu")]), chunks=2, deferred_batch_norm=True, device="cpu")
    got = []
    for _ in range(2):
        tpipe(torch.from_numpy(x), train=True)
        got.append(tpipe[0].mean.clone().numpy())
    for g, jp, want in zip(got, (p1, p2), (0.2, 0.38)):
        np.testing.assert_allclose(g, np.asarray(jp[0][0]["mean"]), **STATS)
        np.testing.assert_allclose(g, want, atol=1e-6)


# --- the table executor -------------------------------------------------------------

def _stage_mesh(n_stages):
    return make_mesh(n_stages, 1, devices=jax.devices()[:n_stages])


def _bn_stack():
    gen = torch.Generator().manual_seed(0)
    jmod = jl.Sequential([jl.Linear(W), jnorm.BatchNorm(), jl.Linear(W),
                          jnorm.BatchNorm(), jl.Linear(3)])
    tmod = tl.Sequential([_tlinear(W, W, gen), tnorm.BatchNorm(W, device="cpu"),
                          _tlinear(W, W, gen), tnorm.BatchNorm(W, device="cpu"),
                          _tlinear(W, 3, gen)])
    return jmod, tmod


def jloss_fn(out, tgt):
    return jnp.sum((out - tgt) ** 2, axis=-1)


def tloss_fn(out, tgt):
    return ((out - tgt) ** 2).sum(-1)


_JAX_TABLE = {}


def jax_table_step(schedule, checkpoint):
    """pipe_tpu's mesh ``Pipe`` step once per key: ``(params, loss, grads,
    new params)`` as per-stage numpy trees."""
    key = (schedule, checkpoint)
    if key not in _JAX_TABLE:
        x, y = _data()
        jmod, _ = _bn_stack()
        pipe = pipe_tpu.Pipe(jmod, chunks=4, checkpoint=checkpoint,
                             mesh=_stage_mesh(2), schedule=schedule,
                             deferred_batch_norm=True)
        params = pipe.init(jax.random.key(0), jnp.asarray(x))
        packed = pipe.shard_params(params)
        loss, grads, new = jax.jit(lambda p: pipe.loss_and_grad(
            p, jnp.asarray(x), targets=jnp.asarray(y),
            loss_fn=jloss_fn))(packed)
        _JAX_TABLE[key] = (_np(params), float(loss),
                           _np(pipe.unshard_grads(grads)),
                           _np(pipe.unshard_params(new)))
    return _JAX_TABLE[key]


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
def test_table_executor_bn_matches_pipe_tpu(schedule, checkpoint):
    """Loss, gradients and committed running stats of one step equal
    pipe_tpu's mesh table executor; stats count FWD ops only, so no
    checkpoint mode counts a recompute."""
    params, want_loss, want_grads, want_new = jax_table_step(schedule,
                                                             checkpoint)
    x, y = _data()
    _, tmod = _bn_stack()
    pipe = pipe_tpu_torch.Pipe(tmod, chunks=4, checkpoint=checkpoint,
                               n_stages=2, deferred_batch_norm=True,
                               device="cpu")
    convert.load_stage_params(pipe, params)
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 4,
                                 checkpoint, schedule, device="cpu")
    loss, grads = ex.loss_and_grad(torch.from_numpy(x),
                                   targets=torch.from_numpy(y),
                                   loss_fn=tloss_fn)
    assert loss.item() == pytest.approx(want_loss, rel=1e-5)
    got = {n: p.grad.numpy() for n, p in pipe.named_parameters()}
    wantg = convert.stage_arrays(pipe, want_grads)
    _check_named(got, {n: wantg[n] for n in got}, GRADS, "grad")
    assert len(grads) == len(got)
    new = convert.stage_arrays(pipe, want_new)
    bufs = {n: b.numpy() for n, b in pipe.named_buffers()}
    _check_named(bufs, {n: new[n] for n in bufs}, STATS, "stats")


def test_table_executor_bn_train_forward_commits_like_the_emulator():
    """The FWD-only walk of a train forward counts each micro-batch once:
    its outputs and committed stats equal the emulator ``Pipe``'s."""
    x, _ = _data()
    outs, stats = [], []
    for table in (False, True):
        _, tmod = _bn_stack()
        pipe = pipe_tpu_torch.Pipe(tmod, chunks=4, n_stages=2,
                                   deferred_batch_norm=True, device="cpu")
        with torch.no_grad():
            if table:
                out = HeteroScheduledPipeline(
                    pipe.partitions, pipe.skip_layout, 4, "except_last",
                    "1f1b", device="cpu").forward(torch.from_numpy(x),
                                                  train=True)
            else:
                out = pipe(torch.from_numpy(x), train=True)
        outs.append(out)
        stats.append([b.clone() for b in pipe.buffers()])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(*stats):
        torch.testing.assert_close(a, b, **STATS)


def test_table_executor_bn_rejects_padded_rows():
    """chunks=2 over 7 rows pads a micro-batch: padded rows would enter the
    statistics, so both packages refuse."""
    x, y = _data(rows=7)
    jmod, tmod = _bn_stack()
    jpipe = pipe_tpu.Pipe(jmod, chunks=2, checkpoint="never",
                          mesh=_stage_mesh(2), schedule="1f1b",
                          deferred_batch_norm=True)
    packed = jpipe.shard_params(jpipe.init(jax.random.key(0),
                                           jnp.asarray(x)))
    with pytest.raises(ValueError, match="divide") as jerr:
        jpipe.loss_and_grad(packed, jnp.asarray(x), targets=jnp.asarray(y),
                            loss_fn=jloss_fn)
    pipe = pipe_tpu_torch.Pipe(tmod, chunks=2, n_stages=2,
                               deferred_batch_norm=True, device="cpu")
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 2,
                                 "never", "1f1b", device="cpu")
    with pytest.raises(ValueError, match="divide") as terr:
        ex.loss_and_grad(torch.from_numpy(x), targets=torch.from_numpy(y),
                         loss_fn=tloss_fn)
    assert str(terr.value) == str(jerr.value)


def test_zb_h1_refused_with_pipe_tpu_text():
    jmod, tmod = _bn_stack()
    with pytest.raises(NotImplementedError, match="zb-h1") as jerr:
        pipe_tpu.Pipe(jmod, chunks=2, mesh=_stage_mesh(2),
                      deferred_batch_norm=True, schedule="zb-h1")
    with pytest.raises(NotImplementedError, match="zb-h1") as terr:
        pipe_tpu_torch.Pipe(tmod, chunks=2, n_stages=2, schedule="zb-h1",
                            deferred_batch_norm=True, device="cpu")
    assert str(terr.value) == str(jerr.value)
    pipe = pipe_tpu_torch.Pipe(tmod, chunks=2, n_stages=2,
                               deferred_batch_norm=True, device="cpu")
    with pytest.raises(NotImplementedError, match="stat lanes"):
        HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 2,
                                "never", "zb-h1", device="cpu")
    with pytest.raises(NotImplementedError, match="stat lanes"):
        ScheduledPipeline(lambda s, h, c: (h, {}), lambda x, c: x,
                          lambda h, x, c: h, n_stages=2, module=tmod,
                          checkpoint="never", schedule="zb-h1",
                          stat_spec={}, device="cpu")
