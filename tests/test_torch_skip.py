"""pipe_tpu_torch's skip subsystem (extras/skip/*) and the emulator's
tracker hook against pipe_tpu's: the cases of tests/test_skip.py run through
both packages from the same numpy inputs and converted weights.

* stash/pop through ``Pipe`` at 1, 2 and 4 stages in every checkpoint mode,
  train mode with a seed: outputs and the gradients of the input and of
  every weight within 1e-5 (the stash crosses ``torch.utils.checkpoint``
  as an explicit task input and output, so a recompute stashes nothing
  twice);
* the gradient through a skip, the ``verify_skippables`` errors (same
  type, same text), namespace isolation, ``inspect_skip_layout``, a
  same-stage skip staying local, ``isolate(only=)``, and the tracker's
  double-stash, pop-before-stash and outside-a-run errors.
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
from pipe_tpu_torch import convert
from pipe_tpu_torch.core.partition import StageCtx
from pipe_tpu_torch.extras import skip as tskip
from pipe_tpu_torch.extras.skip import tracker as ttracker
from pipe_tpu_torch.ops import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH = 4


# --- the same skippable layers in both packages ------------------------------

@jskip.skippable(stash=["skip"])
class JStash(jl.Module):
    def init(self, key, *inputs):
        return {}

    def apply(self, params, x, ctx=JCtx()):
        jskip.stash("skip", x)
        return x


@jskip.skippable(pop=["skip"])
class JPop(jl.Module):
    def init(self, key, *inputs):
        return {}

    def apply(self, params, x, ctx=JCtx()):
        return x + jskip.pop("skip")


@tskip.skippable(stash=["skip"])
class TStash(nn.Module):
    def forward(self, x, ctx=StageCtx()):
        tskip.stash("skip", x)
        return x


@tskip.skippable(pop=["skip"])
class TPop(nn.Module):
    def forward(self, x, ctx=StageCtx()):
        return x + tskip.pop("skip")


def double(x):
    return x * 2.0


def _tpipe(layers, **kw):
    return pipe_tpu_torch.Pipe(tl.Sequential(layers), device="cpu", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- stash/pop through Pipe ---------------------------------------------------

@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
def test_stash_pop_through_pipe_matches_pipe_tpu(n_stages, checkpoint):
    """[Linear, stash, tanh, Linear, pop]: the skip jumps up to 3 stages;
    outputs and gradients (input and weights) equal pipe_tpu's."""
    x = np.random.default_rng(0).standard_normal((6, WIDTH)).astype(np.float32)
    kw = dict(chunks=3, checkpoint=checkpoint, n_stages=n_stages)
    jpipe = pipe_tpu.Pipe(jl.Sequential([
        jl.Linear(WIDTH), JStash(), jl.Lambda(jnp.tanh), jl.Linear(WIDTH),
        JPop()]), **kw)
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))

    def jloss(p, xx):
        out = jpipe(p, xx, train=True, key=jax.random.key(1))
        return jnp.sum(out ** 2), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    gen = torch.Generator().manual_seed(0)
    tpipe = _tpipe([tl.Linear(WIDTH, WIDTH, device="cpu", generator=gen),
                    TStash(), tl.Lambda(torch.tanh),
                    tl.Linear(WIDTH, WIDTH, device="cpu", generator=gen),
                    TPop()], **kw)
    convert.load_stage_params(tpipe, _np(params))
    tx = torch.from_numpy(x).requires_grad_()
    out = tpipe(tx, train=True, seed=1)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    lins = [l for l in tpipe if isinstance(l, tl.Linear)]
    jlins = [p for stage in jgp for p in stage if p]
    for lin, g in zip(lins, jlins):
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   np.asarray(g["w"]).T, **TOL)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(g["b"]), **TOL)


def test_gradient_through_skip():
    jpipe = pipe_tpu.Pipe(jl.Sequential([JStash(), jl.Lambda(double),
                                         jl.Lambda(double), JPop()]),
                          chunks=2, n_stages=2, checkpoint="never")
    params = jpipe.init(jax.random.key(0), jnp.ones((4, 2)))
    jg = jax.grad(lambda x: jnp.sum(jpipe(params, x)))(jnp.ones((4, 2)))
    tpipe = _tpipe([TStash(), tl.Lambda(double), tl.Lambda(double), TPop()],
                   chunks=2, n_stages=2, checkpoint="never")
    x = torch.ones(4, 2, requires_grad=True)
    tpipe(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg))
    np.testing.assert_allclose(x.grad.numpy(), 5.0)


# --- verify_skippables --------------------------------------------------------

@pytest.mark.parametrize("case", ["popped before", "never popped",
                                  "stashed twice"])
def test_verify_errors_match_pipe_tpu(case):
    make = {"popped before": lambda S, P, L: [P(), S()],
            "never popped": lambda S, P, L: [S(), L(double)],
            "stashed twice": lambda S, P, L: [S(), S(), P(), P()]}[case]
    with pytest.raises(TypeError, match=case) as jerr:
        jskip.verify_skippables(jl.Sequential(make(JStash, JPop, jl.Lambda)))
    with pytest.raises(TypeError, match=case) as terr:
        tskip.verify_skippables(tl.Sequential(make(TStash, TPop, tl.Lambda)))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match=case):       # Pipe checks at build
        _tpipe(make(TStash, TPop, tl.Lambda))


# --- namespaces -----------------------------------------------------------------

@pytest.mark.parametrize("order,n_stages", [("nested", 4), ("crossed", 2)])
def test_namespace_isolation_matches_pipe_tpu(order, n_stages):
    """Two instances of one class, isolated, with bare stash/pop calls."""
    def layers(S, P, ns1, ns2):
        pops = ([P().isolate(ns2), P().isolate(ns1)] if order == "nested"
                else [P().isolate(ns1), P().isolate(ns2)])
        return [S().isolate(ns1), S().isolate(ns2), *pops]

    x = np.ones((4, 2), np.float32)
    jmod = jl.Sequential(layers(JStash, JPop, jskip.Namespace(),
                                jskip.Namespace()))
    jskip.verify_skippables(jmod)
    jpipe = pipe_tpu.Pipe(jmod, chunks=2, n_stages=n_stages)
    jout = jpipe(jpipe.init(jax.random.key(0), jnp.asarray(x)),
                 jnp.asarray(x), train=True, key=jax.random.key(1))
    tpipe = _tpipe(layers(TStash, TPop, tskip.Namespace(), tskip.Namespace()),
                   chunks=2, n_stages=n_stages)
    tout = tpipe(torch.from_numpy(x), train=True, seed=1)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout))
    np.testing.assert_allclose(tout.numpy(), 3.0)


def test_isolate_only_keeps_other_names():
    """isolate(ns, only=[...]) moves only the listed names into ns."""
    ns = tskip.Namespace()

    @tskip.skippable(stash=["a", "b"])
    class S2(nn.Module):
        def forward(self, x, ctx=StageCtx()):
            tskip.stash("a", x)
            tskip.stash("b", 2 * x)
            return x

    iso = S2().isolate(ns, only=["a"])
    assert iso._stash_names == ("a", "b")  # names survive
    assert iso.ns_of("a") is ns
    assert iso.ns_of("b") is not ns
    assert {(n is ns, name) for n, name in iso.stashes} == {
        (True, "a"), (False, "b")}


# --- layout -----------------------------------------------------------------------

def _layout_facts(layout):
    names = {k: [n for _, n in v] for k, v in layout.by_src_dst}
    return (layout.n_stages, names, layout.num_skips, layout.max_hop(),
            [(s, n) for s, _, n in layout.copy_policy(3)],
            [n for _, n in layout.stashes_of(0)],
            [n for _, n in layout.pops_of(3)])


@pytest.mark.parametrize("n_stages", [1, 4])
def test_inspect_skip_layout_matches_pipe_tpu(n_stages):
    jpipe = pipe_tpu.Pipe(jl.Sequential([JStash(), jl.Lambda(double),
                                         jl.Lambda(double), JPop()]),
                          chunks=1, n_stages=n_stages)
    tpipe = _tpipe([TStash(), tl.Lambda(double), tl.Lambda(double), TPop()],
                   chunks=1, n_stages=n_stages)
    assert _layout_facts(tpipe.skip_layout) == _layout_facts(jpipe.skip_layout)
    layout = tpipe.skip_layout
    assert layout.num_skips == 1
    if n_stages == 4:
        assert layout.requires_copy(0, 3) and layout.max_hop() == 3
        assert layout.stashes_of(0) and layout.pops_of(3)
    else:
        # a same-stage skip stays inside the stage: nothing is exported
        assert layout.stashes_of(0) == () and layout.pops_of(0) == ()
        x = torch.ones(4, 2)
        np.testing.assert_allclose(tpipe(x).numpy(), 5.0)


# --- the tracker -------------------------------------------------------------------

def test_tracker_double_stash_raises():
    t = tskip.SkipTracker()
    with t.scope(0, 0):
        tskip.stash("a", torch.ones(2))
        with pytest.raises(RuntimeError, match="stashed twice"):
            tskip.stash("a", torch.ones(2))


def test_pop_without_stash_raises():
    t = tskip.SkipTracker()
    with t.scope(0, 0):
        with pytest.raises(RuntimeError, match="popped before stash"):
            tskip.pop("nothing")


def test_stash_outside_run_raises():
    with pytest.raises(RuntimeError, match="outside a pipeline run"):
        tskip.stash("a", torch.ones(2))


def test_accumulate_detaches_and_adds():
    """``accumulate`` is a no-op outside a run; inside, dicts of tensors add
    up, detached (pipe_tpu's ``stop_gradient``)."""
    ns = tskip.Namespace()
    assert ttracker.accumulate(ns, "s", {"a": torch.ones(2)}) is False
    t = tskip.SkipTracker()
    w = torch.ones(2, requires_grad=True)
    with tskip.use_skip_tracker(t):
        assert ttracker.accumulate(ns, "s", {"a": 2 * w})
        assert ttracker.accumulate(ns, "s", {"a": 3 * w})
    got = t.accum[(ns, "s")]["a"]
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), 5.0)
