"""pipe_tpu_torch's Pipe, micro-batching, partitioning, schedule and data
pipeline against pipe_tpu's, and the whole slice: the tutorial LM's eval
forward and a training step's gradients through ``Pipe(chunks=4,
n_stages=2)`` with flash attention, JAX (Pallas in interpret mode) against
the port (the kernels' plain versions) from converted weights, and the
attention dropout replayed by the recompute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
from pipe_tpu.core import microbatch as jmb
from pipe_tpu.core import partition as jpart
from pipe_tpu.core import schedule as jsched
from pipe_tpu.data import lm_text as jtext
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.ops import layers as jl
from pipe_tpu_torch import convert
from pipe_tpu_torch.core import microbatch as tmb
from pipe_tpu_torch.core import partition as tpart
from pipe_tpu_torch.core import schedule as tsched
from pipe_tpu_torch.core.planner import Plan
from pipe_tpu_torch.core.remat import checkpoint_stop
from pipe_tpu_torch.data import lm_text as ttext
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops import flash_attention as tfa
from pipe_tpu_torch.ops import layers as tl


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- micro-batching --------------------------------------------------------

@pytest.mark.parametrize("batch,chunks", [(8, 4), (7, 4), (2, 4), (1, 3),
                                          (9, 2), (5, 5), (0, 3)])
def test_scatter_gather_matches_pipe_tpu(batch, chunks):
    x = np.arange(batch * 3, dtype=np.float32).reshape(batch, 3)
    jb = jmb.scatter([jnp.asarray(x)], chunks)
    tb = tmb.scatter([torch.from_numpy(x)], chunks)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.tensor.numpy(), np.asarray(b.tensor))
    np.testing.assert_array_equal(tmb.gather(tb).numpy(),
                                  np.asarray(jmb.gather(jb)))


def test_scatter_multi_input_nochunk_and_scalars():
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    w = np.ones((3,), np.float32)
    jb = jmb.scatter([jnp.asarray(x), jmb.NoChunk(jnp.asarray(w)), 5], 4)
    tb = tmb.scatter([torch.from_numpy(x), tmb.NoChunk(torch.from_numpy(w)),
                      5], 4)
    assert [len(b) for b in tb] == [len(b) for b in jb]
    for a, b in zip(tb, jb):
        assert a.replicated == b.replicated == (1, 2)
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        assert a[2] == b[2] == 5
    tx, tw, ts = tmb.gather(tb)
    np.testing.assert_array_equal(tx.numpy(), x)
    np.testing.assert_array_equal(tw.numpy(), w)
    assert ts == 5


def test_microbatch_errors_match():
    for bad in ([], [1, "a"]):
        with pytest.raises(TypeError):
            jmb.check(*bad)
        with pytest.raises(TypeError):
            tmb.check(*bad)
    with pytest.raises(ValueError):
        tmb.scatter([torch.zeros(4, 2), torch.zeros(3, 2)], 2)
    with pytest.raises(ValueError):
        tmb.scatter([torch.tensor(1.0)], 2)
    with pytest.raises(TypeError):
        tmb.NoChunk(3)


# --- partitioning and schedule ---------------------------------------------

@pytest.mark.parametrize("n_layers,n_stages,balance,costs", [
    (7, 2, None, None), (4, 3, None, None), (16, 4, None, None),
    (5, 2, [3, 2], None), (6, 3, None, [1, 1, 4, 1, 1, 1]),
    (8, 2, None, [1, 2, 3, 4, 5, 6, 7, 8])])
def test_split_balance_matches(n_layers, n_stages, balance, costs):
    assert tpart.split_balance(n_layers, n_stages, balance, costs) == \
        jpart.split_balance(n_layers, n_stages, balance, costs)


@pytest.mark.parametrize("n_layers,n_stages,balance", [
    (3, 4, None), (5, 0, None), (5, 2, [3, 3]), (5, 2, [5]),
    (5, 2, [5, 0])])
def test_split_balance_errors_match(n_layers, n_stages, balance):
    with pytest.raises(jpart.BalanceError):
        jpart.split_balance(n_layers, n_stages, balance)
    with pytest.raises(tpart.BalanceError):
        tpart.split_balance(n_layers, n_stages, balance)


@pytest.mark.parametrize("m,n", [(1, 1), (4, 2), (2, 4), (8, 4), (3, 5)])
def test_gpipe_schedule_matches(m, n):
    assert list(tsched.clock_cycles(m, n)) == list(jsched.clock_cycles(m, n))
    assert tsched.bubble_fraction(m, n) == jsched.bubble_fraction(m, n)
    t, j = tsched.GPipeSchedule(), jsched.GPipeSchedule()
    assert t.cycles(m, n) == j.cycles(m, n)
    assert t.bubble(m, n) == j.bubble(m, n)
    for a, b in zip(t.op_tables(m, n), j.op_tables(m, n)):
        np.testing.assert_array_equal(a, b)
    assert t.stash_slots(m, n) == j.stash_slots(m, n)


def test_get_schedule_names_what_is_not_ported():
    """Every schedule of pipe_tpu is registered in the port (its tables are
    held to JAX's in tests/test_torch_schedule.py); an unknown name still
    raises."""
    assert tsched.get_schedule("gpipe") == tsched.GPipeSchedule()
    assert sorted(tsched._SCHEDULES) == sorted(jsched._SCHEDULES)
    for name in jsched._SCHEDULES:
        t, j = tsched.get_schedule(name), jsched.get_schedule(name)
        assert (t.name, t.v, t.splits_backward) == \
            (j.name, j.v, j.splits_backward)
        if name == "interleaved":          # the AD executor's: no tables
            for sched in (t, j):
                with pytest.raises(NotImplementedError):
                    sched.op_tables(4, 2)
            continue
        for a, b in zip(t.op_tables(4, 2), j.op_tables(4, 2)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsched.get_schedule("nope")


def test_stage_ctx_fold_is_deterministic():
    ctx = tpart.StageCtx(seed=7)
    assert ctx.fold(1, 2).seed == ctx.fold(1, 2).seed
    assert ctx.fold(1, 2).seed != ctx.fold(2, 1).seed
    assert 0 <= ctx.fold(3).seed < 2 ** 63
    assert tpart.StageCtx().fold(1) == tpart.StageCtx()


def test_checkpoint_stop_matches():
    from pipe_tpu.core.remat import checkpoint_stop as jstop
    for mode in ("always", "except_last", "never"):
        for m in (1, 3, 4):
            for train in (True, False):
                assert checkpoint_stop(mode, m, train) == jstop(mode, m, train)


# --- Pipe front door ---------------------------------------------------------

def _jseq(n=3):
    return jl.Sequential([jl.Linear(4) for _ in range(n)])


def _tseq(n=3):
    return tl.Sequential([tl.Linear(4, 4, device="cpu") for _ in range(n)])


@pytest.mark.parametrize("probe", [
    "chunks_zero", "chunks_str", "chunks_bool", "bad_checkpoint",
    "not_sequential", "duplicate_children", "balance_sum", "too_many_stages"])
def test_pipe_fail_fast_probes_raise_the_same_types(probe):
    def make(P, seq, dup):
        return {
            "chunks_zero": lambda: P(seq(), chunks=0),
            "chunks_str": lambda: P(seq(), chunks="4"),
            "chunks_bool": lambda: P(seq(), chunks=True),
            "bad_checkpoint": lambda: P(seq(), checkpoint="sometimes"),
            "not_sequential": lambda: P([seq()[0]]),
            "duplicate_children": lambda: P(dup()),
            "balance_sum": lambda: P(seq(), n_stages=2, balance=[1, 1]),
            "too_many_stages": lambda: P(seq(), n_stages=4),
        }[probe]

    def jdup():
        layer = jl.Linear(4)
        return jl.Sequential([layer, layer])

    def tdup():
        layer = tl.Linear(4, 4, device="cpu")
        return tl.Sequential([layer, layer])

    with pytest.raises(Exception) as jerr:
        make(pipe_tpu.Pipe, _jseq, jdup)()
    with pytest.raises(Exception) as terr:
        make(lambda *a, **k: pipe_tpu_torch.Pipe(*a, device="cpu", **k),
             _tseq, tdup)()
    assert terr.type.__name__ == jerr.type.__name__


_SPLIT_PLAN = Plan(schedule="zb-h1", m=4, v=1, balance=(2, 2),
                   split_stage=True, checkpoint="never", n_devices=2,
                   mode="serialized", predicted_step_s=1.0,
                   predicted_s_per_row=0.1, predicted_peak_bytes=0,
                   phase_ok=True)


@pytest.mark.parametrize("kwargs", [{"mesh": object()},
                                    {"plan": _SPLIT_PLAN},
                                    {"mesh": object(), "schedule": "1f1b"}])
def test_pipe_refuses_what_is_not_ported(kwargs):
    """``mesh=`` is ported: it takes the port's ``Mesh`` of a world of ranks
    (tests/test_torch_mesh*.py) and refuses anything else. A plan that
    prescribes the structural B/W split is taken, with ``pipe_tpu``'s
    warning (its tables run the stored-graph split, as ``pipe_tpu``'s run
    its stored-vjp one; tests/test_torch_planner.py trains it)."""
    if "mesh" in kwargs:
        with pytest.raises(TypeError, match="make_mesh"):
            pipe_tpu_torch.Pipe(_tseq(), device="cpu", **kwargs)
        return
    with pytest.warns(UserWarning, match="structural B/W split"):
        pipe = pipe_tpu_torch.Pipe(_tseq(4), device="cpu", **kwargs)
    assert pipe.plan is kwargs["plan"]


@pytest.mark.parametrize("schedule", sorted(jsched._SCHEDULES))
def test_pipe_takes_every_schedule_as_pipe_tpu_does(schedule):
    """Without a mesh both packages' ``Pipe`` accept every registered
    schedule; the wavefront schedules give the same eval forward from the
    same weights, and the table-only ones raise the same error from
    ``cycles`` at the first forward."""
    x = np.random.default_rng(2).standard_normal((6, 4)).astype(np.float32)
    jpipe = pipe_tpu.Pipe(_jseq(4), chunks=3, n_stages=2, schedule=schedule)
    params = jpipe.init(jax.random.key(1), jnp.asarray(x))
    tpipe = pipe_tpu_torch.Pipe(_tseq(4), chunks=3, n_stages=2,
                                schedule=schedule, device="cpu")
    convert.load_stage_params(tpipe, _np(params))
    try:
        want = ("ok", np.asarray(jpipe(params, jnp.asarray(x))))
    except NotImplementedError as e:
        want = ("raise", str(e))
    try:
        with torch.no_grad():
            got = ("ok", tpipe(torch.from_numpy(x)).numpy())
    except NotImplementedError as e:
        got = ("raise", str(e))
    assert got[0] == want[0]
    if got[0] == "ok":
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    else:
        assert got[1] == want[1]


def test_pipe_container_protocol_and_default_device():
    seq = _tseq(5)
    pipe = pipe_tpu_torch.Pipe(seq, chunks=2, n_stages=2, device="cpu")
    assert pipe.balance == [3, 2] and len(pipe) == 5
    assert [id(l) for l in pipe] == [id(l) for l in seq]
    assert pipe[3] is seq[3]
    assert sum(p.numel() for p in pipe.parameters()) == \
        sum(p.numel() for p in seq.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipe_tpu_torch.Pipe(_tseq())


def test_pipe_verify_splitting_rejects_shared_parameter():
    a = tl.Linear(4, 4, device="cpu")
    b = tl.Linear(4, 4, device="cpu")
    b.weight = a.weight
    with pytest.raises(ValueError, match="duplicate parameters"):
        pipe_tpu_torch.Pipe(tl.Sequential([a, b]), n_stages=2, device="cpu")


# --- the whole slice ---------------------------------------------------------

def _corpus_batch(batch=8, seq=16):
    train, _, _ = ttext.load_corpus(n_tokens=6000, vocab_size=80, seed=1)
    vocab = ttext.Vocab(map(ttext.basic_english_tokenize, train))
    data = ttext.batchify(ttext.data_process(train, vocab), batch)
    x, y = ttext.get_batch(data, 0, seq)
    return len(vocab), x, y


def test_tutorial_lm_pipe_eval_matches_pipe_tpu():
    vocab, x, y = _corpus_batch()
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), vocab=vocab,
                               attn_impl="flash")
    jpipe = pipe_tpu.Pipe(jlm.build_sequential(jcfg), chunks=4, n_stages=2)
    params = jpipe.init(jax.random.key(0), jnp.asarray(x))
    want = jpipe(params, jnp.asarray(x), train=False)
    want_ce = float(jlm.cross_entropy(want, jnp.asarray(y)))

    tcfg = dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab,
                               attn_impl="flash")
    tpipe = pipe_tpu_torch.Pipe(tlm.build_sequential(tcfg, device="cpu"),
                                chunks=4, n_stages=2, device="cpu")
    assert tpipe.balance == jpipe.balance
    convert.load_stage_params(tpipe, _np(params))
    with torch.no_grad():
        got = tpipe(torch.from_numpy(x).long(), train=False)
        got_ce = float(tlm.cross_entropy(got, torch.from_numpy(y)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert abs(got_ce - want_ce) <= 1e-5 * abs(want_ce)


@pytest.mark.parametrize("batch,chunks,n_stages", [(8, 4, 2), (7, 4, 3),
                                                   (2, 4, 2), (8, 1, 1)])
def test_pipelined_equals_unpipelined(batch, chunks, n_stages):
    vocab, x, _ = _corpus_batch(batch=batch)
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab,
                              attn_impl="flash")
    seq = tlm.build_sequential(cfg, device="cpu")
    pipe = pipe_tpu_torch.Pipe(seq, chunks=chunks, n_stages=n_stages,
                               device="cpu")
    tokens = torch.from_numpy(x).long()
    with torch.no_grad():
        torch.testing.assert_close(pipe(tokens), seq(tokens), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
def test_training_forward_and_grads_are_transparent(checkpoint):
    # The plain attention path (dropout on the CPU takes it), dropout on:
    # remat replays each micro-batch's dropout from its seed.
    vocab, x, y = _corpus_batch()
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab,
                              attn_impl="xla", dropout=0.1)
    tokens, targets = torch.from_numpy(x).long(), torch.from_numpy(y)

    def grads(chunks, mode):
        seq = tlm.build_sequential(cfg, device="cpu")
        pipe = pipe_tpu_torch.Pipe(seq, chunks=chunks, n_stages=2,
                                   checkpoint=mode, device="cpu")
        loss = tlm.cross_entropy(pipe(tokens, train=True, seed=5), targets)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in pipe.parameters()]

    base_loss, base = grads(4, "never")
    loss, got = grads(4, checkpoint)
    assert loss == base_loss
    for a, b in zip(got, base):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _card_routing(monkeypatch):
    """Route attention as on the card (dropout included) while the tensors
    stay on the CPU, where the kernels' wrappers run their plain versions."""
    route = tl._flash_route
    monkeypatch.setattr(
        tl, "_flash_route",
        lambda impl, s, device, drop, *rest: route(
            impl, s, torch.device("cuda"), drop, *rest))


def test_flash_path_refuses_gradients():
    """The flash path takes gradients now: a training step through
    ``Pipe`` with ``attn_impl="flash"`` (the autograd Function over the
    plain versions) gives the loss and gradients of plain attention."""
    vocab, x, y = _corpus_batch()
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab)
    tokens, targets = torch.from_numpy(x).long(), torch.from_numpy(y)
    out = []
    for impl in ("flash", "xla"):
        seq = tlm.build_sequential(dataclasses.replace(cfg, attn_impl=impl),
                                   device="cpu")
        pipe = pipe_tpu_torch.Pipe(seq, chunks=2, n_stages=2, device="cpu")
        loss = tlm.cross_entropy(pipe(tokens, train=True, seed=0), targets)
        loss.backward()
        out.append((loss.item(), [p.grad for p in pipe.parameters()]))
    (lf, gf), (lx, gx) = out
    assert abs(lf - lx) <= 1e-6 * abs(lx)
    for a, b in zip(gf, gx):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_attention_route_under_dropout(impl):
    # On the card the flash route holds under dropout (the kernels drop
    # attention weights themselves); on the CPU dropout takes the plain
    # path, as Pallas interpret mode does.
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tl._flash_route(impl, 128, cuda, dropout_active=True)
    assert tl._flash_route(impl, 128, cuda, dropout_active=False)
    assert not tl._flash_route(impl, 128, cpu, dropout_active=True)
    assert tl._flash_route(impl, 128, cpu, dropout_active=False) == \
        (impl == "flash")
    assert not tl._flash_route("xla", 128, cuda, dropout_active=False)
    assert not tl._flash_route(impl, 12, cuda, dropout_active=False)


def test_flash_path_refuses_dropout_on_the_card(monkeypatch):
    """The tutorial LM trains with dropout 0.2: routed as on the card, the
    flash path takes the rate and a seed folded from the step's, and drops
    attention weights by the Philox mask of that seed — deterministic for a
    seed, different for another, and off in eval."""
    _card_routing(monkeypatch)
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), attn_impl="flash",
                              dropout=0.2)
    pipe = pipe_tpu_torch.Pipe(tlm.build_sequential(cfg, device="cpu"),
                               chunks=2, device="cpu")
    seen = []
    keep = tfa.dropout_keep
    monkeypatch.setattr(tfa, "dropout_keep",
                        lambda seed, rate, *a, **k: seen.append(rate)
                        or keep(seed, rate, *a, **k))
    tokens = torch.zeros(2, 16, dtype=torch.long)
    with torch.no_grad():
        a = pipe(tokens, train=True, seed=0)
        assert seen == [0.2] * cfg.n_layers * 2
        assert torch.equal(a, pipe(tokens, train=True, seed=0))
        assert not torch.equal(a, pipe(tokens, train=True, seed=1))
        seen.clear()
        assert torch.isfinite(pipe(tokens)).all() and not seen   # eval


def test_recompute_replays_attention_dropout(monkeypatch):
    """Under checkpoint="always" the recompute asks for the forward's masks:
    every (seed, shape) the forward draws is drawn again by the recompute
    and by the dQ and dK/dV wrappers, and the gradients equal a run that
    stores its activations (checkpoint="never")."""
    _card_routing(monkeypatch)
    vocab, x, y = _corpus_batch()
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab,
                              attn_impl="flash", dropout=0.2)
    tokens, targets = torch.from_numpy(x).long(), torch.from_numpy(y)
    keep = tfa.dropout_keep

    def run(mode):
        calls = []
        monkeypatch.setattr(
            tfa, "dropout_keep",
            lambda seed, rate, bh, s, **k: calls.append((seed, bh, s))
            or keep(seed, rate, bh, s, **k))
        pipe = pipe_tpu_torch.Pipe(tlm.build_sequential(cfg, device="cpu"),
                                   chunks=2, n_stages=2, checkpoint=mode,
                                   device="cpu")
        loss = tlm.cross_entropy(pipe(tokens, train=True, seed=9), targets)
        loss.backward()
        return calls, loss.item(), [p.grad for p in pipe.parameters()]

    calls, loss, grads = run("always")
    seeds = sorted(set(calls))
    assert len(seeds) == cfg.n_layers * 2          # layers x micro-batches
    assert sorted(calls) == sorted(seeds * 4)      # fwd, recompute, dQ, dK/dV
    base_calls, base_loss, base = run("never")
    assert sorted(set(base_calls)) == seeds
    assert loss == base_loss
    for a, b in zip(grads, base):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pallas_grads():
    """The JAX ``Pipe``'s loss and gradients of one training step through the
    Pallas kernels in interpret mode, computed once for the module: JAX's
    checkpoint modes give the same gradient (tests/test_pipe.py::
    test_gradient_transparency pins that in ``pipe_tpu``), so every port
    mode is held to the ``never`` step, the one with no recompute to
    interpret."""
    vocab, x, y = _corpus_batch()
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), vocab=vocab,
                               attn_impl="flash")
    jpipe = pipe_tpu.Pipe(jlm.build_sequential(jcfg), chunks=4, n_stages=2,
                          checkpoint="never")
    params = jpipe.init(jax.random.key(1), jnp.asarray(x))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want, jgrads = jax.value_and_grad(lambda p: jlm.cross_entropy(
        jpipe(p, jx, key=jax.random.key(2), train=True), jy))(params)
    return vocab, x, y, params, want, jgrads


@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
def test_pipe_grads_match_pipe_tpu(checkpoint, pallas_grads):
    """Loss and every parameter's gradient of a training step through the
    flash path, against the JAX ``Pipe`` on the emulator with the Pallas
    kernels in interpret mode, from converted weights (dropout 0)."""
    vocab, x, y, params, want, jgrads = pallas_grads

    tcfg = dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab,
                               attn_impl="flash")

    def port_pipe():
        return pipe_tpu_torch.Pipe(tlm.build_sequential(tcfg, device="cpu"),
                                   chunks=4, n_stages=2,
                                   checkpoint=checkpoint, device="cpu")

    tpipe, expected = port_pipe(), port_pipe()
    convert.load_stage_params(tpipe, _np(params))
    convert.load_stage_params(expected, _np(jgrads))   # grads, port layout
    got = tlm.cross_entropy(tpipe(torch.from_numpy(x).long(), train=True,
                                  seed=2), torch.from_numpy(y))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for p, g in zip(tpipe.parameters(), expected.parameters()):
        torch.testing.assert_close(p.grad, g.detach(), rtol=0, atol=1e-5)


# --- data pipeline copy ------------------------------------------------------

def test_lm_text_copy_matches():
    lines = jtext.synthetic_corpus(n_tokens=3000, vocab_size=50, seed=3)
    assert ttext.synthetic_corpus(n_tokens=3000, vocab_size=50, seed=3) == lines
    extra = ["Hello, World! It's a \"test\"; ok: (yes).", "", "  "]
    for line in lines[:20] + extra:
        assert ttext.basic_english_tokenize(line) == \
            jtext.basic_english_tokenize(line)
    jv = jtext.Vocab(map(jtext.basic_english_tokenize, lines + extra))
    tv = ttext.Vocab(map(ttext.basic_english_tokenize, lines + extra))
    assert len(tv) == len(jv)
    assert [tv.lookup_token(i) for i in range(len(tv))] == \
        [jv.lookup_token(i) for i in range(len(jv))]
    jids = jtext.data_process(lines + extra, jv)
    tids = ttext.data_process(lines + extra, tv)
    np.testing.assert_array_equal(tids, jids)
    for bsz in (4, 7):
        jd, td = jtext.batchify(jids, bsz), ttext.batchify(tids, bsz)
        np.testing.assert_array_equal(td, jd)
        assert ttext.num_batches(td, 16) == jtext.num_batches(jd, 16)
        for i in (0, 16, jd.shape[0] - 5):
            for a, b in zip(ttext.get_batch(td, i, 16),
                            jtext.get_batch(jd, i, 16)):
                np.testing.assert_array_equal(a, b)
    assert ttext.load_corpus(n_tokens=2000, vocab_size=30) == \
        jtext.load_corpus(n_tokens=2000, vocab_size=30)
