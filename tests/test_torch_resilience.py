"""pipe_tpu_torch's guarded training step, rewind and retry (the train half
of ``resilience/*``) against pipe_tpu's: ``step_guard``'s verdicts and EWMA,
the controller's rewind/backoff/abort and ``RetryingIterator``'s resume and
cap under a fake clock (tests/test_resilience.py's laws, on both packages),
``ChaosPlan`` and the fault arithmetic, and a tiny ``Trainer`` with a
``ChaosPlan`` that skips, rewinds and retries at the steps pipe_tpu's does,
from pipe_tpu's weights, with its losses within fp32 tolerance (dropout 0).
The guard without faults is bitwise the plain step; a skipped step leaves
the parameters, both Adam moments and Adam's step count bitwise as they
were; a SIGTERM autosave resumes bitwise. One deliberate difference
(ROADMAP.md C.10): an empty loss EWMA past warm-up is seeded, where
pipe_tpu's guard calls every loss a spike and aborts the epoch.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.obs.events import NULL_EVENT_LOG as JNULL
from pipe_tpu.obs.telemetry import get_registry as jget_registry
from pipe_tpu.resilience import chaos as jchaos
from pipe_tpu.resilience import detect as jdetect
from pipe_tpu.resilience import recover as jrecover
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import convert
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.events import NULL_EVENT_LOG, EventLog
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.resilience import chaos as tchaos
from pipe_tpu_torch.resilience import detect as tdetect
from pipe_tpu_torch.resilience import recover as trecover
from pipe_tpu_torch.train import loop as tloop
from pipe_tpu_torch.train import state as tstate

# tests/test_resilience.py's model, trainer and resilience config (the spike
# check armed from step 1, for the loss_spike case)
CFG = dict(vocab=67, d_model=16, nhead=2, d_ff=32, n_layers=4, seq_len=32,
           dropout=0.0, attn_impl="xla")
TC = dict(batch_size=8, bptt=16, chunks=2, n_stages=2, checkpoint="never",
          lr=0.01)
RC = dict(warmup_steps=1, rewind_after=2, snapshot_every=2,
          data_backoff_s=0.0, rewind_backoff_s=0.0)


# --- detection ---------------------------------------------------------------

_GUARD_CASES = [  # (loss, grads, ewma, step)
    (2.0, [1.0, 1.0, 1.0], 0.0, 0),          # seeds the EWMA
    (float("nan"), [1.0, 1.0, 1.0], 2.0, 5),  # non-finite loss
    (2.0, [1.0, float("inf"), 0.0], 2.0, 5),  # non-finite grads
    (100.0, [1.0, 1.0, 1.0], 2.0, 5),         # spike past warm-up
    (100.0, [1.0, 1.0, 1.0], 2.0, 1),         # warm-up disarms the spike
    (2.5, [0.5, -0.25, 3.0], 2.0, 5),         # accepted: the EWMA folds
    (float("inf"), [float("nan")] * 3, 0.0, 0),
]


@pytest.mark.parametrize("case", range(len(_GUARD_CASES)))
@pytest.mark.parametrize("step_as_tensor", [False, True])
def test_step_guard_matches_pipe_tpu(case, step_as_tensor):
    loss, grads, ewma, step = _GUARD_CASES[case]
    kw = dict(spike_factor=4.0, warmup_steps=2, ewma_alpha=0.3)
    jok, jewma = jdetect.step_guard(
        jnp.float32(loss), {"w": jnp.asarray(grads, jnp.float32)},
        jnp.float32(ewma), jnp.int32(step), **kw)
    g = torch.tensor(grads)
    tstep = torch.tensor(step, dtype=torch.int32) if step_as_tensor else step
    ok, new = tdetect.step_guard(torch.tensor(loss), [g], torch.tensor(ewma),
                                 tstep, **kw)
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jewma))
    # the trainer hands in the norm its clip computed: the same verdict
    ok2, new2 = tdetect.step_guard(torch.tensor(loss), None,
                                   torch.tensor(ewma), tstep, **kw,
                                   gnorm=tdetect.global_norm([g]))
    assert bool(ok2) == bool(ok) and torch.equal(new2, new)


@pytest.mark.parametrize("step", [5, 50])
def test_step_guard_seeds_an_empty_ewma_past_warm_up(step):
    """A deliberate difference (ROADMAP.md C.10): with an empty EWMA past
    warm-up, pipe_tpu's guard calls any positive loss a spike; the port's
    seeds the EWMA with it."""
    kw = dict(spike_factor=4.0, warmup_steps=2, ewma_alpha=0.3)
    jok, jewma = jdetect.step_guard(
        jnp.float32(3.0), {"w": jnp.ones(3, jnp.float32)}, jnp.float32(0.0),
        jnp.int32(step), **kw)
    ok, new = tdetect.step_guard(torch.tensor(3.0), [torch.ones(3)],
                                 torch.tensor(0.0), step, **kw)
    assert not bool(jok) and float(jewma) == 0.0
    assert bool(ok) and float(new) == 3.0


def test_stage_heartbeat_matches_pipe_tpu():
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((3, 4, 5)).astype(np.float32),
             rng.standard_normal((3, 7)).astype(np.float32)]
    grads[0][0] = 0.0
    grads[1][0] = 0.0
    want = jdetect.stage_heartbeat({"a": grads[0], "b": grads[1]}, 3)
    got = tdetect.stage_heartbeat([torch.from_numpy(g) for g in grads], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got[0] == 0.0


# --- recovery (controller + iterator), both packages ------------------------

def _aux(pkg, consec, total, ewma=1.0):
    if pkg == "jax":
        return (jnp.float32(ewma), jnp.int32(consec), jnp.int32(total))
    return (torch.tensor(ewma), torch.tensor(consec, dtype=torch.int32),
            torch.tensor(total, dtype=torch.int32))


def _w(pkg, values):
    return {"w": jnp.asarray(values) if pkg == "jax"
            else torch.tensor(values)}


def _controller(pkg, cfg, **kw):
    if pkg == "jax":
        return jrecover.ResilienceController(
            jrecover.ResilienceConfig(**cfg), jget_registry(), JNULL, **kw)
    return trecover.ResilienceController(
        trecover.ResilienceConfig(**cfg), get_registry(), NULL_EVENT_LOG,
        **kw)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_controller_rewinds_then_aborts(pkg):
    slept = []
    ctl = _controller(pkg, dict(rewind_after=1, max_rewinds=1,
                                snapshot_every=1, warmup_steps=100),
                      log_fn=lambda s: None, sleep=slept.append)
    good = _w(pkg, [0.0, 1.0, 2.0])
    state, aux = ctl.after_step(0, good, _aux(pkg, 0, 0))     # snapshots
    if pkg == "torch":
        good["w"].fill_(7.0)          # the live tensor moves on; the
    assert ctl.anomalies == 0         # snapshot is a copy
    nan = [float("nan")] * 3
    state, aux = ctl.after_step(1, _w(pkg, nan), _aux(pkg, 1, 1))
    assert ctl.rewinds == 1 and ctl.anomalies == 1
    assert np.array_equal(np.asarray(state["w"]), [0.0, 1.0, 2.0])
    assert int(aux[1]) == 0 and int(aux[2]) == 1
    with pytest.raises((jrecover.TrainingAborted, trecover.TrainingAborted),
                       match="after 1 rewinds"):
        ctl.after_step(2, _w(pkg, nan), _aux(pkg, 1, 2))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_controller_aborts_without_snapshot(pkg):
    ctl = _controller(pkg, dict(rewind_after=1, warmup_steps=100),
                      log_fn=lambda s: None)
    with pytest.raises((jrecover.TrainingAborted, trecover.TrainingAborted),
                       match="no known-good snapshot"):
        ctl.after_step(0, _w(pkg, [0.0, 0.0]), _aux(pkg, 1, 1))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_controller_rewind_backoffs_double_and_pin_oldest_snapshot(pkg):
    slept, lines = [], []
    ctl = _controller(pkg, dict(rewind_after=1, max_rewinds=3,
                                snapshot_every=100, warmup_steps=100,
                                rewind_backoff_s=0.5),
                      log_fn=lines.append, sleep=slept.append)
    ctl.after_step(0, _w(pkg, [0.0, 1.0, 2.0]), _aux(pkg, 0, 0))
    for k in range(3):
        state, _ = ctl.after_step(k + 1, _w(pkg, [float("nan")] * 3),
                                  _aux(pkg, 1, k + 1))
        assert np.array_equal(np.asarray(state["w"]), [0.0, 1.0, 2.0])
    assert ctl.rewinds == 3 and all("snapshot of step 0" in l for l in lines)
    assert slept == [0.5 * 2 ** k for k in range(3)]
    with pytest.raises((jrecover.TrainingAborted, trecover.TrainingAborted),
                       match="after 3 rewinds"):
        ctl.after_step(4, _w(pkg, [float("nan")] * 3), _aux(pkg, 1, 4))


def _flaky(fails):
    def factory(pos):
        def gen():
            if fails["left"] > 0:
                fails["left"] -= 1
                raise tchaos.ChaosError("flaky source")
            yield from range(pos, 3)
        return gen()
    return factory


@pytest.mark.parametrize("left,delivers", [(2, True), (3, False)])
def test_retrying_iterator_cap_matches_pipe_tpu(left, delivers):
    """``retries`` failures are survived; one more aborts, even though the
    next rebuild would have delivered."""
    outcomes = []
    for make in (jrecover.RetryingIterator, trecover.RetryingIterator):
        fails = {"left": left}
        it = make(_flaky(fails), retries=2, backoff_s=0.0,
                  sleep=lambda s: None)
        try:
            outcomes.append(list(it))
        except (jrecover.DataIteratorFailed,
                trecover.DataIteratorFailed) as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] == [0, 1, 2]) == delivers


def test_retrying_iterator_resumes_at_position_and_backs_off():
    fails = {2: 1}

    def factory(pos):
        def gen():
            for i in range(pos, 5):
                if fails.get(i, 0) > 0:
                    fails[i] -= 1
                    raise tchaos.ChaosError(f"boom at {i}")
                yield i
        return gen()

    it = trecover.RetryingIterator(factory, retries=2, backoff_s=0.0,
                                   sleep=lambda s: None, start=1)
    assert list(it) == [1, 2, 3, 4]
    slept = []

    def never(pos):
        def gen():
            raise tchaos.ChaosError("always")
            yield  # pragma: no cover
        return gen()

    with pytest.raises(trecover.DataIteratorFailed, match="failed 4 times"):
        next(trecover.RetryingIterator(never, retries=3, backoff_s=0.25,
                                       sleep=slept.append))
    assert slept == [0.25 * 2 ** k for k in range(3)]


def test_resilience_config_validates_as_pipe_tpu():
    assert dataclasses.asdict(trecover.ResilienceConfig()) == \
        dataclasses.asdict(jrecover.ResilienceConfig())
    for bad in (dict(spike_factor=1.0), dict(check_every=0),
                dict(max_rewinds=-1)):
        with pytest.raises(ValueError):
            trecover.ResilienceConfig(**bad)


# --- chaos ---------------------------------------------------------------

def _plan(pkg, *faults):
    mod = jchaos if pkg == "jax" else tchaos
    return mod.ChaosPlan([mod.Fault(*f[:2], **f[2]) for f in faults],
                         seed=3)


def test_chaos_plan_matches_pipe_tpu():
    faults = [("nan_grads", 3, {}), ("loss_spike", 5, dict(magnitude=50.0)),
              ("data_raise", 6, dict(count=2)),
              ("inf_grads", 8, dict(count=3)),
              ("nan_activations", 12, {}), ("stall_tick", 2, {}),
              ("wire_dup", 1, dict(stage=1))]
    j, t = _plan("jax", *faults), _plan("torch", *faults)
    assert repr(t) == repr(j) and bool(t)
    for step in range(16):
        assert t.train_inject(step) == j.train_inject(step)
        for kind in ("nan_grads", "data_raise", "stall_tick"):
            assert repr(t.active(kind, step)) == repr(j.active(kind, step))
    assert t.last_train_fault_step() == j.last_train_fault_step()
    assert repr(t.without("data_raise")) == repr(j.without("data_raise"))
    assert tchaos.KINDS == jchaos.KINDS
    for bad in (dict(kind="nope", step=0), dict(kind="nan_grads", step=-1),
                dict(kind="nan_grads", step=0, count=0)):
        with pytest.raises(ValueError):
            tchaos.Fault(**bad)
    with pytest.raises(tchaos.ChaosError):
        t.maybe_raise_data(6)
    t.maybe_raise_data(5)


@pytest.mark.parametrize("call", [
    lambda p: p.transport_fault(0, 0),
    lambda p: p.wire_fault("wire_dup", 0),
    lambda p: p.serve_fault("stall_tick", 0),
    lambda p: p.replica_fault("kill_replica", 0, 0),
    lambda p: [p.train_kill(b) for b in range(4)],
], ids=["transport", "wire", "serve", "replica", "train_kill"])
def test_fault_hooks_answer_as_pipe_tpus(call):
    """Every lookup answers as ``pipe_tpu``'s does for the same plan, the
    elastic channel too: ``train_kill`` is permanent from its step on."""
    plan = [jchaos.Fault("kill_replica", 0), jchaos.Fault("wire_dup", 0),
            jchaos.Fault("stall_tick", 0), jchaos.Fault("transport_drop", 0),
            jchaos.Fault("kill_stage", 2, stage=1)]
    tplan = tchaos.ChaosPlan([tchaos.Fault(f.kind, f.step, stage=f.stage)
                              for f in plan])
    assert repr(call(tplan)) == repr(call(jchaos.ChaosPlan(plan)))
    assert repr(call(tchaos.ChaosPlan([]))) == repr(call(
        jchaos.ChaosPlan([])))
    assert tplan.without("kill_stage").train_kill(9) == tchaos.KILL_NONE


def test_trainer_takes_a_kill_stage_plan(source):
    """A ``kill_stage`` fault fires only in the elastic step: the guarded
    trainer without ``elastic`` takes the plan and trains as with none,
    as ``pipe_tpu``'s does (its kill code reaches no stage)."""
    rc = trecover.ResilienceConfig(warmup_steps=100)
    runs = []
    for chaos in (tchaos.ChaosPlan([]),
                  tchaos.ChaosPlan([tchaos.Fault("kill_stage", 1)])):
        tr = tloop.Trainer(tlm.LMConfig(**CFG), tloop.TrainerConfig(
            resilience=rc, **TC), device="cpu", chaos=chaos)
        _, info = tr.train_epoch(source, max_steps=3, log_every=0)
        runs.append(info["losses"])
    assert runs[1] == runs[0]


@pytest.mark.parametrize("code", range(6))
def test_apply_train_faults_matches_pipe_tpu(code):
    rng = np.random.default_rng(code)
    g = rng.standard_normal((3, 4)).astype(np.float32)
    jloss, jgrads = jchaos.apply_train_faults(
        jnp.int32(code), jnp.float32(7.5), jnp.float32(2.25),
        {"g": jnp.asarray(g)})
    tg = torch.from_numpy(g.copy())
    loss, grads = tchaos.apply_train_faults(
        torch.tensor(code, dtype=torch.int32), torch.tensor(7.5),
        torch.tensor(2.25), [tg])
    np.testing.assert_array_equal(loss.numpy(), np.asarray(jloss))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jgrads["g"]))
    assert grads[0] is tg


def test_inject_scope_reaches_other_threads():
    """On a card autograd runs the backward, and a checkpointed forward's
    recompute, on its own thread: it must read the code the forward read
    (else the recompute saves other tensors than the forward did)."""
    import threading

    seen = {}
    with tchaos.inject_scope(torch.tensor(5)), tchaos.kill_scope(1):
        t = threading.Thread(target=lambda: seen.update(
            code=tchaos.current_inject(), kill=tchaos.current_kill()))
        t.start()
        t.join()
    assert int(seen["code"]) == 5 and seen["kill"] == 1
    assert tchaos.current_inject() is None and tchaos.current_kill() is None


@pytest.mark.parametrize("code", [0, tchaos.INJECT_NAN_ACT])
def test_wrapped_pre_and_stage_fns_match_pipe_tpu(code):
    from pipe_tpu.core.partition import StageCtx as JCtx
    from pipe_tpu_torch.core.partition import StageCtx

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jpre = jchaos.wrap_pre_fn(lambda p, x, ctx: x * 2)
    tpre = tchaos.wrap_pre_fn(lambda x, ctx: x * 2)
    assert torch.equal(tpre(torch.from_numpy(x), None),
                       torch.from_numpy(x) * 2)      # outside a scope
    with jchaos.inject_scope(jnp.int32(code)):
        want = np.asarray(jpre(None, jnp.asarray(x), None))
    with tchaos.inject_scope(torch.tensor(code)):
        got = tpre(torch.from_numpy(x), None).numpy()
    np.testing.assert_array_equal(got, want)
    jstage = jchaos.wrap_stage_fn(lambda p, h, ctx: h + 1)
    tstage = tchaos.wrap_stage_fn(lambda s, h, ctx: h + 1)
    for kill in (tchaos.KILL_NONE, 1):
        for stage in (0, 1):
            with jchaos.kill_scope(jnp.int32(kill)):
                want = np.asarray(jstage(None, jnp.asarray(x),
                                         JCtx(stage=stage)))
            with tchaos.kill_scope(torch.tensor(kill)):
                got = tstage(stage, torch.from_numpy(x),
                             StageCtx(stage=stage)).numpy()
            np.testing.assert_array_equal(got, want)


# --- the trainer ---------------------------------------------------------

@pytest.fixture(scope="module")
def source():
    ids = np.random.RandomState(0).randint(0, CFG["vocab"], size=20000)
    return lm_text.batchify(ids, 8)


@pytest.fixture(scope="module")
def jax_chaos_trainer(tmp_path_factory):
    """pipe_tpu's chaos trainer (tests/test_resilience.py), with an event
    log: one compile, the plan swapped between tests."""
    d = tmp_path_factory.mktemp("j")
    jcfg = dataclasses.replace(jlm.LMConfig(**{k: v for k, v in CFG.items()
                                              if k != "attn_impl"}),
                               attn_impl="xla")
    tr = jloop.Trainer(jcfg, jloop.TrainerConfig(
        resilience=jrecover.ResilienceConfig(**RC), telemetry_dir=str(d),
        **TC), chaos=jchaos.ChaosPlan([]))
    params = jax.tree_util.tree_map(np.asarray, tr.init_state().params)
    return tr, params, os.path.join(d, "events.jsonl")


@pytest.fixture(scope="module")
def torch_chaos_trainer(tmp_path_factory):
    d = tmp_path_factory.mktemp("t")
    tr = tloop.Trainer(tlm.LMConfig(**CFG), tloop.TrainerConfig(
        resilience=trecover.ResilienceConfig(**RC), telemetry_dir=str(d),
        **TC), device="cpu", chaos=tchaos.ChaosPlan([]))
    return tr, os.path.join(d, "events.jsonl")


def _resilience_events(path, since):
    evs = EventLog.read(path)
    return len(evs), [(e["action"], e.get("step", e.get("batch")))
                      for e in evs[since:] if e["kind"] == "resilience"]


@pytest.mark.parametrize("faults,steps", [
    ([("nan_grads", 2, {})], 5),
    ([("nan_activations", 1, {})], 3),
    ([("nan_grads", 2, dict(count=2))], 6),
    ([("data_raise", 1, {})], 4),
    ([("loss_spike", 1, {}), ("inf_grads", 3, {}), ("nan_loss", 4, {})], 6),
])
def test_chaos_trainer_recovers_as_pipe_tpus(jax_chaos_trainer,
                                             torch_chaos_trainer, source,
                                             faults, steps):
    """The same plan on both trainers from the same weights: the same
    skips, rewinds and retries at the same batches, the same counts, and
    losses within fp32 tolerance."""
    jtr, params, jlog = jax_chaos_trainer
    tr, tlog = torch_chaos_trainer
    jtr.chaos, tr.chaos = _plan("jax", *faults), _plan("torch", *faults)
    n0 = len(EventLog.read(jlog)) if os.path.exists(jlog) else 0
    _, jinfo = jtr.train_epoch(source, 0, jtr.init_state(), max_steps=steps,
                               log_every=0)
    m0 = len(EventLog.read(tlog)) if os.path.exists(tlog) else 0
    state = tr.init_state()
    convert.load_pipelined_lm_params(tr.pipe, params)
    _, info = tr.train_epoch(source, 0, state, max_steps=steps, log_every=0)
    for key in ("steps", "anomalies", "rewinds"):
        assert info[key] == jinfo[key], key
    assert info["loss"] == pytest.approx(jinfo["loss"], rel=1e-4)
    assert info["loss_ewma"] == pytest.approx(jinfo["loss_ewma"], rel=1e-4)
    assert _resilience_events(tlog, m0)[1] == _resilience_events(jlog, n0)[1]
    assert all(torch.isfinite(p).all() for p in tr.pipe.parameters())


def test_a_second_epoch_past_warm_up_trains(jax_chaos_trainer,
                                             torch_chaos_trainer, source):
    """Every train_epoch starts the guard's carry empty. Past warm-up,
    pipe_tpu's guard then rejects every step as a spike and aborts with no
    snapshot to rewind to; the port's seeds the EWMA and trains on, taking
    the same first epoch (ROADMAP.md C.10)."""
    jtr, params, _ = jax_chaos_trainer
    tr, _ = torch_chaos_trainer
    jtr.chaos, tr.chaos = _plan("jax"), _plan("torch")
    jstate, jinfo = jtr.train_epoch(source, 0, jtr.init_state(), max_steps=2,
                                    log_every=0)
    with pytest.raises(jrecover.TrainingAborted,
                       match="no known-good snapshot"):
        jtr.train_epoch(source, 1, jstate, max_steps=3, log_every=0)
    state = tr.init_state()
    convert.load_pipelined_lm_params(tr.pipe, params)
    state, info = tr.train_epoch(source, 0, state, max_steps=2, log_every=0)
    assert info["loss"] == pytest.approx(jinfo["loss"], rel=1e-4)
    state, info = tr.train_epoch(source, 1, state, max_steps=3, log_every=0)
    assert info["steps"] == 3 and info["anomalies"] == 0
    assert info["loss_ewma"] > 0


def _trainer(chaos=None, **kw):
    model = dataclasses.replace(tlm.LMConfig(**CFG), dropout=0.1)
    return tloop.Trainer(model, tloop.TrainerConfig(**dict(TC, **kw)),
                         device="cpu", chaos=chaos)


def _recorded(tr, name="_step"):
    got = []
    fn = getattr(tr, name)

    def rec(*a):
        out = fn(*a)
        got.append(out[0] if isinstance(out, tuple) else out)
        return out

    setattr(tr, name, rec)
    return got


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_guard_without_faults_is_the_plain_step_bitwise(source, schedule):
    """Dropout 0.1: the guarded trainer with no plan, and with an empty plan
    (the fault arithmetic at code 0), take the plain trainer's steps bit for
    bit: losses, parameters, moments and Adam's step count."""
    runs = []
    for rc, chaos in ((None, None),
                      (trecover.ResilienceConfig(warmup_steps=2), None),
                      (trecover.ResilienceConfig(warmup_steps=2),
                       tchaos.ChaosPlan([]))):
        tr = _trainer(chaos, resilience=rc, schedule=schedule,
                      checkpoint="except_last")
        losses = _recorded(tr, "_step" if rc is None else "_guarded_step")
        state, info = tr.train_epoch(source, max_steps=5, log_every=0)
        runs.append(([float(l) for l in losses], tstate.state_manifest(state)))
    assert runs[1] == runs[0] and runs[2] == runs[0]


def _snapshot(tr):
    return ([p.detach().clone() for p in tr.pipe.parameters()],
            [{k: v.clone() for k, v in st.items()}
             for st in tr.optimizer.state.values()])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and all(
        sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
        for sa, sb in zip(a[1], b[1]))


@pytest.mark.parametrize("first", [False, True])
def test_a_skipped_step_leaves_the_state_bitwise(source, first):
    """nan_grads at batch 2 (or at the very first step, before Adam has a
    state): parameters, both moments and the step count are bitwise what
    they were before it; the step counter still advances."""
    at = 0 if first else 2
    tr = _trainer(tchaos.ChaosPlan([tchaos.Fault("nan_grads", at)]),
                  resilience=trecover.ResilienceConfig(warmup_steps=100))
    state = tr.init_state()
    if not first:
        state, _ = tr.train_epoch(source, state=state, max_steps=2,
                                  log_every=0)
    before = _snapshot(tr)
    state, info = tr.train_epoch(source, state=state, max_steps=at + 1,
                                 start_step=at, log_every=0)
    assert info["anomalies"] == 1 and state.step == at + 1
    if first:
        assert all(torch.equal(p, q) for p, q in zip(
            before[0], [p.detach() for p in tr.pipe.parameters()]))
        assert all(float(st["step"]) == 0.0 and not st["exp_avg"].any()
                   for st in tr.optimizer.state.values())
    else:
        assert _same(_snapshot(tr), before)


def test_persistent_nan_grads_rewind_then_abort(source):
    lines = []
    tr = _trainer(tchaos.ChaosPlan([tchaos.Fault("nan_grads", 3, count=5)]),
                  resilience=trecover.ResilienceConfig(
                      warmup_steps=100, rewind_after=1, max_rewinds=1,
                      snapshot_every=1, rewind_backoff_s=0.0))
    with pytest.raises(trecover.TrainingAborted, match="after 1 rewinds"):
        tr.train_epoch(source, max_steps=8, log_every=0, log_fn=lines.append)
    assert any("rewind #1 at step 3 -> snapshot of step 2" in l
               for l in lines)


def test_data_fault_retried_no_steps_lost(source):
    tr = _trainer(tchaos.ChaosPlan([tchaos.Fault("data_raise", 1)]),
                  resilience=trecover.ResilienceConfig(data_backoff_s=0.0))
    before = tr.registry.scalars().get("resilience.data_retries", 0)
    losses = _recorded(tr, "_guarded_step")
    _, info = tr.train_epoch(source, max_steps=4, log_every=0)
    assert info["steps"] == 4 and info["anomalies"] == 0
    assert tr.registry.scalars()["resilience.data_retries"] - before == 1
    plain = _trainer()
    want = _recorded(plain)
    plain.train_epoch(source, max_steps=4, log_every=0)
    assert [float(x) for x in losses] == [float(x) for x in want]


@pytest.mark.parametrize("check_every", [1, 4])
def test_state_captured_only_on_the_check_cadence(source, check_every):
    """The loop captures the live state (and so waits for the device) only
    where it reads the verdict: at init, every ``check_every`` steps and at
    the end. The cadence changes when the host reads, not what the steps
    do: a skip at batch 1 inside a window of 4 leaves the same losses and
    state, Adam's step count included, as a read every step."""
    runs = [_cadence_run(source, every) for every in (1, check_every)]
    assert runs[1] == runs[0]
    assert set(runs[0][2]) == {7.0}


_CADENCE_RUNS = {}


def _cadence_run(source, every):
    """One guarded run with a skip at batch 1, reading the verdict every
    ``every`` steps (its captures checked), once per ``every`` for the
    module: ``(losses, state manifest, Adam's step counts)``."""
    if every in _CADENCE_RUNS:
        return _CADENCE_RUNS[every]
    tr = _trainer(tchaos.ChaosPlan([tchaos.Fault("nan_grads", 1)]),
                  resilience=trecover.ResilienceConfig(
                      warmup_steps=100, check_every=every))
    captured = []
    capture = tr._capture

    def rec(step):
        captured.append(step)
        return capture(step)

    tr._capture = rec
    losses = _recorded(tr, "_guarded_step")
    state, info = tr.train_epoch(source, max_steps=8, log_every=0)
    assert info["anomalies"] == 1 and state.step == 8
    assert captured == [0, *range(every, 9, every), 8]
    _CADENCE_RUNS[every] = ([float(l) for l in losses],
                            tstate.state_manifest(state),
                            sorted(float(st["step"])
                                   for st in tr.optimizer.state.values()))
    return _CADENCE_RUNS[every]


def test_autosave_on_sigterm_resumes_bitwise(source, tmp_path):
    """SIGTERM during the third step: the step finishes, the state is saved,
    the epoch stops; a new trainer restored from it takes the remaining
    steps with the losses of an uninterrupted run, bit for bit."""
    whole = _trainer()
    want = _recorded(whole)
    whole.train_epoch(source, max_steps=6, log_every=0)

    tr = _trainer()
    tr.install_autosave(str(tmp_path / "auto"))
    got = _recorded(tr)
    step = tr._step

    def step_with_sigterm(*a):
        if len(got) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a)

    tr._step = step_with_sigterm
    lines = []
    try:
        _, info = tr.train_epoch(source, max_steps=6, log_every=0,
                                 log_fn=lines.append)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert info["steps"] == 3 and tr._autosave_pending()
    assert any("autosave: step 3 checkpointed" in l for l in lines)
    resumed = _trainer()
    state = tstate.restore_checkpoint(str(tmp_path / "auto"),
                                      resumed.init_state())
    assert state.step == 3
    more = _recorded(resumed)
    resumed.train_epoch(source, state=state, max_steps=6, start_step=3,
                        log_every=0)
    assert [float(x) for x in got + more] == [float(x) for x in want]
