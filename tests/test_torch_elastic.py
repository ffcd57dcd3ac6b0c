"""pipe_tpu_torch's elastic training (``resilience/elastic.py``) and the
guarded step over a mesh and over ``ShardedAdam``, against pipe_tpu's.

* **The drill on one device** -- tests/test_elastic.py's geometry (12
  layers, 4 stages, a ``kill_stage`` fault on stage 1 at step 6, 10 steps)
  from pipe_tpu's initial weights: the recovery record equals pipe_tpu's
  ``train_elastic``'s, the resumed losses are within 1e-4 relative of its,
  and so are the unkilled run's. The recovered run is bit for bit the run
  that trains unkilled to the snapshot step, restacks and finishes on a
  trainer born with 3 stages.
* **The units** -- the heartbeat localizes the kill, the buddy copies
  restore bit for bit and refuse a corrupt copy, the restack equals a
  born-narrow init and round-trips, pipe_tpu's refusals word for word, the
  kill channel, and ``elastic=None`` leaves the step as it was.
* **A 4-rank gloo world** (one per module, ``tests/torch_elastic_cases.py``
  on the ranks): the drill over 4 stage ranks, whose survivors' record is
  pipe_tpu's and whose state is the one-device drill's; the rank of the
  dead stage retires. The guarded step over 2 x 2 ranks with ZeRO under a
  chaos plan: the anomalies, rewinds and losses of pipe_tpu's
  ``Trainer(n_stages=2, n_data=2, zero=True)`` under the same plan.

Every pipe_tpu reference is computed once per module.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_elastic_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.resilience import chaos as jchaos
from pipe_tpu.resilience import elastic as jelastic
from pipe_tpu.resilience import recover as jrecover
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import convert
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.resilience import chaos as tchaos
from pipe_tpu_torch.resilience import elastic as telastic
from pipe_tpu_torch.runtime import World
from pipe_tpu_torch.train import loop as tloop
from pipe_tpu_torch.train import state as tstate

TOL = 1e-4          # tests/test_torch_resilience.py's loss tolerance
RECORD = ("stage", "detected_step", "snapshot_step", "resume_step",
          "lost_steps", "n_stages")


@pytest.fixture(scope="module")
def source():
    ids = np.random.RandomState(0).randint(0, cases.DRILL_CFG.vocab,
                                           size=20000)
    return lm_text.batchify(ids, 8)


def _jax_model(cfg):
    return jlm.LMConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(jlm.LMConfig)
                           if f.name not in ("attn_impl", "compute_dtype")},
                        attn_impl="xla")


def _jax_config(tc):
    """pipe_tpu's ``TrainerConfig`` of the port's ``tc``."""
    kw = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)
          if f.name not in ("resilience", "elastic")}
    rc = jrecover.ResilienceConfig(**dataclasses.asdict(tc.resilience))
    el = (None if tc.elastic is None else
          jelastic.ElasticConfig(**dataclasses.asdict(tc.elastic)))
    return jloop.TrainerConfig(resilience=rc, elastic=el, **kw)


def _recorded(jtr, losses):
    """Record the loss of every step of pipe_tpu's trainer ``jtr``."""
    step = jtr._step_fn

    def rec(*a):
        out = step(*a)
        losses.append(float(out[1]))
        return out

    jtr._step_fn = rec


@pytest.fixture(scope="module")
def jax_drill(source):
    """pipe_tpu's drill: its initial params, the recovery record, the
    resumed losses by step, and the first segment's losses (steps 0-5 are
    the unkilled run's: the kill fires at 6)."""
    jtr = jloop.Trainer(_jax_model(cases.DRILL_CFG),
                        _jax_config(cases.drill_config()),
                        chaos=jchaos.ChaosPlan(
                            [jchaos.Fault("kill_stage", **cases.DRILL_KILL)]))
    state = jtr.init_state()
    params = jax.tree_util.tree_map(np.asarray, state.params)
    first = []
    _recorded(jtr, first)
    jtr2, _, info = jelastic.train_elastic(jtr, source, state=state,
                                           max_steps=cases.DRILL_STEPS,
                                           log_fn=lambda m: None)
    assert jtr2.cfg.n_stages == 3
    return dict(params=params, recoveries=info["recoveries"],
                loss_by_step=info["loss_by_step"], first=first)


def _drill_trainer(params, n_stages=4, kill=True, **kw):
    faults = ([tchaos.Fault("kill_stage", **cases.DRILL_KILL)] if kill
              else [])
    tr = tloop.Trainer(cases.DRILL_CFG, cases.drill_config(n_stages, **kw),
                       device="cpu", chaos=tchaos.ChaosPlan(faults))
    if params is not None:
        convert.load_pipelined_lm_params(tr.pipe, params)
    return tr


@pytest.fixture(scope="module")
def port_drill(jax_drill, source):
    """The port's drill on one device from pipe_tpu's params, and its
    unkilled run."""
    tr = _drill_trainer(jax_drill["params"])
    tr2, state, info = telastic.train_elastic(
        tr, source, state=tr._capture(0), max_steps=cases.DRILL_STEPS,
        log_fn=lambda m: None)
    ref = _drill_trainer(jax_drill["params"], kill=False)
    _, unkilled = ref.train_epoch(source, state=ref._capture(0),
                                  max_steps=cases.DRILL_STEPS, log_every=0)
    return dict(trainer=tr2, state=state, info=info,
                manifest=tstate.state_manifest(state), unkilled=unkilled)


def _record(recoveries):
    return [{k: r[k] for k in RECORD} for r in recoveries]


def test_one_device_drill_matches_pipe_tpu(jax_drill, port_drill):
    info = port_drill["info"]
    assert info["replans"] == 1 and port_drill["trainer"].cfg.n_stages == 3
    assert _record(info["recoveries"]) == _record(jax_drill["recoveries"])
    assert sorted(info["loss_by_step"]) == [6, 7, 8, 9]
    for b, want in jax_drill["loss_by_step"].items():
        assert info["loss_by_step"][b] == pytest.approx(want, rel=TOL), b
    # the unkilled run: steps 0-5 as pipe_tpu's drill before its kill, 6-9
    # as its resumed steps (which track its unkilled run, test_elastic.py)
    want = jax_drill["first"][:6] + [jax_drill["loss_by_step"][b]
                                     for b in range(6, 10)]
    np.testing.assert_allclose(port_drill["unkilled"]["losses"], want,
                               rtol=TOL, atol=0)
    assert all(torch.isfinite(p).all()
               for p in port_drill["trainer"].pipe.parameters())


def test_recovered_run_is_the_restacked_reference_bitwise(jax_drill,
                                                          port_drill, source):
    """tools/elastic_bench.py's pin on one device: train unkilled to the
    snapshot step, restack, finish on a trainer born with 3 stages: its
    losses and state (parameters, both moments, Adam's step count) are the
    recovered run's, bit for bit."""
    ref = _drill_trainer(jax_drill["params"], kill=False)
    state, _ = ref.train_epoch(source, state=ref._capture(0), max_steps=6,
                               log_every=0)
    narrow = _drill_trainer(None, n_stages=3, kill=False)
    state = telastic.restack_state(state, 4, 3)
    state, info = narrow.train_epoch(source, state=state,
                                     max_steps=cases.DRILL_STEPS,
                                     start_step=6, log_every=0)
    assert info["loss_by_step"] == port_drill["info"]["loss_by_step"]
    assert tstate.state_manifest(state) == port_drill["manifest"]


# --- units -----------------------------------------------------------------

def _tiny(n_stages=2, chaos=None, **kw):
    model = dataclasses.replace(cases.DRILL_CFG, n_layers=4)
    return tloop.Trainer(model, cases.drill_config(n_stages, **kw),
                         device="cpu", chaos=chaos)


def test_kill_heartbeat_localizes_stage(source):
    """Killing stage j zeroes the gradients of every stage <= j and of none
    after it: the largest silent index is the dead stage."""
    tr = _tiny(chaos=tchaos.ChaosPlan([]))
    tr.init_state()
    data, target = next(tr._batches(source, 1))

    def beat(kill):
        with tchaos.kill_scope(torch.tensor(kill, dtype=torch.int32)):
            tr._loss_and_grads(data, target, seed=0)
        return tr._heartbeat().numpy()

    assert (beat(tchaos.KILL_NONE) > 0).all()
    k0 = beat(0)
    assert k0[0] == 0.0 and k0[1] > 0.0
    assert (beat(1) == 0.0).all()


def _trained(source, **kw):
    tr = _tiny(**kw)
    state, _ = tr.train_epoch(source, state=tr.init_state(), max_steps=2,
                              log_every=0)
    return tr, state


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_buddy_capture_restore_bitwise(source, mu_dtype, tmp_path):
    """After two steps, a capture (verified against the source) restores
    the whole state bit for bit: ``torch.optim.Adam``'s state as it was,
    and ``ShardedAdam``'s (``mu_dtype``) loaded into a fresh trainer. The
    buddy manifest file holds the capture's per-stage digests."""
    el = dataclasses.replace(cases.drill_config().elastic,
                             snapshot_dir=str(tmp_path))
    tr, state = _trained(source, mu_dtype=mu_dtype, elastic=el)
    store = tr.elastic_store()
    taken = store.snapshots           # the epoch's own capture at step 0
    store.capture(state, 3)
    assert store.has_snapshot and store.step == 3
    assert store.snapshots == taken + 1
    restored = store.restore_state()
    if mu_dtype is None:
        assert tstate.state_manifest(restored) == tstate.state_manifest(
            tr._capture(state.step))
    else:
        fresh = _tiny(mu_dtype=mu_dtype, elastic=el)
        fresh._adopt(restored)
        assert tstate.state_manifest(fresh._capture(state.step)) == \
            tstate.state_manifest(tr._capture(state.step))
    doc = tstate.read_buddy_manifest(str(tmp_path), 3)
    assert doc["n_stages"] == 2 and doc["stage_shards"] == store._manifest
    assert tstate.read_buddy_manifest(str(tmp_path), 4) is None


def test_buddy_restore_detects_corruption(source):
    tr, state = _trained(source)
    store = tr.elastic_store()
    store.capture(state, 0)
    store._held[0][7] ^= 1
    with pytest.raises(RuntimeError, match="manifest"):
        store.restore_state()


def test_restack_matches_born_narrow_init():
    """A 4-stage init regrouped over 2 stages is a born-2-stage init, bit
    for bit: ``build_sequential`` draws every layer in one order."""
    s4 = _tiny(4).init_state()
    s2 = _tiny(2).init_state()
    restacked = telastic.restack_state(s4, 4, 2)
    assert tstate.state_manifest(
        tstate.TrainState(restacked.model, {}, 0)) == tstate.state_manifest(
            tstate.TrainState(s2.model, {}, 0))
    again = telastic.restack_state(restacked, 2, 4)
    assert list(again.model) == list(s4.model)
    with pytest.raises(ValueError, match="do not regroup over 3 stages"):
        telastic.restack_state(s4, 4, 3)


def test_elastic_refusals_are_pipe_tpus():
    """pipe_tpu's words: elastic needs resilience and one stage a
    device."""
    model = dataclasses.replace(cases.DRILL_CFG, n_layers=4)
    for kw in (dict(resilience=None),
               dict(schedule="interleaved-1f1b", chunks=4)):
        tc = cases.drill_config(2, **{k: v for k, v in kw.items()
                                      if k != "resilience"})
        if "resilience" in kw:
            tc = dataclasses.replace(tc, resilience=None)
        with pytest.raises(ValueError) as got:
            tloop.Trainer(model, tc, device="cpu")
        jtc = dataclasses.replace(
            _jax_config(dataclasses.replace(
                tc, resilience=cases.DRILL_RC)), **kw)
        with pytest.raises(ValueError) as want:
            jloop.Trainer(_jax_model(model), jtc)
        assert str(got.value) == str(want.value)
    for bad in (dict(snapshot_every=0), dict(max_replans=-1)):
        with pytest.raises(ValueError):
            telastic.ElasticConfig(**bad)


def test_elastic_none_leaves_the_step_bitwise(source):
    """With ``elastic=None`` the guarded step is as it was: the same losses
    and the same operations (aten calls, counted) before and after an
    elastic trainer has killed a stage in the process; the elastic step
    without a kill takes the same losses."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    def guarded(elastic=None, chaos=None):
        tr = _tiny(elastic=elastic, chaos=chaos)
        state = tr.init_state()
        Count.calls = 0
        with Count():
            _, info = tr.train_epoch(source, state=state, max_steps=3,
                                     log_every=0)
        return info["losses"], Count.calls

    before = guarded()
    tr = _tiny(chaos=tchaos.ChaosPlan([tchaos.Fault("kill_stage", 0,
                                                    stage=1)]),
               elastic=dataclasses.replace(cases.drill_config().elastic,
                                           snapshot_every=1))
    with pytest.raises(telastic.StageLost):
        tr.train_epoch(source, state=tr.init_state(), max_steps=3,
                       log_every=0)
    assert guarded() == before
    assert guarded(cases.drill_config().elastic)[0] == before[0]


# --- the world ----------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=120, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


@pytest.fixture(scope="module")
def mesh_drill(world, jax_drill, source):
    return world.run(cases.mesh_drill, jax_drill["params"], source)


def test_mesh_drill_survives_a_stage(mesh_drill, jax_drill, port_drill):
    """4 stage ranks lose stage 1: the rank of stage 1 retires, the 3
    survivors re-plan over their own group (no call waits on the retired
    rank), hold pipe_tpu's recovery record and the one-device drill's
    losses, and their state, gathered over the survivors, is the one-device
    drill's within the mesh trainer tests' tolerance."""
    res = mesh_drill
    retired = [r for r in res if r.get("retired")]
    assert [r["rank"] for r in retired] == [1]
    assert any("retires" in l for l in retired[0]["lines"])
    alive = [r for r in res if not r.get("retired")]
    assert [(r["rank"], r["stage"], r["n_stages"]) for r in alive] == \
        [(0, 0, 3), (2, 1, 3), (3, 2, 3)]
    one = port_drill["info"]
    for r in alive:
        assert _record(r["recoveries"]) == _record(jax_drill["recoveries"])
        assert sorted(r["loss_by_step"]) == [6, 7, 8, 9]
        for b, want in one["loss_by_step"].items():
            assert r["loss_by_step"][b] == pytest.approx(want, rel=TOL)
    # the key projection's bias has a zero gradient up to rounding (softmax
    # is invariant to a shift shared by every key), so Adam's normalized
    # step follows the rounding and those biases move by up to lr a step
    # on either side; every other tensor is held as the mesh trainer
    # tests hold gradients
    got = alive[0]["state"]
    want = port_drill["state"]
    assert set(got["model"]) == set(want.model)
    noise = [k for k in want.model if k.endswith("attn.wk.bias")]
    assert len(noise) == cases.DRILL_CFG.n_layers
    for k, v in want.model.items():
        ref = v.numpy()
        bound = (cases.drill_config().lr * cases.DRILL_STEPS if k in noise
                 else TOL * max(1.0, np.abs(ref).max()))
        assert np.abs(got["model"][k] - ref).max() <= bound, k
    assert set(got["moments"]) == set(want.optimizer["state"])
    biases = {g for g, (n, _) in enumerate(
        port_drill["trainer"].pipe.named_parameters()) if n in noise}
    for g, st in want.optimizer["state"].items():
        if g in biases:
            continue
        for k in ("exp_avg", "exp_avg_sq"):
            ref = st[k].float().numpy()
            assert np.abs(got["moments"][g][k] - ref).max() <= \
                TOL * np.abs(ref).max(), (g, k)


def test_mesh_drill_is_the_restacked_reference_bitwise(world, mesh_drill,
                                                       jax_drill, source):
    """tools/elastic_bench.py's pin over the ranks: the recovered run's
    losses and final state (parameters, both moments, Adam's step count)
    equal, bit for bit, a reference on the same 3 survivor ranks that
    trains the unkilled 4-stage world to the snapshot step, restacks, and
    finishes on a trainer born with 3 stages."""
    drill = mesh_drill
    ref = world.run(cases.mesh_reference, jax_drill["params"], source)
    assert [r.get("retired", False) for r in ref] == [False, True, False,
                                                      False]
    for got, want in zip(drill, ref):
        if want.get("retired"):
            continue
        assert got["loss_by_step"] == want["loss_by_step"]
        assert got["manifest"] == want["manifest"]
    assert drill[0]["manifest"] is not None


@pytest.fixture(scope="module")
def jax_guarded(source):
    """pipe_tpu's guarded trainer over 2 stages x 2 data with ZeRO under the
    chaos plan: its initial params, counts and per-step losses."""
    jtr = jloop.Trainer(
        _jax_model(cases.GUARD_CFG),
        _jax_config(cases.guard_config(n_data=2, zero=True)),
        chaos=jchaos.ChaosPlan([jchaos.Fault(k, s, **kw)
                                for k, s, kw in cases.GUARD_FAULTS], seed=3))
    state = jtr.init_state()
    params = jax.tree_util.tree_map(np.asarray, state.params)
    losses = []
    _recorded(jtr, losses)
    _, info = jtr.train_epoch(source, 0, state, max_steps=cases.GUARD_STEPS,
                              log_every=0, log_fn=lambda m: None)
    return dict(params=params, losses=losses, info=info)


def test_mesh_guarded_zero_matches_pipe_tpu(world, jax_guarded, source):
    """The guarded step over a 2 x 2 world with ZeRO under nan_grads (a
    rewind), a loss spike and a data fault: every rank skips, rewinds and
    retries where pipe_tpu's trainer does, with its losses."""
    want = jax_guarded["info"]
    res = world.run(cases.mesh_guarded, jax_guarded["params"], source)
    for r in res:
        assert (r["anomalies"], r["rewinds"], r["steps"]) == (
            want["anomalies"], want["rewinds"], want["steps"])
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_allclose(r["losses"], jax_guarded["losses"],
                                   rtol=TOL, atol=0)
    assert want["anomalies"] == 3 and want["rewinds"] == 1
