"""The port's fleet control plane (``pipe_tpu_torch/fleet``,
``serve/router.py``, the engine's watchdog, chaos and phases) against
``pipe_tpu``'s, scenario by scenario.

Each scenario is written once over a namespace of either package and runs
on a stub slot backend and a stepped clock, so both runs are deterministic;
it returns a trace of what the fleet did after every tick (placements,
replica states, deliveries), the final responses and attempts, the counters
and gauges of the package's registry, and the journal records minus their
wall times. The port's trace must equal ``pipe_tpu``'s exactly. The health
surfaces (``TickWatchdog``, ``HopHealth``), the chaos accessors, the
journal state machine, the topology plans and ``suggest_roles`` are held to
``pipe_tpu``'s the same way.
"""

import json
import time
import types

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu.fleet as jfleet
import pipe_tpu.fleet.topology as jtopo
import pipe_tpu.obs.fleet_obs as jobs
import pipe_tpu.obs.telemetry as jtel
import pipe_tpu.resilience as jres
import pipe_tpu.serve as jserve
import pipe_tpu.serve.queue as jqueue
import pipe_tpu_torch.fleet as tfleet
import pipe_tpu_torch.fleet.topology as ttopo
import pipe_tpu_torch.obs.fleet_obs as tobs
import pipe_tpu_torch.obs.telemetry as ttel
import pipe_tpu_torch.resilience as tres
import pipe_tpu_torch.serve as tserve
import pipe_tpu_torch.serve.queue as tqueue


def _ns(fleet, serve, res, tel, obs, queue):
    return types.SimpleNamespace(
        fleet=fleet, serve=serve, res=res, tel=tel, obs=obs, queue=queue,
        ServeEngine=serve.ServeEngine, RequestQueue=serve.RequestQueue,
        Router=serve.Router, RouterPolicy=serve.RouterPolicy,
        TickWatchdog=res.TickWatchdog, ChaosPlan=res.ChaosPlan,
        Fault=res.Fault)


JAX = _ns(jfleet, jserve, jres, jtel, jobs, jqueue)
TORCH = _ns(tfleet, tserve, tres, ttel, tobs, tqueue)


class _Gen:
    eos_token_id = None
    max_new_tokens = 32
    pad_token_id = 0

    def check_decode_headroom(self, *a, **k):
        return None


class FakeBackend:
    """S slots, one token per decode step, no device: what the fleet sees
    of a backend (``tests/test_router.py``'s stub, with every attribute
    either engine reads)."""

    pool = None
    buckets = None
    resident = False
    decode_chunk = 1
    decode_width = 1
    _spec_overshoot = 0

    def __init__(self, num_slots=2, poison=None):
        self.num_slots = num_slots
        self.gen = _Gen()
        self.poison = poison

    def validate(self, prompt_len, max_new_tokens):
        if max_new_tokens > self.gen.max_new_tokens:
            raise ValueError("max_new_tokens above engine cap")

    def can_admit(self, prompt_len, max_new_tokens, prompt=None):
        return True

    def release(self, slot):
        pass

    def prefill(self, slot, prompt, seed, **kw):
        if self.poison is not None and prompt[0] == self.poison:
            raise RuntimeError("poisoned prompt")
        return 1 + seed % 7

    def decode(self, live, budgets=None, r_max=None):
        toks = np.full((self.num_slots, 1), 2, np.int32)
        valid = np.broadcast_to(np.asarray(live, bool)[:, None], toks.shape)
        return toks, valid


def _fresh_registry(P):
    reg = P.tel.MetricsRegistry()
    P.tel.set_registry(reg)
    return reg


def _metrics(reg):
    snap = reg.snapshot()
    return {k: v for k, v in snap.items()
            if isinstance(v, (int, float)) and not k.endswith("tick_sec")}


def _engine(P, clock, *, slots=2, capacity=32, poison=None, phase="mixed",
            watchdog=None):
    return P.ServeEngine(
        FakeBackend(slots, poison=poison),
        P.RequestQueue(capacity=capacity, clock=clock),
        watchdog=(watchdog if watchdog is not None
                  else P.TickWatchdog(stuck_slack_ticks=None)),
        phase=phase)


def _router(P, n, clock, *, slots=2, replica_capacity=32, front_capacity=32,
            chaos=None, poison=None, **policy_kw):
    policy_kw.setdefault("backoff_base_s", 0.0)
    engines = [_engine(P, clock, slots=slots, capacity=replica_capacity,
                       poison=poison) for _ in range(n)]
    return P.Router(engines, P.RequestQueue(capacity=front_capacity,
                                            clock=clock),
                    policy=P.RouterPolicy(**policy_kw), chaos=chaos)


def _step(ctl, t, log, n=1):
    for _ in range(n):
        t[0] += 0.01
        out = ctl.tick()
        log.append({"delivered": [(r.request_id, r.status, r.finish_reason,
                                   list(map(int, r.tokens)))
                                  for r in out],
                    "placed": sorted(ctl._placed_on.items()),
                    "states": [rep.state for rep in ctl.replicas],
                    "parked": sorted(r.id for _, r in ctl._parked),
                    "front": ctl.queue.depth})


def _drive(ctl, t, log, max_ticks=300):
    for _ in range(max_ticks):
        if ctl.idle:
            return
        _step(ctl, t, log)
    raise AssertionError(f"fleet not idle: {ctl.counts()}")


def _final(ctl, reqs):
    out = []
    for r in reqs:
        resp = ctl.response(r.id)
        out.append((r.id, r.attempts, None if resp is None else
                    (resp.status, resp.finish_reason,
                     list(map(int, resp.tokens)))))
    return out


# ---------------------------------------------------------------------------
# scenarios (tests/test_router.py, tests/test_fleet.py's in-process parts)


def scn_least_loaded(P, t, log):
    ctl = _router(P, 3, lambda: t[0])
    reqs = [ctl.submit([1, 2, 3], max_new_tokens=4, seed=i)
            for i in range(6)]
    _step(ctl, t, log)
    log.append([rep.load for rep in ctl.replicas])
    _drive(ctl, t, log)
    return ctl, reqs


def scn_session_affinity(P, t, log):
    ctl = _router(P, 3, lambda: t[0], placement="session")
    reqs = [ctl.submit([1, 2], max_new_tokens=6, session="a")]
    _step(ctl, t, log)
    reqs.append(ctl.submit([1, 2], max_new_tokens=6, session="a"))
    _step(ctl, t, log)
    ctl.replicas[ctl._placed_on[reqs[0].id]].state = P.fleet.SUSPECT
    reqs.append(ctl.submit([1, 2], max_new_tokens=6, session="a"))
    _step(ctl, t, log)
    log.append(dict(ctl._session_map))
    _drive(ctl, t, log)
    return ctl, reqs


def scn_kill_replica(P, t, log):
    chaos = P.ChaosPlan([P.Fault("kill_replica", step=3, stage=2)])
    ctl = _router(P, 3, lambda: t[0], chaos=chaos)
    reqs = [ctl.submit([1, 2, 3], max_new_tokens=8, seed=i)
            for i in range(12)]
    _drive(ctl, t, log)
    return ctl, reqs


def scn_wedged_backlog(P, t, log):
    chaos = P.ChaosPlan([P.Fault("kill_replica", step=2, stage=1)])
    ctl = _router(P, 2, lambda: t[0], slots=1, chaos=chaos)
    reqs = [ctl.submit([1, 2], max_new_tokens=4, seed=i) for i in range(6)]
    _drive(ctl, t, log)
    return ctl, reqs


def scn_wedge_replica_window(P, t, log):
    chaos = P.ChaosPlan([P.Fault("wedge_replica", step=2, count=3,
                                 stage=0)])
    ctl = _router(P, 2, lambda: t[0], chaos=chaos, recover_healthy_ticks=2)
    reqs = [ctl.submit([1, 2], max_new_tokens=5, seed=i) for i in range(8)]
    _drive(ctl, t, log)
    return ctl, reqs


def scn_retry_budget(P, t, log):
    ctl = _router(P, 2, lambda: t[0], poison=666, retry_budget=2,
                  wedge_error_ticks=100, wedge_decode_errors=100,
                  recover_healthy_ticks=1)
    reqs = [ctl.submit([666, 1], max_new_tokens=4),
            ctl.submit([1, 2], max_new_tokens=4)]
    _drive(ctl, t, log)
    return ctl, reqs


def scn_backoff(P, t, log):
    ctl = _router(P, 2, lambda: t[0], poison=666, retry_budget=3,
                  backoff_base_s=1.0, backoff_max_s=8.0,
                  wedge_error_ticks=100, wedge_decode_errors=100,
                  recover_healthy_ticks=1)
    reqs = [ctl.submit([666, 1], max_new_tokens=4)]
    _step(ctl, t, log, 6)
    t[0] += 1.0
    _drive(ctl, t, log)
    return ctl, reqs


def scn_reclaim(P, t, log):
    ctl = _router(P, 1, lambda: t[0], retry_budget=2, backoff_base_s=1.0,
                  backoff_max_s=8.0)
    R = P.queue.Request
    reqs = [R(id=101, prompt=[1], max_new_tokens=4, cancelled=True,
              attempts=1),
            R(id=102, prompt=[1], max_new_tokens=4, deadline=4.0,
              attempts=1),
            R(id=103, prompt=[1], max_new_tokens=4, attempts=1),
            R(id=104, prompt=[1], max_new_tokens=4, attempts=2,
              submitted_at=1.0)]
    fin = ctl.reclaim(reqs, 5.0)
    log.append([(r.request_id, r.status, r.finish_reason) for r in fin])
    log.append(sorted((req.id, at) for at, req in ctl._parked))
    with pytest.raises(RuntimeError, match="exactly-once"):
        ctl.reclaim([reqs[3]], 5.0)
    return ctl, reqs


def scn_cancel_parked(P, t, log):
    ctl = _router(P, 2, lambda: t[0], poison=666, backoff_base_s=100.0,
                  wedge_error_ticks=100, wedge_decode_errors=100)
    reqs = [ctl.submit([666, 1], max_new_tokens=4)]
    _step(ctl, t, log)
    log.append(ctl.cancel(reqs[0].id))
    _step(ctl, t, log)
    log.append(ctl.cancel(reqs[0].id))
    return ctl, reqs


def scn_all_suspect(P, t, log):
    ctl = _router(P, 2, lambda: t[0], front_capacity=4,
                  recover_healthy_ticks=1000)
    for rep in ctl.replicas:
        rep.state = P.fleet.SUSPECT
    reqs = [ctl.submit([1, 2], max_new_tokens=4) for _ in range(4)]
    _step(ctl, t, log, 3)
    with pytest.raises(P.serve.QueueFull):
        ctl.submit([1, 2], max_new_tokens=4)
    return ctl, reqs


def scn_no_deadline_credit(P, t, log):
    ctl = _router(P, 2, lambda: t[0], poison=666, wedge_error_ticks=100,
                  wedge_decode_errors=100, retry_budget=100,
                  recover_healthy_ticks=1)
    reqs = [ctl.submit([666, 1], max_new_tokens=4, timeout_s=0.5)]
    _step(ctl, t, log)
    t[0] += 1.0
    _drive(ctl, t, log)
    return ctl, reqs


def scn_drain(P, t, log):
    ctl = _router(P, 2, lambda: t[0], slots=1, replica_capacity=1,
                  front_capacity=16)
    reqs = [ctl.submit([1, 2], max_new_tokens=3) for _ in range(6)]
    _step(ctl, t, log)
    ctl.drain()
    with pytest.raises(P.serve.EngineDraining):
        ctl.submit([1, 2], max_new_tokens=3)
    _drive(ctl, t, log)
    log.append(ctl.drained)
    return ctl, reqs


def scn_spawn_retire(P, t, log):
    clock = lambda: t[0]  # noqa: E731

    def spawn():
        return _engine(P, clock, slots=1, capacity=1)

    ctl = P.Router([spawn()], P.RequestQueue(capacity=32, clock=clock),
                   policy=P.RouterPolicy(backoff_base_s=0.0, spawn_depth=2,
                                         spawn_sustain_ticks=2,
                                         retire_idle_ticks=2,
                                         min_replicas=1),
                   spawn_fn=spawn)
    reqs = [ctl.submit([1, 2], max_new_tokens=4) for _ in range(6)]
    _drive(ctl, t, log)
    _step(ctl, t, log, 8)
    log.append(ctl.counts())
    return ctl, reqs


def scn_dead_fleet(P, t, log):
    chaos = P.ChaosPlan([P.Fault("kill_replica", step=0, stage=0)])
    ctl = _router(P, 1, lambda: t[0], chaos=chaos, wedge_error_ticks=1,
                  retry_budget=5)
    reqs = [ctl.submit([1, 2], max_new_tokens=4) for _ in range(3)]
    _drive(ctl, t, log, max_ticks=20)
    _step(ctl, t, log, 2)
    return ctl, reqs


def scn_slow_streak(P, t, log):
    """The watchdog's slow streak walks a replica HEALTHY -> SUSPECT ->
    HEALTHY: the tick's clock is stepped inside the backend's decode."""
    clock = lambda: t[0]  # noqa: E731
    engines = [_engine(P, clock, watchdog=P.TickWatchdog(
        tick_budget_s=0.05, stuck_slack_ticks=None)) for _ in range(2)]
    slow = engines[0].backend
    orig = slow.decode
    calls = {"n": 0}

    def stalled(live, *a, **k):
        calls["n"] += 1
        if 2 <= calls["n"] <= 4:
            t[0] += 0.2
        return orig(live, *a, **k)

    slow.decode = stalled
    ctl = P.Router(engines, P.RequestQueue(capacity=32, clock=clock),
                   policy=P.RouterPolicy(backoff_base_s=0.0,
                                         suspect_slow_streak=2,
                                         recover_healthy_ticks=2))
    reqs = [ctl.submit([1, 2], max_new_tokens=8, seed=i) for i in range(6)]
    _drive(ctl, t, log)
    log.append([e.watchdog.slow_ticks for e in engines])
    return ctl, reqs


def scn_stuck_slots(P, t, log):
    """A replica whose decode never makes tokens valid: the watchdog
    retires its slots ``stuck`` and the fleet re-places them."""
    clock = lambda: t[0]  # noqa: E731
    engines = [_engine(P, clock, watchdog=P.TickWatchdog(
        stuck_slack_ticks=2)) for _ in range(2)]
    stuck = engines[1].backend

    def nothing(live, *a, **k):
        toks = np.zeros((stuck.num_slots, 1), np.int32)
        return toks, np.zeros(toks.shape, bool)

    stuck.decode = nothing
    ctl = P.Router(engines, P.RequestQueue(capacity=32, clock=clock),
                   policy=P.RouterPolicy(backoff_base_s=0.0))
    reqs = [ctl.submit([1, 2], max_new_tokens=3, seed=i) for i in range(4)]
    _drive(ctl, t, log)
    log.append([e.watchdog.stuck_slots for e in engines])
    return ctl, reqs


def _controller(P, n, clock, *, async_tick=False, roles=None, journal=None,
                **policy_kw):
    policy_kw.setdefault("backoff_base_s", 0.0)
    roles = roles or ["mixed"] * n
    trs = [P.fleet.InProcessTransport(_engine(P, clock, phase=r),
                                      async_tick=async_tick)
           for r in roles]
    cls = (P.fleet.DisaggController if any(r != "mixed" for r in roles)
           else P.fleet.FleetController)
    return cls(trs, P.RequestQueue(capacity=32, clock=clock),
               policy=P.RouterPolicy(**policy_kw), journal=journal)


def scn_controller(P, t, log):
    ctl = _controller(P, 2, lambda: t[0])
    reqs = [ctl.submit([3, 4, 5], max_new_tokens=4, seed=i)
            for i in range(6)]
    _drive(ctl, t, log)
    ctl.close()
    return ctl, reqs


def scn_disagg(P, t, log):
    ctl = _controller(P, 3, lambda: t[0],
                      roles=("prefill", "decode", "mixed"))
    reqs = [ctl.submit([3, 4, 5], max_new_tokens=4, seed=i)
            for i in range(6)]
    _drive(ctl, t, log)
    log.append([r.transport.obs_responses_out for r in ctl.replicas])
    log.append([ctl.obs_shadow_tokens, P.obs.FleetObserver(ctl).reconcile()])
    ctl.close()
    return ctl, reqs


def scn_disagg_no_decode(P, t, log):
    ctl = _controller(P, 3, lambda: t[0],
                      roles=("prefill", "decode", "mixed"),
                      recover_healthy_ticks=10_000)
    ctl.replicas[1].state = P.fleet.SUSPECT
    reqs = [ctl.submit([2, 3], max_new_tokens=4)]
    _drive(ctl, t, log)
    ctl.replicas[1].state = P.fleet.HEALTHY
    ctl.replicas[1].healthy_streak = 0
    reqs.append(ctl.submit([4, 5], max_new_tokens=4))
    _drive(ctl, t, log)
    log.append([r.transport.obs_responses_out for r in ctl.replicas])
    ctl.close()
    return ctl, reqs


def scn_phase_less_on_mixed(P, t, log):
    clock = lambda: t[0]  # noqa: E731
    trs = [P.fleet.InProcessTransport(_engine(P, clock, phase=r))
           for r in ("prefill", "mixed")]
    ctl = P.fleet.FleetController(trs, P.RequestQueue(capacity=32,
                                                      clock=clock),
                                  policy=P.RouterPolicy(backoff_base_s=0.0))
    reqs = [ctl.submit([1, 2], max_new_tokens=4) for _ in range(4)]
    _drive(ctl, t, log)
    log.append([tr.obs_responses_out for tr in trs])
    return ctl, reqs


class _Severed:
    """A transport whose wire can be cut (``tests/test_fleet.py``'s)."""

    _LOCAL = frozenset(["queue_depth", "queue_capacity", "live_slots",
                        "default_max_new_tokens", "rpc_inflight",
                        "rpc_retries", "close", "idle", "drained"])

    def __init__(self, inner, error):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "error", error)
        object.__setattr__(self, "severed", False)

    def __getattr__(self, name):
        attr = getattr(object.__getattribute__(self, "inner"), name)
        if name in _Severed._LOCAL:
            return attr
        if self.severed:
            raise self.error("wire cut (test)")
        if callable(attr):
            def call(*a, **k):
                if self.severed:
                    raise self.error("wire cut (test)")
                return attr(*a, **k)
            return call
        return attr


def scn_transport_drop(P, t, log):
    clock = lambda: t[0]  # noqa: E731
    trs = [_Severed(P.fleet.InProcessTransport(_engine(P, clock)),
                    P.fleet.TransportError) for _ in range(2)]
    ctl = P.fleet.FleetController(trs, P.RequestQueue(capacity=32,
                                                      clock=clock),
                                  policy=P.RouterPolicy(backoff_base_s=0.0))
    reqs = [ctl.submit([1, 2], max_new_tokens=6, seed=i) for i in range(6)]
    _step(ctl, t, log, 2)
    trs[1].severed = True
    _drive(ctl, t, log)
    return ctl, reqs


def scn_journal_restart(P, t, log, tmp):
    j = P.fleet.RequestJournal(str(tmp / "j"))
    ctl = _controller(P, 2, lambda: t[0], journal=j)
    reqs = [ctl.submit([3, 4, 5], max_new_tokens=4, seed=i)
            for i in range(6)]
    pre = []
    while len(pre) < 2:
        _step(ctl, t, log)
        pre += [d[0] for d in log[-1]["delivered"]]
    st = P.fleet.RequestJournal.recover(j.path)
    log.append(sorted(st.orphans))
    t2 = [0.0]
    fresh = _controller(P, 2, lambda: t2[0])
    ctl2 = P.fleet.FleetController.from_journal(
        st, [r.transport for r in fresh.replicas],
        P.RequestQueue(capacity=32, clock=lambda: t2[0]),
        policy=P.RouterPolicy(backoff_base_s=0.0))
    _drive(ctl2, t2, log)
    log.append(ctl2.submit([1], max_new_tokens=1).id)
    with open(j.path) as f:
        records = [json.loads(line) for line in f]
    # wall times and the random trace ids differ run to run
    log.append([{k: v for k, v in rec.items()
                 if k not in ("wall_time", "trace")} for rec in records])
    return ctl2, reqs


SCENARIOS = [scn_least_loaded, scn_session_affinity, scn_kill_replica,
             scn_wedged_backlog, scn_wedge_replica_window, scn_retry_budget,
             scn_backoff, scn_reclaim, scn_cancel_parked, scn_all_suspect,
             scn_no_deadline_credit, scn_drain, scn_spawn_retire,
             scn_dead_fleet, scn_slow_streak, scn_stuck_slots,
             scn_controller, scn_disagg, scn_disagg_no_decode,
             scn_phase_less_on_mixed, scn_transport_drop]


def _run_both(scn, *extra):
    out = []
    for P in (JAX, TORCH):
        reg = _fresh_registry(P)
        t, log = [0.0], []
        ctl, reqs = scn(P, t, log, *extra)
        out.append({"log": log, "final": _final(ctl, reqs),
                    "metrics": _metrics(reg)})
    return out


@pytest.mark.parametrize("scn", SCENARIOS, ids=lambda f: f.__name__[4:])
def test_fleet_scenario_matches_pipe_tpu(scn):
    """Placements, replica states, parks and deliveries after every tick,
    the responses and attempts of every request, and the registry's
    counters and gauges: the port's fleet equals ``pipe_tpu``'s."""
    want, got = _run_both(scn)
    assert got["log"] == want["log"]
    assert got["final"] == want["final"]
    assert got["metrics"] == want["metrics"]
    # every scenario resolves each submitted id at most once
    ids = [d[0] for entry in got["log"]
           if isinstance(entry, dict) and "delivered" in entry
           for d in entry["delivered"]]
    assert len(ids) == len(set(ids))


def test_journal_restart_matches_pipe_tpu(tmp_path):
    """A controller dropped mid-flight and rebuilt ``from_journal``
    delivers every orphan once, mints no journaled id, and both packages
    write the same journal records apart from wall times."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    out = []
    for P, sub in ((JAX, "jax"), (TORCH, "torch")):
        reg = _fresh_registry(P)
        t, log = [0.0], []
        ctl, reqs = scn_journal_restart(P, t, log, tmp_path / sub)
        # the fsync age is wall time, and the journal's bytes hold the
        # open record's wall time, whose repr varies in length
        out.append({"log": log, "metrics": {
            k: v for k, v in _metrics(reg).items()
            if k not in ("serve.fleet.journal_fsync_age_s",
                         "serve.fleet.journal_bytes")}})
    assert out[1] == out[0]
    records = out[1]["log"][-1]
    assert {r["kind"] for r in records} >= {"open", "submit", "place",
                                            "deliver"}


def test_async_tick_fleet_delivers_like_pipe_tpu():
    """``async_tick=True`` (one tick thread per replica): the deliveries
    race the stepped clock, so what is compared is the outcome -- every id
    once, ``ok``, the same tokens as ``pipe_tpu``'s async fleet."""
    outs = []
    for P in (JAX, TORCH):
        _fresh_registry(P)
        t = [0.0]
        ctl = _controller(P, 2, lambda: t[0], async_tick=True)
        try:
            ids = [ctl.submit([1, 2], max_new_tokens=3, seed=i).id
                   for i in range(5)]
            got = []
            deadline = time.monotonic() + 30.0
            while not ctl.idle:
                t[0] += 0.01
                got.extend(ctl.tick())
                time.sleep(0.002)
                assert time.monotonic() < deadline
            got.extend(ctl.tick())
        finally:
            ctl.close()
        assert sorted(r.request_id for r in got) == sorted(ids)
        outs.append(sorted((r.request_id, r.status, list(r.tokens))
                           for r in got))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# health surfaces, chaos accessors, journal state, topology, roles


def test_watchdog_and_hop_health_match_pipe_tpu():
    for kw in (dict(tick_budget_s=0.0), dict(stuck_slack_ticks=0),
               dict(shed_ewma_threshold=1.5), dict(shed_ewma_threshold=0)):
        with pytest.raises(ValueError) as je:
            jres.TickWatchdog(**kw)
        with pytest.raises(ValueError) as te:
            tres.TickWatchdog(**kw)
        assert str(te.value) == str(je.value)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tres.HopHealth(dead_after=bad)
    rng = np.random.default_rng(0)
    ticks = rng.uniform(0.0, 0.2, 40).tolist()
    outcomes = (rng.uniform(size=40) < 0.3).tolist()
    hops = [(int(s), bool(f)) for s, f in
            zip(rng.integers(0, 3, 60), rng.uniform(size=60) < 0.4)]
    views = []
    for res in (jres, tres):
        wd = res.TickWatchdog(tick_budget_s=0.1, stuck_slack_ticks=3,
                              shed_ewma_threshold=0.5)
        trace = []
        for d, miss in zip(ticks, outcomes):
            trace.append((wd.record_tick(d), wd.record_outcome(miss),
                          wd.slow_streak, wd.slow_ticks, wd.last_tick_s))
        wd.record_stuck()
        trace.append((wd.stuck_slots, wd.miss_ewma,
                      wd.stuck_after(17, 4), wd.stuck_after(1, 1)))
        hh = res.HopHealth(dead_after=3)
        for stage, faulted in hops:
            hh.record(stage, faulted)
            trace.append((hh.streak(stage), hh.faults(stage),
                          hh.dead_hops))
        views.append(trace)
    assert views[1] == views[0]


def test_chaos_accessors_match_pipe_tpu():
    faults = [("transport_drop", dict(step=0, stage=0, microbatch=1)),
              ("transport_corrupt", dict(step=0, stage=1, microbatch=0)),
              ("persistent_hop_drop", dict(step=0, stage=2)),
              ("wire_corrupt", dict(step=3, count=4, stage=1)),
              ("wire_partition", dict(step=9, stage=0, magnitude=0.5)),
              ("wire_dup", dict(step=2, stage=0)),
              ("wire_delay", dict(step=5, stage=1, magnitude=0.01)),
              ("stall_tick", dict(step=4, count=2, magnitude=0.0)),
              ("queue_flood", dict(step=1)),
              ("backend_raise", dict(step=6)),
              ("kill_replica", dict(step=5, count=1, stage=2)),
              ("wedge_replica", dict(step=2, count=3, stage=1)),
              ("slow_replica", dict(step=7, count=2, stage=0))]
    plans = [res.ChaosPlan([res.Fault(k, **kw) for k, kw in faults],
                           seed=11) for res in (jres, tres)]

    def view(p):
        out = []
        for i in range(4):
            for j in range(4):
                out.append(p.transport_fault(i, j))
        for kind in ("wire_partition", "wire_delay", "wire_corrupt",
                     "wire_dup"):
            for idx in range(12):
                for rep in range(3):
                    out.append(repr(p.wire_fault(kind, idx, rep)))
        for kind in ("stall_tick", "queue_flood", "backend_raise"):
            out += [repr(p.serve_fault(kind, k)) for k in range(10)]
        for kind in ("kill_replica", "wedge_replica", "slow_replica"):
            out += [repr(p.replica_fault(kind, k, r))
                    for k in range(10) for r in range(3)]
        out += [p.flood_prompt(i) for i in range(5)]
        return out

    assert view(plans[1]) == view(plans[0])
    for call in (lambda p: p.wire_fault("stall_tick", 0),
                 lambda p: p.serve_fault("kill_replica", 0),
                 lambda p: p.replica_fault("wire_dup", 0, 0)):
        with pytest.raises(ValueError) as je:
            call(plans[0])
        with pytest.raises(ValueError) as te:
            call(plans[1])
        assert str(te.value) == str(je.value)


def test_journal_state_matches_pipe_tpu(tmp_path):
    records = [
        {"kind": "submit", "request": 0, "prompt": [1, 2],
         "max_new_tokens": 9, "seed": 0},
        {"kind": "place", "request": 0, "replica": 0, "attempts": 1},
        {"kind": "shadow", "request": 0, "src": 0, "max_new_tokens": 9},
        {"kind": "submit", "request": 1, "prompt": [3],
         "max_new_tokens": 7, "seed": 1},
        {"kind": "place", "request": 1, "replica": 1, "attempts": 1},
        {"kind": "park", "request": 1, "attempts": 1, "delay_s": 0.5},
        {"kind": "submit", "request": 2, "prompt": [4], "max_new_tokens": 2,
         "seed": 2},
        {"kind": "deliver", "request": 2, "status": "ok",
         "finish_reason": "length"},
    ]
    views = []
    for fleet in (jfleet, tfleet):
        st = fleet.JournalState()
        for rec in records:
            st.apply(rec)
        views.append((sorted(st.orphans), st.max_request_id, st.clean,
                      sorted(st.placed_on.items()), sorted(st.shadow),
                      sorted(st.terminal)))
        with pytest.raises(ValueError):
            fleet.RequestJournal(str(tmp_path / "x")).append("nope")
    assert views[1] == views[0]
    # a torn final line is tolerated, a torn middle line refused
    for fleet, sub in ((jfleet, "j"), (tfleet, "t")):
        j = fleet.RequestJournal(str(tmp_path / sub))
        j.append("submit", request=5, prompt=[1], max_new_tokens=2, seed=0)
        j.close()
        with open(j.path, "a") as f:
            f.write('{"kind": "place", "requ')
        assert fleet.RequestJournal.recover(j.path).max_request_id == 5
        with open(j.path, "a") as f:
            f.write('\n{"kind": "deliver", "request": 5}\n')
        with pytest.raises(ValueError):
            fleet.RequestJournal.recover(j.path)


def test_topology_plans_match_pipe_tpu():
    cases = [dict(n_replicas=4, n_stages=2, n_devices=8),
             dict(n_replicas=2, n_stages=1, n_devices=8,
                  devices_per_process=4),
             dict(n_replicas=3, n_stages=1, n_devices=8),
             dict(n_replicas=2, n_stages=3, n_devices=8),
             dict(n_replicas=2, n_stages=1, n_devices=6,
                  devices_per_process=4)]
    for kw in cases:
        outs = []
        for topo in (jtopo, ttopo):
            try:
                outs.append([vars(r) for r in topo.replica_device_plan(
                    kw["n_replicas"], kw["n_stages"],
                    n_devices=kw["n_devices"],
                    devices_per_process=kw.get("devices_per_process"))])
            except ValueError as e:
                outs.append(str(e))
        assert outs[1] == outs[0]
    role_cases = [[("prefill", 1, 4), ("decode", 1, 2), ("decode", 1, 2)],
                  [{"role": "mixed", "n_stages": 2, "n_data": 2},
                   {"role": "decode"}], [("verify", 1, 1)], []]
    for specs in role_cases:
        outs = []
        for topo in (jtopo, ttopo):
            try:
                outs.append([vars(r) for r in topo.role_device_plan(
                    specs, n_devices=8, devices_per_process=4)])
            except ValueError as e:
                outs.append(str(e))
        assert outs[1] == outs[0]
    assert ttopo.replica_device_plan(1, 1, n_devices=1)[0].n_devices == 1
    for call in (lambda: ttopo.carve_replica_meshes(2, 1),
                 lambda: ttopo.carve_role_meshes([("mixed", 1, 1)])):
        with pytest.raises(NotImplementedError,
                           match="A.8, runtime/distributed.py"):
            call()


def test_suggest_roles_matches_pipe_tpu():
    cases = [dict(n_replicas=4, prompt_len=512, max_new_tokens=64),
             dict(n_replicas=3, prompt_len=32, max_new_tokens=256),
             dict(n_replicas=1, prompt_len=128, max_new_tokens=128),
             dict(n_replicas=5, prefill_token_s=2e-4, decode_token_s=1e-3,
                  prompt_len=1000, max_new_tokens=10)]
    for kw in cases:
        j = jfleet.suggest_roles(**kw)
        t = tfleet.suggest_roles(**kw)
        assert vars(t) == vars(j)
