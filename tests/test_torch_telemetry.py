"""The port's copy of the telemetry core (``pipe_tpu_torch/obs``) against
pipe_tpu's: the registry laws of tests/test_telemetry.py that touch only the
copied part — counters, gauges, EWMA timers, histogram percentiles, the
null registry's no-op contract, snapshots and their mergeable wire form —
plus ``percentile_exact``, ``labelled``, ``host_overhead_per_token`` and the
JSONL ``EventLog`` (span nesting, rotation, torn-line tolerance), each run
on both packages' modules. Then the port's ``Generator(phase_timing=True)``,
which records into the registry.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.obs import events as jev
from pipe_tpu.obs import telemetry as jtel
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs import events as tev
from pipe_tpu_torch.obs import telemetry as ttel

TEL = {"jax": jtel, "port": ttel}
EV = {"jax": jev, "port": tev}
PKGS = ["jax", "port"]


@pytest.fixture(params=PKGS)
def tel(request):
    """(telemetry module, a fresh registry installed as its default)."""
    mod = TEL[request.param]
    prev = mod.get_registry()
    reg = mod.MetricsRegistry()
    mod.set_registry(reg)
    yield mod, reg
    mod.set_registry(prev)


@pytest.fixture(params=PKGS)
def ev(request):
    return EV[request.param]


def test_counter_gauge_timer_histogram(tel):
    _, registry = tel
    registry.counter("c").inc()
    registry.counter("c").inc(4)
    assert registry.counter("c").value == 5
    registry.gauge("g").set(2.5)
    assert registry.gauge("g").value == 2.5
    t = registry.timer("t")
    t.observe(1.0)
    t.observe(2.0)
    assert t.count == 2 and t.total == 3.0 and t.last == 2.0
    assert t.ewma == pytest.approx(1.1)
    h = registry.histogram("h")
    for v in [0.001, 0.002, 0.004, 1.0]:
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and s["min"] == 0.001 and s["max"] == 1.0
    assert s["sum"] == pytest.approx(1.007)
    assert h.percentile(0.5) >= 0.002
    assert h.percentile(0.99) >= 1.0


def test_histogram_percentiles_equal_across_packages():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-6, 2, size=500).tolist()
    hs = [TEL[p].Histogram() for p in PKGS]
    for h in hs:
        for v in vals:
            h.observe(v)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert hs[0].percentile(q) == hs[1].percentile(q)
    assert hs[0].summary() == hs[1].summary()
    assert hs[0].counts == hs[1].counts


def test_instruments_are_interned_per_name(tel):
    _, registry = tel
    assert registry.counter("x") is registry.counter("x")
    assert registry.timer("y") is registry.timer("y")


def test_timer_context_manager(tel):
    _, registry = tel
    with registry.timer("ctx").time():
        pass
    assert registry.timer("ctx").count == 1
    with registry.histogram("hctx").time():
        pass
    assert registry.histogram("hctx").summary()["count"] == 1


def test_snapshot_and_scalars(tel):
    _, registry = tel
    registry.counter("a.b").inc(3)
    registry.gauge("a.g").set(7.0)
    registry.timer("a.t").observe(0.5)
    registry.histogram("a.h").observe(0.25)
    snap = registry.snapshot()
    assert snap["a.b"] == 3
    assert snap["a.g"] == 7.0
    assert snap["a.t"]["count"] == 1
    assert snap["a.h"]["count"] == 1
    flat = registry.scalars()
    assert flat["a.b"] == 3.0 and flat["a.g"] == 7.0
    assert "a.t.ewma" in flat and "a.h.p50" in flat
    registry.reset()
    assert registry.snapshot() == {}


def test_mergeable_snapshot_folds_into_the_other_package():
    """A delta snapshot from one package's registry merges into the
    other's, both ways, with the same result."""
    out = []
    for src, dst in (("jax", "port"), ("port", "jax")):
        a = TEL[src].MetricsRegistry()
        a.counter("c").inc(3)
        a.gauge("g").set(1.5)
        a.timer("t").observe(0.25)
        for v in (0.001, 0.5, 2.0):
            a.histogram("h").observe(v)
        base = {}
        first = a.snapshot(mergeable=True, base=base)
        a.counter("c").inc(2)
        second = a.snapshot(mergeable=True, base=base)
        assert set(second) == {"c"} and second["c"]["d"] == 2
        b = TEL[dst].MetricsRegistry()
        b.merge_snapshot(first)
        b.merge_snapshot(second)
        out.append(b.snapshot())
    assert out[0] == out[1]
    assert out[0]["c"] == 5 and out[0]["h"]["count"] == 3


def test_disabled_registry_hands_back_shared_null_instrument(tel):
    mod, _ = tel
    reg = mod.null_registry()
    assert reg.counter("anything") is mod.NULL_INSTRUMENT
    assert reg.histogram("other") is mod.NULL_INSTRUMENT
    reg.counter("anything").inc(10)
    reg.gauge("g").set(1.0)
    with reg.timer("t").time():
        pass
    assert reg.snapshot() == {}


def test_disabled_registry_no_observe_calls(tel, monkeypatch):
    """The null time() context does not route through observe."""
    mod, _ = tel
    calls = []
    monkeypatch.setattr(type(mod.NULL_INSTRUMENT), "observe",
                        lambda self, s: calls.append(s))
    reg = mod.MetricsRegistry(enabled=False)
    for _ in range(100):
        with reg.timer("t").time():
            pass
        reg.counter("c").inc()
    assert calls == []
    assert reg._instruments == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_percentile_exact(pkg):
    pe = TEL[pkg].percentile_exact
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert pe(vals, 0.5) == 3.0
    assert pe(vals, 0.99) == 5.0
    assert pe(vals, 0.0) == 1.0
    assert pe([], 0.5) == 0.0


def test_labelled_names_match():
    for kw in ({}, {"replica": 2}, {"b": "host.1", "a": "x,y=z"}):
        assert ttel.labelled("m", **kw) == jtel.labelled("m", **kw)


def test_host_overhead_per_token(tel):
    mod, registry = tel
    assert mod.host_overhead_per_token() == 0.0
    registry.timer("serve.engine.host_sec").observe(0.3)
    registry.timer("serve.engine.host_sec").observe(0.1)
    registry.counter("serve.engine.tokens").inc(8)
    assert mod.host_overhead_per_token() == pytest.approx(0.05)


def test_null_event_log_writes_nothing(ev, tmp_path):
    log = ev.NULL_EVENT_LOG
    with log.span(ev.STEP, step=0):
        log.event("anything", x=1)
    log.flush()
    log.close()
    assert os.listdir(tmp_path) == []


def test_event_log_jsonl_roundtrip_nested_spans(ev, tmp_path):
    path = str(tmp_path / "events.jsonl")
    with ev.EventLog(path) as log:
        with log.span(ev.STEP, step=0) as step_id:
            with log.span(ev.STAGE, stage=1) as stage_id:
                with log.span(ev.MICROBATCH, microbatch=2):
                    pass
            log.event("profile_trace", path="trace")
        assert stage_id != step_id
    records = ev.EventLog.read(path)
    assert records[0]["kind"] == "log_open"
    by_kind = {}
    for r in records:
        by_kind.setdefault(r["kind"], []).append(r)
    mbr, = by_kind[ev.MICROBATCH]
    st, = by_kind[ev.STAGE]
    sp, = by_kind[ev.STEP]
    assert mbr["parent"] == st["id"] and st["parent"] == sp["id"]
    assert sp["parent"] is None and sp["step"] == 0
    assert all(r["dur"] >= 0 for r in (mbr, st, sp))
    assert by_kind["profile_trace"][0]["parent"] == sp["id"]
    with open(path) as f:
        for line in f:
            json.loads(line)


def test_event_log_metrics_snapshot(ev, tmp_path):
    registry = TEL["jax" if ev is jev else "port"].MetricsRegistry()
    registry.counter("k").inc(2)
    path = str(tmp_path / "events.jsonl")
    with ev.EventLog(path) as log:
        log.metrics_snapshot(registry)
    snap = [r for r in ev.EventLog.read(path) if r["kind"] == "metrics"][0]
    assert snap["metrics"]["k"] == 2


def test_event_log_rotates_and_tolerates_a_torn_last_line(ev, tmp_path):
    path = str(tmp_path / "events.jsonl")
    with ev.EventLog(path, max_bytes=2048) as log:
        for i in range(60):
            log.event("tick", i=i, pad="x" * 20)
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) <= 2048
    head = ev.EventLog.read(path)[0]
    assert head["kind"] == "log_open" and head["rotated"]
    with open(path, "a") as f:
        f.write('{"kind": "tick", "i"')
    assert ev.EventLog.read(path)[-1]["kind"] == "tick"
    with pytest.raises(ValueError):
        ev.EventLog(path, max_bytes=10)
    assert ev.REQUEST == "request" and ev.REQUEST in ev.SPAN_KINDS


def test_generator_phase_timing_records_prefill_and_decode():
    """``phase_timing=True`` times a prefill-only pass per call: the call's
    seconds, its tokens, and the prefill/decode split land in the
    registry; the tokens are those of an untimed call."""
    prev = ttel.get_registry()
    reg = ttel.MetricsRegistry()
    ttel.set_registry(reg)
    try:
        model = tlm.PipelinedLM(tlm.LMConfig().tiny(), 2, device="cpu")
        cfg = GenerationConfig(max_new_tokens=5, temperature=0.0)
        prompt = np.ones((2, 4), np.int64)
        out = Generator(model, cfg, phase_timing=True).generate(prompt)
        assert reg.histogram("serve.generate_sec").count == 1
        assert reg.histogram("serve.prefill_sec").count == 1
        assert reg.histogram("serve.decode_sec").count == 1
        assert reg.counter("serve.tokens").value == 10
        assert reg.gauge("serve.tokens_per_sec").value > 0
        Generator(model, cfg).generate(prompt)
        assert reg.histogram("serve.prefill_sec").count == 1
        assert reg.histogram("serve.generate_sec").count == 2
        ttel.set_registry(ttel.null_registry())
        assert torch.equal(Generator(model, cfg, phase_timing=True)
                           .generate(prompt), out)
    finally:
        ttel.set_registry(prev)
