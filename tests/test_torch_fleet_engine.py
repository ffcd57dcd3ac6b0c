"""The port's engine hooks for the fleet (``serve/engine.py``: watchdog,
chaos, disaggregated phases, the KV handoff payload) and the emulator's hop
faults against ``pipe_tpu``'s, on the tiny LM with JAX's weights converted
through ``convert.py``.

* The watchdog and chaos: the same traffic through JAX's ``ServeEngine`` and
  the port's, on a clock that advances a fixed step per read, with the same
  watchdog and chaos plan; the deliveries after every tick (status, reason,
  tokens), the watchdog's read-only surface and the ``resilience.*`` /
  ``serve.engine.*`` counters must be equal (greedy tokens are compared where
  JAX's top-2 margin is wide: the test picks prompts whose streams are clear).
* The phases: a prefill-only engine refuses an unclamped request and a
  decode-only engine a cold multi-block prompt, with JAX's messages.
* The payload: ``export_prefix_payload`` of the same cached prefix, ``raw``
  within 1e-5 x max(1, max|rows|) of JAX's, ``int8`` codes equal or one
  apart at a rounding boundary on at most 0.1% of entries with scales
  within 1e-6 relative; ``import_prefix_payload`` seats the same blocks; a
  decode-only engine over an imported prefix gives the cold mixed engine's
  greedy tokens.
* The emulator: a planned ``transport_drop`` / ``transport_corrupt`` /
  ``persistent_hop_drop`` gives JAX's hop outputs and ``HopHealth`` streaks.
"""

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core import microbatch as jmb
from pipe_tpu.inference import GenerationConfig as JGen
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.obs import telemetry as jtel
from pipe_tpu.parallel import emulator as jemu
from pipe_tpu import resilience as jres
from pipe_tpu.serve import RequestQueue as JQueue
from pipe_tpu.serve import ServeEngine as JEngine
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu_torch import convert
from pipe_tpu_torch import resilience as tres
from pipe_tpu_torch.core import microbatch as tmb
from pipe_tpu_torch.core.partition import Stage
from pipe_tpu_torch.inference import GenerationConfig as TGen
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs import telemetry as ttel
from pipe_tpu_torch.parallel import emulator as temu
from pipe_tpu_torch.serve import RequestQueue as TQueue
from pipe_tpu_torch.serve import ServeEngine as TEngine
from pipe_tpu_torch.serve import SingleDeviceSlotBackend as TBackend

CFG = dict(vocab=61, d_model=16, nhead=2, d_ff=32, n_layers=2, seq_len=64,
           dropout=0.0)
BK = dict(num_slots=2, max_len=48, kv_block_size=8, kv_pool_blocks=24,
          prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), 1)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    tmodel = tlm.PipelinedLM(tlm.LMConfig(**CFG), 1, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, tmodel


_CACHE = {}


def _backends(models, paged=True, max_new=4, key=None):
    """A (JAX, port) backend pair; with ``key``, the module's pair of that
    name (JAX compiles each backend's programs once, the port captures
    them once, so scenarios share backends; every scenario frees its slots,
    and both pools carry the same cached prefixes into the next)."""
    if key is not None:
        k = (key, paged, max_new)
        if k not in _CACHE:
            _CACHE[k] = _backends(models, paged, max_new)
        return _CACHE[k]
    jmodel, params, tmodel = models
    kw = dict(BK) if paged else dict(num_slots=2, max_len=48)
    jb = JBackend(jmodel, params, gen=JGen(max_new_tokens=max_new,
                                           temperature=0.0), **kw)
    tb = TBackend(tmodel, gen=TGen(max_new_tokens=max_new,
                                   temperature=0.0), **kw)
    return jb, tb


class _Clock:
    """Advances ``step`` seconds per read: tick durations are a count of
    clock reads, the same in both engines."""

    def __init__(self, step=0.01):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _prompt(n, k=7, m=53):
    return [(i * k) % m + 1 for i in range(n)]


def _scenario(name, eng, backend, res, clock):
    """Drive ``eng`` through one watchdog/chaos scenario; returns the
    per-tick deliveries."""
    log = []

    def tick(n=1):
        for _ in range(n):
            out = eng.tick()
            log.append([(r.request_id, r.status, r.finish_reason,
                         [int(x) for x in r.tokens]) for r in out])

    def run():
        for _ in range(200):
            if eng.idle:
                return
            tick()
        raise AssertionError("engine not idle")

    if name == "stuck":
        orig = backend.decode

        def no_progress(live, *a, **k):
            toks, valid = orig(live, *a, **k)
            return toks, np.zeros_like(valid)

        backend.decode = no_progress
        eng.submit(_prompt(5), max_new_tokens=4)
        tick(12)
        backend.decode = orig
        run()
    elif name == "shed":
        eng.submit([1, 2], max_new_tokens=2, timeout_s=0.005)
        eng.submit([5, 6, 7], max_new_tokens=2, timeout_s=0.005)
        eng.submit([8, 9, 3], max_new_tokens=2, timeout_s=0.005)
        clock.t += 1.0
        tick()
        eng.submit([3, 4], max_new_tokens=2, priority=-5)
        eng.submit([5, 6], max_new_tokens=2, priority=5)
        eng.submit([9, 9, 9], max_new_tokens=2, priority=1)
        tick()
        run()
    elif name == "slow_ticks":
        for i in range(3):
            eng.submit(_prompt(6 + i, k=3), max_new_tokens=4, seed=i)
        run()
    elif name in ("flood", "backend_raise", "stall"):
        for i in range(3):
            eng.submit(_prompt(9 + i, k=5), max_new_tokens=3, seed=i)
        run()
    elif name == "decode_errors":
        orig = backend.decode
        calls = {"n": 0}

        def flaky(live, *a, **k):
            calls["n"] += 1
            if calls["n"] in (2, 3, 5, 6, 7):
                raise RuntimeError("transient")
            return orig(live, *a, **k)

        backend.decode = flaky
        for i in range(2):
            eng.submit(_prompt(7 + i, k=11), max_new_tokens=4, seed=i)
        run()
        backend.decode = orig
        eng.submit(_prompt(10), max_new_tokens=3)
        run()
    elif name == "drain":
        for i in range(3):
            eng.submit(_prompt(6 + i), max_new_tokens=4, seed=i)
        tick()
        eng.drain()
        for _ in range(50):
            if eng.drained:
                break
            tick()
    return log


SCENARIOS = {
    "stuck": (dict(stuck_slack_ticks=2), None),
    "shed": (dict(shed_ewma_threshold=0.5, shed_ewma_alpha=1.0,
                  stuck_slack_ticks=None), None),
    "slow_ticks": (dict(tick_budget_s=0.045, stuck_slack_ticks=None), None),
    "flood": (dict(stuck_slack_ticks=None),
              [("queue_flood", dict(step=1))]),
    "backend_raise": (dict(stuck_slack_ticks=None),
                      [("backend_raise", dict(step=0))]),
    "stall": (dict(tick_budget_s=0.045, stuck_slack_ticks=None),
              [("stall_tick", dict(step=1, count=2, magnitude=0.001))]),
    "decode_errors": (dict(stuck_slack_ticks=None), None),
    "drain": (None, None),
}

COUNTER_PREFIXES = ("resilience.", "serve.engine.", "serve.kv.")
TIMED = ("tick_sec", "_sec", "host_overhead")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_watchdog_and_chaos_match_pipe_tpu(models, name, paged):
    wd_kw, faults = SCENARIOS[name]
    views = []
    for res, Engine, Queue, tel, b in zip(
            (jres, tres), (JEngine, TEngine), (JQueue, TQueue),
            (jtel, ttel), _backends(models, paged, key="scenarios")):
        reg = tel.MetricsRegistry()
        tel.set_registry(reg)
        clock = _Clock()
        wd = res.TickWatchdog(**wd_kw) if wd_kw is not None else None
        chaos = (res.ChaosPlan([res.Fault(k, **kw) for k, kw in faults],
                               seed=3) if faults else None)
        eng = Engine(b, Queue(capacity=8, policy="priority", clock=clock),
                     watchdog=wd, chaos=chaos, decode_error_limit=3)
        log = _scenario(name, eng, b, res, clock)
        surface = None if wd is None else (
            wd.slow_streak, wd.slow_ticks, wd.stuck_slots,
            round(wd.miss_ewma, 12))
        counters = {k: v for k, v in reg.snapshot().items()
                    if k.startswith(COUNTER_PREFIXES)
                    and isinstance(v, (int, float))
                    and not any(s in k for s in TIMED)}
        views.append((log, surface, counters,
                      eng.consecutive_decode_errors))
    # the port counts a few things of its own (graph captures); the
    # counters both packages keep are compared, apart from the gather
    # decisions, which the port makes once per paged admission where
    # pipe_tpu flags a regather (a deliberate difference of the engine);
    # every resilience.* counter is kept by both
    common = (views[0][2].keys() & views[1][2].keys()) \
        - {"serve.kv.regather_host_decisions"}
    res_keys = [{k for k in v[2] if k.startswith("resilience.")}
                for v in views]
    assert res_keys[1] == res_keys[0]
    diff = {k: (views[0][2][k], views[1][2][k]) for k in common
            if views[0][2][k] != views[1][2][k]}
    assert not diff
    assert [v[:2] + v[3:] for v in views[1:]] == [views[0][:2]
                                                   + views[0][3:]]
    log = views[1][0]
    assert any(entry for entry in log), "the scenario delivered nothing"
    if name in ("slow_ticks", "stall"):
        assert views[1][1][1] > 0, "no tick went over budget"


def test_phase_refusals_match_pipe_tpu(models):
    cases = [("prefill", _prompt(5), 4), ("decode", _prompt(16), 4),
             ("decode", _prompt(40), 8)]
    for phase, prompt, new in cases:
        msgs = []
        for Engine, b in zip((JEngine, TEngine),
                             _backends(models, max_new=8, key="phase")):
            eng = Engine(b, phase=phase)
            with pytest.raises(ValueError) as e:
                eng.submit(prompt, max_new_tokens=new)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    for Engine, b in zip((JEngine, TEngine),
                         _backends(models, key="phase")):
        Engine(b, phase="prefill").submit(_prompt(5), max_new_tokens=1)
        Engine(b, phase="decode").submit(_prompt(5), max_new_tokens=4)
        with pytest.raises(ValueError, match="phase"):
            Engine(b, phase="verify")


def _serve(Engine, backend, prompt, new=4, phase="mixed"):
    eng = Engine(backend, phase=phase)
    eng.submit(list(prompt), max_new_tokens=new, seed=0)
    out = eng.run_until_idle()
    assert len(out) == 1 and out[0].status == "ok"
    return [int(t) for t in out[0].tokens]


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_export_payload_matches_pipe_tpu(models, codec):
    prompt = _prompt(32, k=3 if codec == "raw" else 5)   # 4 full blocks
    jb, tb = _backends(models, key="home")
    assert _serve(TEngine, tb, prompt) == _serve(JEngine, jb, prompt)
    jp = jb.export_prefix_payload(prompt, codec=codec)
    tp = tb.export_prefix_payload(prompt, codec=codec)
    for key in ("hashes", "block_size", "n_layers", "codec",
                "int8_storage"):
        assert tp[key] == jp[key], key
    assert sorted(tp["arrays"]) == sorted(jp["arrays"])
    assert tp["nbytes"] == jp["nbytes"]
    for name, ja in jp["arrays"].items():
        ja, ta = np.asarray(ja), tp["arrays"][name]
        assert ta.shape == ja.shape and ta.dtype == ja.dtype, name
        if ta.dtype == np.int8:
            diff = np.abs(ta.astype(np.int32) - ja.astype(np.int32))
            assert diff.max() <= 1, name
            assert (diff > 0).mean() <= 1e-3, name
        elif name.endswith("_scale") and codec == "int8":
            np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=0)
        else:
            tol = 1e-5 * max(1.0, float(np.abs(ja).max()))
            np.testing.assert_allclose(ta, ja, rtol=0, atol=tol)
    assert jb.export_prefix_payload([60] * 8) is None
    assert tb.export_prefix_payload([60] * 8) is None
    with pytest.raises(ValueError, match="codec"):
        tb.export_prefix_payload(prompt, codec="fp8")


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_import_seats_blocks_and_decode_only_tokens(models, codec):
    """Both packages seat the same blocks for the same payload; the port's
    decode-only engine over them gives the cold mixed engine's greedy
    tokens (raw: the same rows; int8: rows within the codec's rounding)."""
    prompt = _prompt(32, k=9 if codec == "raw" else 11)
    seated = []
    homes = [_backends(models, key=k) for k in ("home", "dest", "cold")]
    for i, Engine in enumerate((JEngine, TEngine)):
        home, dest, cold = (h[i] for h in homes)
        ref = _serve(Engine, home, prompt)
        payload = home.export_prefix_payload(prompt, codec=codec)
        n = dest.import_prefix_payload(payload)
        assert n == len(payload["hashes"])
        assert dest.import_prefix_payload(payload) == 0
        entries = dest.pool.cached_prefix_entries(prompt)
        got = _serve(Engine, dest, prompt, phase="decode")
        seated.append((n, entries, got, _serve(Engine, cold, prompt), ref))
    assert seated[1][:2] == seated[0][:2]
    n, entries, decoded, cold, ref = seated[1]
    assert cold == ref
    if codec == "raw":
        assert decoded == cold
    assert decoded == seated[0][2]
    # geometry mismatch: a silent no-op, the destination re-prefills cold
    payload = homes[0][1].export_prefix_payload(prompt, codec="raw")
    assert TBackend(models[2], gen=TGen(max_new_tokens=4), num_slots=2,
                    max_len=48, kv_block_size=16, kv_pool_blocks=12,
                    prefill_chunk=8).import_prefix_payload(payload) == 0
    assert homes[0][1].import_prefix_payload(
        dict(payload, n_layers=9)) == 0


def test_import_writes_the_pool_in_place(models):
    """The captured programs read the pool tensors' storage: an import
    writes into them and never rebinds them."""
    prompt = _prompt(24, k=5)
    home, dest = _backends(models)[1], _backends(models)[1]
    _serve(TEngine, home, prompt)
    before = {k: (v.data_ptr(), v) for k, v in dest._pool_kv.items()}
    assert dest.import_prefix_payload(
        home.export_prefix_payload(prompt, codec="raw")) > 0
    for name, (ptr, tensor) in before.items():
        assert dest._pool_kv[name] is tensor
        assert tensor.data_ptr() == ptr
        assert dest._state["pool"][name] is tensor


def _emulator_runs(plan_faults):
    rng = np.random.default_rng(7)
    ws = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(3)]
    xs = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(3)]
    jplan = (jres.ChaosPlan([jres.Fault(k, **kw) for k, kw in plan_faults])
             if plan_faults is not None else None)
    tplan = (tres.ChaosPlan([tres.Fault(k, **kw) for k, kw in plan_faults])
             if plan_faults is not None else None)
    jh, th = jres.HopHealth(dead_after=2), tres.HopHealth(dead_after=2)

    def jstage(p, x, ctx):
        return jax.numpy.tanh(x @ p)

    jout = jemu.run([jstage] * 3, [jax.numpy.asarray(w) for w in ws],
                    [jmb.Batch(jax.numpy.asarray(x), atomic=True)
                     for x in xs], chaos=jplan, hop_health=jh)
    tws = [torch.from_numpy(w) for w in ws]
    tstages = [Stage(lambda x, w=w: torch.tanh(x @ w)) for w in tws]
    tout = temu.run(tstages, [tmb.Batch(torch.from_numpy(x), atomic=True)
                              for x in xs], chaos=tplan, hop_health=th)
    j = [np.asarray(b.values[0]) for b in jout]
    t = [b.values[0].numpy() for b in tout]
    streaks = [([h.streak(s) for s in range(3)],
                [h.faults(s) for s in range(3)], h.dead_hops)
               for h in (jh, th)]
    return j, t, streaks


@pytest.mark.parametrize("faults", [
    None,
    [("transport_drop", dict(step=0, stage=0, microbatch=1))],
    [("transport_corrupt", dict(step=0, stage=1, microbatch=0))],
    [("persistent_hop_drop", dict(step=0, stage=1))],
], ids=["clean", "drop", "corrupt", "persistent"])
def test_emulator_hop_faults_match_pipe_tpu(faults):
    j, t, streaks = _emulator_runs(faults)
    assert streaks[1] == streaks[0]
    _, clean, _ = _emulator_runs(None)
    for i, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
        faulted = faults is not None and (
            faults[0][0] == "persistent_hop_drop"
            or faults[0][1]["microbatch"] == i)
        if faulted:
            assert not np.array_equal(b, clean[i])
        else:
            assert np.array_equal(b, clean[i])
    if faults is not None and faults[0][0] == "transport_corrupt":
        assert np.isnan(t[0]).all()


def test_corrupt_hop_fills_integer_payloads():
    b = tmb.Batch((torch.arange(4), torch.ones(2), "rider"), atomic=False)
    out = temu._corrupt_hop(b, "corrupt").values
    assert out[0].tolist() == [-1] * 4 and torch.isnan(out[1]).all()
    assert out[2] == "rider"
    assert temu._corrupt_hop(b, "drop").values[0].tolist() == [0] * 4
