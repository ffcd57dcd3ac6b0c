"""pipe_tpu_torch's resident serve loop against its own single-chunk tick.

The resident program runs up to ``resident_chunks`` decode chunks per
launch with a device-side ``done`` mask and token budget and stops early
when a live slot goes done. ``pipe_tpu`` writes it as a ``lax.while_loop``;
PyTorch 2.11 captures no conditional graph node, so the port unrolls every
chunk in one graph and freezes the per-slot state past the stop (a "ghost"
chunk). The laws, on the CPU at the config of tests/test_resident.py:

* the resident loop emits bitwise the tokens of the single-chunk tick path,
  slab and paged, greedy and sampled, at a horizon of 3 (several launches);
  greedy also equals JAX's resident ``ServeEngine`` where JAX's top-2
  margin is wide;
* EOS retires a slot at once; the program is captured (here: first run)
  once across staggered mixed lengths and makes one host sync per launch;
  decode ticks and launches make no gather decision; the loop exits on a
  slot free; the knobs are validated; ``"auto"`` picks the loop on cuda;
* a ghost chunk writes into every cache row exactly the bits the next real
  chunk writes there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.serve import BucketSpec as JBucketSpec
from pipe_tpu.serve import ServeEngine as JServeEngine
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.serve import (BucketSpec, RequestQueue, ServeEngine,
                                  SingleDeviceSlotBackend)
from pipe_tpu_torch.serve import engine as engine_mod

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
TIE_MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    tmodel = tlm.PipelinedLM(tlm.LMConfig(**CFG), 2, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, tmodel


def _mixed_prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, CFG["vocab"], size=n)) for n in lengths]


def _backend(model, gen, layout="slab", max_len=16, **kw):
    if layout == "paged":
        kw.setdefault("kv_block_size", 4)
        kw.setdefault("prefill_chunk", 4)
    else:
        kw.setdefault("buckets", BucketSpec.of(4, 8))
    kw.setdefault("num_slots", 2)
    return SingleDeviceSlotBackend(model, max_len=max_len, gen=gen, **kw)


def _drive_staggered(backend, prompts, seed):
    """Mid-flight arrivals: slot churn relaunches with mixed budgets."""
    eng = ServeEngine(backend)
    ids = [eng.submit(prompts[0], seed=seed).id]
    eng.tick()
    ids += [eng.submit(p, seed=seed).id for p in prompts[1:]]
    eng.run_until_idle()
    return [list(eng.response(r).tokens) for r in ids]


def _jax_margin_ok(jmodel, params, prompt, toks):
    sp, pre, post = params
    ctx = JCtx(train=False)
    full = jnp.asarray([list(prompt) + list(toks)], jnp.int32)
    h = jmodel.pre_fn(pre, full, ctx)
    for blocks in sp:
        h = jmodel.stage_fn(blocks, h, ctx)
    logits = np.asarray(jmodel.post_fn(post, h, ctx))[0]
    p = len(prompt)
    top2 = np.sort(logits[p - 1:p - 1 + len(toks)], axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]).min() > TIE_MARGIN


PARITY_CASES = [("slab", 0.0), ("slab", 0.8), ("paged", 0.0),
                ("paged", 0.8)]
PARITY_IDS = [f"{l}-{'greedy' if t == 0.0 else 'sampled'}"
              for l, t in PARITY_CASES]


@pytest.mark.parametrize("layout,temp", PARITY_CASES, ids=PARITY_IDS)
def test_resident_matches_single_chunk_tick(layout, temp, models):
    """resident=True with a small horizon (several launches) emits bitwise
    the tick path's tokens; greedy also equals JAX's resident engine and
    the port's batch-1 Generator."""
    jmodel, params, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=temp,
                           top_k=12 if temp else None)
    prompts = _mixed_prompts((3, 5, 4))
    ref = _drive_staggered(_backend(tmodel, gen, layout, resident=False),
                           prompts, 7)
    got = _drive_staggered(_backend(tmodel, gen, layout, resident=True,
                                    resident_chunks=3), prompts, 7)
    assert got == ref
    if temp == 0.0:
        jkw = (dict(kv_block_size=4, prefill_chunk=4) if layout == "paged"
               else dict(buckets=JBucketSpec.of(4, 8)))
        want = _drive_staggered(JBackend(
            jmodel, params, num_slots=2, max_len=16,
            gen=JGenCfg(max_new_tokens=6, temperature=0.0), resident=True,
            resident_chunks=3, **jkw), prompts, 7)
        one = Generator(tmodel, gen)
        for p, g, w in zip(prompts, got, want):
            assert _jax_margin_ok(jmodel, params, p, w)
            assert g == w == one.generate([p])[0].tolist()


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_resident_eos_retires_early(layout, models):
    """Device-side EOS masking: the resident loop retires at the EOS token
    with the tick path's truncated output and nothing after it."""
    _, _, tmodel = models
    prompts = _mixed_prompts((4, 6))
    free = Generator(tmodel, GenerationConfig(
        max_new_tokens=8, temperature=0.0)).generate([prompts[0]])[0]
    eos = int(free[2])
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0,
                           eos_token_id=eos)
    ref = _drive_staggered(_backend(tmodel, gen, layout, resident=False),
                           prompts, 7)
    got = _drive_staggered(_backend(tmodel, gen, layout, resident=True,
                                    resident_chunks=8), prompts, 7)
    assert got == ref
    assert got[0][-1] == eos and eos not in got[0][:-1]
    assert len(got[0]) <= 3


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_resident_traces_once_and_counts_host_syncs(layout, models):
    """The resident program is prepared once across staggered traffic and
    mixed prompt lengths; every launch is one counted host sync feeding
    the host-overhead-per-token gauge; it never runs the tick program."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = _mixed_prompts((3, 5, 4, 7, 5))
    refs = [Generator(tmodel, gen).generate([p])[0].tolist()
            for p in prompts]
    backend = _backend(tmodel, gen, layout, resident=True,
                       resident_chunks=4)
    reg = get_registry()
    names = ("serve.engine.resident_traces", "serve.engine.decode_traces",
             "serve.engine.host_syncs", "serve.engine.resident_chunks_run",
             "serve.engine.resident_chunks_computed")
    base = {n: reg.counter(n).value for n in names}
    assert _drive_staggered(backend, prompts, 7) == refs
    d = {n: reg.counter(n).value - base[n] for n in names}
    assert d["serve.engine.resident_traces"] == 1
    assert d["serve.engine.decode_traces"] == 0
    assert d["serve.engine.host_syncs"] >= 1
    # every launch computes all 4 chunks; the tokens came from those run
    assert (d["serve.engine.resident_chunks_computed"]
            == 4 * d["serve.engine.host_syncs"])
    assert 0 < d["serve.engine.resident_chunks_run"] <= \
        d["serve.engine.resident_chunks_computed"]
    assert reg.gauge("serve.engine.host_overhead_per_token").value >= 0.0
    assert backend.program_stats()["resident_graph"] is False


@pytest.mark.parametrize("resident", [True, False])
def test_regather_decision_stays_on_device(resident, models):
    """Paged: each prefill refreshes its own slot's view (one counted host
    decision per admission); steady-state ticks, resident or not, make
    none. ``pipe_tpu``'s tick path decides once per tick; the port's
    prefill takes that decision for it."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0)
    reg = get_registry()
    name = "serve.kv.regather_host_decisions"
    eng = ServeEngine(_backend(tmodel, gen, "paged", resident=resident,
                               resident_chunks=1))
    d0 = reg.counter(name).value
    eng.submit(_mixed_prompts((4,))[0], seed=7)
    eng.submit(_mixed_prompts((5,))[0], seed=7)
    eng.tick()          # two prefills + the first decode
    assert reg.counter(name).value - d0 == 2
    eng.tick()
    eng.tick()          # two steady-state ticks: no prefill
    assert reg.counter(name).value - d0 == 2
    eng.run_until_idle()


def test_resident_early_exit_on_slot_free(models):
    """Backend unit: with budgets [2, many] and an 8-chunk horizon the
    launch stops after chunk 2 (slot 0 done): the readout is 2 chunks wide,
    the early-exit counter ticks, and 6 ghost chunks were computed."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0)
    backend = _backend(tmodel, gen, resident=True, resident_chunks=8)
    backend.prefill(0, _mixed_prompts((4,))[0], seed=7)
    backend.prefill(1, _mixed_prompts((5,))[0], seed=7)
    reg = get_registry()
    names = ("serve.engine.device_exits", "serve.engine.resident_chunks_run",
             "serve.engine.resident_chunks_computed")
    base = {n: reg.counter(n).value for n in names}
    toks, valid = backend.decode(np.array([True, True]),
                                 budgets=np.array([2, 100]))
    assert toks.shape == (2, 2) and valid.all()
    d = {n: reg.counter(n).value - base[n] for n in names}
    assert d == {"serve.engine.device_exits": 1,
                 "serve.engine.resident_chunks_run": 2,
                 "serve.engine.resident_chunks_computed": 8}
    # a horizon below the exit: r_max chunks, no early exit counted
    toks, _ = backend.decode(np.array([True, True]),
                             budgets=np.array([100, 100]), r_max=3)
    assert toks.shape == (2, 3)
    assert reg.counter("serve.engine.device_exits").value - base[
        "serve.engine.device_exits"] == 1


def _state(backend):
    """Every KV row and per-slot value the decode programs write."""
    st = backend._state
    out = {n: st[n].clone() for n in ("tok", "pos", "step")}
    if backend.paged:
        out.update({f"pool_{n}": a.clone()
                    for n, a in backend._pool_kv.items()})
        out.update({f"view_{n}": a.clone()
                    for n, a in st["views"].items()})
    else:
        for l, cache in enumerate(st["caches"]):
            out.update({f"{n}{l}": c.clone() for n, c in cache.items()})
    return out


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_ghost_chunk_writes_what_the_next_real_chunk_writes(layout, chunk,
                                                            models):
    """Two launches of one real chunk each with two ghost chunks behind
    them leave every cache row (slab), every pool row and view row (paged)
    bitwise as three real launches without ghosts do: a ghost chunk
    recomputes the next real chunk from the frozen state and writes its
    exact bits into the rows that chunk writes. The frozen per-slot state
    equals two real launches'."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=12, temperature=0.8, top_k=12)
    prompts = _mixed_prompts((3, 4), seed=5)

    def launched(chunks, launches):
        b = _backend(tmodel, gen, layout, decode_chunk=chunk,
                     resident=True, resident_chunks=chunks)
        for slot, p in enumerate(prompts):
            b.prefill(slot, p, seed=11 + slot)
        toks = [b.decode(np.array([True, True]),
                         budgets=np.array([100, 100]), r_max=1)[0]
                for _ in range(launches)]
        return np.concatenate(toks, axis=1), _state(b)

    ghost_toks, ghost = launched(3, 2)
    real2_toks, real2 = launched(1, 2)
    _, real3 = launched(1, 3)
    np.testing.assert_array_equal(ghost_toks, real2_toks)
    for n in ("tok", "pos", "step"):
        assert torch.equal(ghost[n], real2[n])
    rows = [n for n in ghost if n not in ("tok", "pos", "step")]
    assert rows
    for n in rows:
        assert torch.equal(ghost[n], real3[n]), n
    # and the ghosts did write: two real launches alone differ there
    assert any(not torch.equal(ghost[n], real2[n]) for n in rows)


def test_resident_knob_validation(models):
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    with pytest.raises(ValueError, match="resident"):
        _backend(tmodel, gen, resident="yes")
    with pytest.raises(ValueError, match="resident_chunks"):
        _backend(tmodel, gen, resident=True, resident_chunks=0)
    # the speculative lane's knobs, with JAX's messages
    for kw, msg in ((dict(resident=True, spec_tokens=1), "spec_tokens"),
                    (dict(resident=False, spec_tokens=3), "resident"),
                    (dict(resident=True, draft="truncated"),
                     "speculative lane")):
        with pytest.raises(ValueError, match=msg):
            _backend(tmodel, gen, **kw)


def test_auto_picks_the_resident_loop_on_cuda_only(models, monkeypatch):
    """``resident="auto"`` resolves to the resident loop for a cuda
    device and to the single-chunk tick for the CPU (``pipe_tpu``: any
    accelerator). Routed as on the card, the CPU backend then runs the
    resident program, with the tick path's tokens."""
    _, _, tmodel = models
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert engine_mod.resolve_resident("auto", cuda) is True
    assert engine_mod.resolve_resident("auto", cpu) is False
    for forced in (True, False):
        assert engine_mod.resolve_resident(forced, cuda) is forced
        assert engine_mod.resolve_resident(forced, cpu) is forced
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = _mixed_prompts((3, 5, 4))
    reg = get_registry()
    r0 = reg.counter("serve.engine.resident_traces").value
    tick = _backend(tmodel, gen, "paged")
    assert not tick.resident
    want = _drive_staggered(tick, prompts, 7)
    assert reg.counter("serve.engine.resident_traces").value == r0
    route = engine_mod.resolve_resident
    monkeypatch.setattr(engine_mod, "resolve_resident",
                        lambda resident, device: route(resident, cuda))
    auto = _backend(tmodel, gen, "paged")
    assert auto.resident and auto.resident_chunks == 8
    assert _drive_staggered(auto, prompts, 7) == want
    assert reg.counter("serve.engine.resident_traces").value - r0 == 1


def test_resident_horizon_follows_deadlines(models):
    """The launch horizon: the full resident depth with no deadline in
    sight; one chunk before any chunk latency is known; else the soonest
    deadline (live or queued) over the chunk-latency EWMA, clamped."""
    _, _, tmodel = models
    now = [0.0]
    eng = ServeEngine(_backend(tmodel, GenerationConfig(
        max_new_tokens=4, temperature=0.0), resident=True,
        resident_chunks=8), RequestQueue(clock=lambda: now[0]))
    assert eng._resident_horizon(0.0) == 8
    eng.submit([1, 2, 3], timeout_s=0.5)
    assert eng._resident_horizon(0.0) == 1          # no EWMA yet
    eng._chunk_ewma = 0.1
    assert eng._resident_horizon(0.0) == 5
    assert eng._resident_horizon(0.45) == 1
    eng._chunk_ewma = 0.01
    assert eng._resident_horizon(0.0) == 8
