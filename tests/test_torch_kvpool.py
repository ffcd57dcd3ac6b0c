"""pipe_tpu_torch's paged KV pool (serve/kvpool.py) against pipe_tpu's.

Three layers, each held to the JAX package on the same inputs:

* the host allocator: the port's ``KvPool`` and JAX's get the same op
  sequences (admit, release with and without ``failed``, invalidate,
  eviction under pressure, offload to a ``HostKvStore`` and restore),
  fixed and drawn by ``hypothesis`` (a derandomized profile), and must give
  equal tables, admissions (``resume_from``, COW forks, restores and their
  payloads), ``stats()``, ``PoolExhausted`` detail and counters;
* the device helpers: the same numpy pool, tables and rows (fp32, and int8
  codes with their scales) through both frameworks' ``storage_for``,
  ``flat_row_index``, ``gather_block_cache``, ``scatter_block_rows`` and
  ``copy_block``, bit for bit;
* the paged engine on the tiny config of tests/test_kvpool.py, with JAX's
  weights converted through ``convert.py``: greedy tokens equal JAX's paged
  ``ServeEngine`` and the port's batch-1 ``Generator`` wherever JAX's top-2
  margin is wide (TIE_MARGIN), over staggered mixed lengths, a shared
  prefix with a copy-on-write fork, and offload -> restore.

Then the laws of tests/test_kvpool.py and tests/test_kv_radix.py that need
no ring, router or fleet, on the port's pool and engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.obs.telemetry import get_registry as jget_registry
from pipe_tpu.serve import ServeEngine as JServeEngine
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu.serve import kvpool as jkv
from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.inference.quant import quantize_kv_rows
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.serve import (BucketSpec, RequestQueue, ServeEngine,
                                  SingleDeviceSlotBackend)
from pipe_tpu_torch.serve import kvpool as tkv

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
# The two frameworks' fp32 logits differ by ~1e-6 here; a JAX top-2 margin
# below this would let rounding pick the other token.
TIE_MARGIN = 1e-4
COUNTERS = ("serve.kv.evictions", "serve.kv.offload_out",
            "serve.kv.offload_restores", "serve.kv.offload_dropped",
            "serve.kv.offload_bytes", "serve.kv.prefix_hits",
            "serve.kv.prefix_misses", "serve.kv.prefix_whole_hits",
            "serve.kv.cow_forks")


@pytest.fixture(scope="module")
def models():
    """(JAX PipelinedLM, its numpy params, the port's PipelinedLM holding
    the same weights)."""
    jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    tmodel = tlm.PipelinedLM(tlm.LMConfig(**CFG), 2, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, tmodel


def _mixed_prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, CFG["vocab"], size=n)) for n in lengths]


def _fake_payload(bid):
    # deterministic per-physical-block content, two dtypes, so a bitwise
    # round trip covers fp32 and int8 storage at once
    rng = np.random.RandomState(bid)
    return {"k": rng.randn(2, 4, 8).astype(np.float32),
            "scale": np.full((2, 4), float(bid), np.float32),
            "codes": rng.randint(-128, 128, (2, 4, 8)).astype(np.int8)}


def _pool(**kw):
    kw.setdefault("num_blocks", 9)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 16)
    return tkv.KvPool(**kw)


def _conserved(pool):
    s = pool.stats()
    return (s["blocks_free"] + s["blocks_in_use"] + s["blocks_evictable"]
            == s["blocks_total"])


# ---------------------------------------------------------------------------
# the host allocator against pipe_tpu's, op for op


def _replay(mod, registry, ops, *, store=None, **pool_kw):
    """Run ``ops`` on ``mod``'s pool: one record per op (its outcome, the
    table, ``stats()``), then the counter rises, the directory and the hot
    prefixes."""
    reg = registry()
    base = {n: reg.counter(n).value for n in COUNTERS}
    pool = mod.KvPool(**pool_kw)
    if store is not None:
        pool.attach_offload(mod.HostKvStore(**store), _fake_payload)
    out = []
    for op in ops:
        kind, slot = op[0], op[1]
        if kind == "admit":
            _, _, prompt, new, chunk = op
            can = pool.can_admit(len(prompt), new, prompt, chunk=chunk)
            try:
                a = pool.admit(slot, prompt, new, chunk=chunk)
            except mod.PoolExhausted as e:
                rec = ("exhausted", can, str(e), e.demand, e.free,
                       e.evictable, e.total)
            except RuntimeError as e:
                rec = ("error", can, str(e))
            else:
                rec = ("admitted", can, a.slot, a.table.tolist(),
                       a.resume_from, a.shared_len, a.prefix_hits,
                       list(a.cow_forks), list(a.blocks), a.rows_needed,
                       [(d, sorted((k, v.dtype.str, v.tobytes())
                                   for k, v in p.items()))
                        for d, p in a.restores])
        elif kind == "release":
            pool.release(slot, failed=op[2])
            rec = ("released",)
        else:
            rec = ("invalidated", pool.invalidate(pool.prefix_hashes(op[2])))
        out.append((rec, pool.table.tolist(), pool.stats(),
                    pool.offloaded_blocks))
    return (out, {n: reg.counter(n).value - base[n] for n in COUNTERS},
            pool.prefix_digest_summary(), pool.hot_prefixes(1))


def _both(ops, **kw):
    got = _replay(tkv, get_registry, ops, **kw)
    want = _replay(jkv, jget_registry, ops, **kw)
    assert got == want
    return got


_SHARED = _mixed_prompts((12,), seed=40)[0]
_FIXED_OPS = [
    ("admit", 0, _SHARED + [3, 4], 3, 4),
    ("admit", 1, _SHARED[:8] + [7], 2, 4),           # radix partial hit
    ("release", 0, False),
    ("admit", 0, _SHARED, 2, 4),                     # full hit: COW fork
    ("admit", 2, _mixed_prompts((13,), seed=41)[0], 6, 2),  # pressure
    ("release", 1, False),
    ("release", 2, True),                            # failed: unpublish
    ("admit", 1, _mixed_prompts((9,), seed=42)[0], 8, 4),
    ("admit", 2, _SHARED + [9], 2, 4),               # restores
    ("invalidate", 0, _SHARED),
    ("release", 0, False), ("release", 1, False), ("release", 2, False),
    ("admit", 0, list(range(1, 40)), 4, 4),          # never fits
    ("admit", 0, _SHARED + [3, 4], 3, 1),
    ("admit", 0, _SHARED, 3, 1),                     # admitted twice
]


@pytest.mark.parametrize("store", [
    None, dict(), dict(max_blocks=2), dict(max_bytes=600)],
    ids=["no-offload", "offload", "store-2-blocks", "store-600-bytes"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_pool_matches_pipe_tpu_on_a_fixed_sequence(store, prefix_cache):
    """Hits, a radix split, a COW fork, eviction and offload under
    pressure, a failed release, a restore, an invalidate, a request that
    never fits and a double admit: the same records op for op."""
    out, counts, _, _ = _both(_FIXED_OPS, store=store, num_blocks=9,
                              block_size=4, num_slots=3, max_len=32,
                              prefix_cache=prefix_cache,
                              gather_slack_rows=4)
    assert any(rec[0][0] == "exhausted" for rec in out)
    if prefix_cache:
        assert counts["serve.kv.prefix_hits"] > 0
        assert counts["serve.kv.cow_forks"] > 0


_PREFIXES = [_mixed_prompts((16,), seed=50 + i)[0] for i in range(3)]


@st.composite
def _op_sequences(draw):
    """Admissions into free slots of prompts that share leading blocks
    (one of three prefixes cut at a drawn length, then a drawn tail),
    releases (some failed), invalidations of drawn prompts."""
    n_slots = 3
    held = [False] * n_slots
    ops = []
    for _ in range(draw(st.integers(4, 24))):
        kind = draw(st.sampled_from(["admit", "admit", "release",
                                     "invalidate"]))
        base = draw(st.sampled_from(_PREFIXES))
        prompt = (base[:draw(st.integers(1, 16))]
                  + draw(st.lists(st.integers(1, 88), max_size=6)))
        if kind == "admit":
            free = [s for s in range(n_slots) if not held[s]]
            if not free:
                continue
            slot = draw(st.sampled_from(free))
            held[slot] = True
            ops.append(("admit", slot, prompt, draw(st.integers(1, 12)),
                        draw(st.sampled_from([1, 2, 4]))))
        elif kind == "release":
            slot = draw(st.integers(0, n_slots - 1))
            held[slot] = False
            ops.append(("release", slot, draw(st.booleans())))
        else:
            ops.append(("invalidate", 0, prompt))
    return ops


@settings(max_examples=60, derandomize=True, deadline=None,
          database=None, suppress_health_check=[HealthCheck.too_slow])
@given(ops=_op_sequences(),
       store=st.sampled_from([None, dict(), dict(max_blocks=3)]),
       num_blocks=st.integers(4, 14),
       prefix_cache=st.booleans())
def test_pool_matches_pipe_tpu_on_drawn_sequences(ops, store, num_blocks,
                                                  prefix_cache):
    _both(ops, store=store, num_blocks=num_blocks, block_size=4,
          num_slots=3, max_len=32, prefix_cache=prefix_cache,
          gather_slack_rows=4)


def test_hash_helpers_match_pipe_tpu():
    prompt = _mixed_prompts((21,), seed=3)[0]
    for bs in (1, 4, 8):
        assert tkv.prefix_hashes(prompt, bs) == jkv.prefix_hashes(prompt, bs)
    h = tkv.prefix_hashes(prompt, 4)
    for resident in (set(h), {h[0], h[2]}, set()):
        assert (tkv.prefix_match_depth(h, resident)
                == jkv.prefix_match_depth(h, resident))
    for args in ((5, 6, 4), (4, 1, 4), (1, 16, 4), (100, 28, 16)):
        assert tkv.block_demand(*args) == jkv.block_demand(*args)


# ---------------------------------------------------------------------------
# device helpers against pipe_tpu's


L, NB, BS, H, D = 2, 6, 4, 3, 5


def _np_pool(int8, seed=0):
    rng = np.random.RandomState(seed)
    if int8:
        pool = {n: rng.randint(-127, 128, (L, NB, BS, H, D)).astype(np.int8)
                for n in ("k", "v")}
        pool.update({n + "_scale": rng.rand(L, NB, BS, H, 1).astype(
            np.float32) + 0.01 for n in ("k", "v")})
        return pool
    return {n: rng.randn(L, NB, BS, H, D).astype(np.float32)
            for n in ("k", "v")}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_storage_for_matches_pipe_tpu(kv_dtype):
    jproto = {n: jnp.zeros((1, 16, H, D), jnp.float32) for n in ("k", "v")}
    tproto = {n: torch.zeros((1, 16, H, D)) for n in ("k", "v")}
    want = jkv.storage_for(jproto, L, NB, BS, kv_dtype=kv_dtype)
    got = tkv.storage_for(tproto, L, NB, BS, kv_dtype=kv_dtype)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape
        assert str(got[name].dtype).split(".")[-1] == str(a.dtype)
        assert not got[name].any()
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.storage_for(tproto, L, NB, BS, kv_dtype="fp8")
    with pytest.raises(TypeError, match="prototype"):
        tkv.storage_for({"k": tproto["k"]}, L, NB, BS)


def test_flat_row_index_matches_pipe_tpu():
    table = np.array([3, 5, 1, 0, 0], np.int32)       # 3 reserved blocks
    pos = np.arange(0, 30)                            # past the table too
    want = np.asarray(jkv.flat_row_index(jnp.asarray(table),
                                         jnp.asarray(pos, jnp.int32), BS))
    got = tkv.flat_row_index(torch.from_numpy(table.astype(np.int64)),
                             torch.from_numpy(pos), BS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[BS * 4:] < BS).all()                  # overshoot -> block 0
    # one table row per slot, positions per slot
    tables = np.stack([table, np.array([2, 4, 0, 0, 0], np.int32)])
    p2 = np.stack([pos[:7], pos[3:10]])
    batched = tkv.flat_row_index(torch.from_numpy(tables.astype(np.int64)),
                                 torch.from_numpy(p2), BS)
    for s in range(2):
        np.testing.assert_array_equal(
            batched[s].numpy(), np.asarray(jkv.flat_row_index(
                jnp.asarray(tables[s]), jnp.asarray(p2[s], jnp.int32), BS)))


@pytest.mark.parametrize("int8", [False, True])
def test_gather_block_cache_matches_pipe_tpu(int8):
    pool = _np_pool(int8)
    table = np.array([4, 2, 5, 0], np.int32)
    for layer in range(L):
        want = jkv.gather_block_cache(
            {n: jnp.asarray(a[layer]) for n, a in pool.items()},
            jnp.asarray(table), block_size=BS, compute_dtype=jnp.float32)
        got = tkv.gather_block_cache(
            {n: torch.from_numpy(a[layer]) for n, a in pool.items()},
            torch.from_numpy(table.astype(np.int64)), block_size=BS,
            compute_dtype=torch.float32)
        for name in ("k", "v"):
            assert got[name].shape == (1, 3 * BS, H, D)
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    # [S, W] tables give [S, R, ...]: row s is table s's gather
    tables = np.stack([table, np.array([1, 3, 0, 0], np.int32)])
    got = tkv.gather_block_cache(
        {n: torch.from_numpy(a[0]) for n, a in pool.items()},
        torch.from_numpy(tables.astype(np.int64)), block_size=BS,
        compute_dtype=torch.float32)
    for s in range(2):
        one = tkv.gather_block_cache(
            {n: torch.from_numpy(a[0]) for n, a in pool.items()},
            torch.from_numpy(tables[s].astype(np.int64)), block_size=BS,
            compute_dtype=torch.float32)
        assert torch.equal(got["k"][s], one["k"][0])


@pytest.mark.parametrize("int8", [False, True])
def test_scatter_block_rows_matches_pipe_tpu(int8):
    pool = _np_pool(int8, seed=1)
    rng = np.random.RandomState(2)
    idx = np.array([5, 9, 14, 22, 23], np.int64)        # unique rows
    rows = {n: rng.randn(len(idx), H, D).astype(np.float32)
            for n in ("k", "v")}
    layer = 1
    want = jkv.scatter_block_rows(
        {n: jnp.asarray(a[layer]) for n, a in pool.items()},
        jnp.asarray(idx, jnp.int32), {n: jnp.asarray(r)
                                      for n, r in rows.items()})
    tpool = {n: torch.from_numpy(a[layer].copy()) for n, a in pool.items()}
    got = tkv.scatter_block_rows(tpool, torch.from_numpy(idx),
                                 {n: torch.from_numpy(r)
                                  for n, r in rows.items()})
    assert got is tpool                                   # in place
    for name, a in want.items():
        assert got[name].dtype == (torch.int8 if int8 and "scale" not in
                                   name else torch.float32)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(a))
    if int8:
        q, s = quantize_kv_rows(torch.from_numpy(rows["k"]))
        flat = got["k"].view(NB * BS, H, D)
        assert torch.equal(flat[torch.from_numpy(idx)], q)


@pytest.mark.parametrize("int8", [False, True])
def test_copy_block_matches_pipe_tpu(int8):
    pool = _np_pool(int8, seed=3)
    want = jkv.copy_block({n: jnp.asarray(a) for n, a in pool.items()},
                          jnp.int32(4), jnp.int32(1))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    got = tkv.copy_block(tpool, torch.tensor([4]), torch.tensor([1]))
    for name, a in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(a))
    assert torch.equal(got["k"][:, 1], got["k"][:, 4])


# ---------------------------------------------------------------------------
# the paged engine against pipe_tpu's


def _assert_no_near_tie(jmodel, params, prompt, toks):
    """JAX's top-2 margin at every position that chose one of ``toks``."""
    sp, pre, post = params
    ctx = JCtx(train=False)
    full = jnp.asarray([list(prompt) + list(toks)], jnp.int32)
    h = jmodel.pre_fn(pre, full, ctx)
    for blocks in sp:
        h = jmodel.stage_fn(blocks, h, ctx)
    logits = np.asarray(jmodel.post_fn(post, h, ctx))[0]
    p = len(prompt)
    top2 = np.sort(logits[p - 1:p - 1 + len(toks)], axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min()
    assert margin > TIE_MARGIN, f"near tie in JAX's logits: {margin:.2e}"


def _paged(model, gen, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_chunk", 4)
    return SingleDeviceSlotBackend(model, max_len=16, gen=gen,
                                   kv_block_size=4, **kw)


def _jpaged(jmodel, params, gen, **kw):
    kw.setdefault("num_slots", 2)
    return JBackend(jmodel, params, max_len=16, gen=gen, kv_block_size=4,
                    prefill_chunk=4, **kw)


def _staggered(eng, prompts, seed):
    ids = [eng.submit(prompts[0], seed=seed).id]
    eng.tick()
    ids += [eng.submit(p, seed=seed).id for p in prompts[1:3]]
    eng.tick()
    ids += [eng.submit(p, seed=seed).id for p in prompts[3:]]
    eng.run_until_idle()
    return [eng.response(i) for i in ids]


def _serial(eng, prompts, seed):
    out = []
    for p in prompts:
        rid = eng.submit(p, seed=seed).id
        eng.run_until_idle()
        out.append(eng.response(rid))
    return out


def _one_shot(tmodel, prompts, gen):
    g = Generator(tmodel, gen)
    return [g.generate([p])[0].tolist() for p in prompts]


def test_paged_staggered_equals_pipe_tpu_and_one_program(models):
    """Mixed prompt lengths arriving mid-flight through the paged backend:
    JAX's paged engine's tokens and the port's batch-1 Generator's, with
    ONE decode and ONE chunk-program trace across all five lengths, and
    the pool drained back to empty."""
    jmodel, params, tmodel = models
    prompts = _mixed_prompts((3, 5, 4, 7, 5))
    want = [r.tokens for r in _staggered(JServeEngine(_jpaged(
        jmodel, params, JGenCfg(max_new_tokens=6, temperature=0.0))),
        prompts, 7)]
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    refs = _one_shot(tmodel, prompts, gen)
    reg = get_registry()
    d0 = reg.counter("serve.engine.decode_traces").value
    c0 = reg.counter("serve.engine.prefill_chunk_traces").value
    backend = _paged(tmodel, gen)
    resps = _staggered(ServeEngine(backend), prompts, 7)
    for prompt, resp, w, ref in zip(prompts, resps, want, refs):
        _assert_no_near_tie(jmodel, params, prompt, w)
        assert resp.status == "ok" and resp.finish_reason == "length"
        assert resp.tokens == w == ref
    assert reg.counter("serve.engine.decode_traces").value - d0 == 1
    assert reg.counter("serve.engine.prefill_chunk_traces").value - c0 == 1
    assert backend.program_stats() == {
        "prefill_programs": 1, "decode_chunk": 1, "kv": "paged",
        "decode_graph": False}
    assert backend.pool.stats()["blocks_in_use"] == 0


def test_shared_prefix_cow_equals_pipe_tpu(models):
    """A shared system prompt reuses its cached blocks (prefix hits) and a
    repeat of the bare prompt forks the block its recompute tail rewrites
    (COW forks): tokens equal JAX's paged engine and cold one-shot runs."""
    jmodel, params, tmodel = models
    sys_prompt = _mixed_prompts((8,), seed=11)[0]    # exactly 2 blocks
    prompts = [sys_prompt + [3], sys_prompt + [5, 6], sys_prompt,
               sys_prompt]
    want = [r.tokens for r in JServeEngine(_jpaged(
        jmodel, params, JGenCfg(max_new_tokens=5, temperature=0.0),
        kv_pool_blocks=17)).serve(prompts, seeds=[2] * 4)]
    gen = GenerationConfig(max_new_tokens=5, temperature=0.0)
    refs = _one_shot(tmodel, prompts, gen)
    reg = get_registry()
    h0 = reg.counter("serve.kv.prefix_hits").value
    f0 = reg.counter("serve.kv.cow_forks").value
    ft0 = reg.counter("serve.kv.fork_traces").value
    resps = ServeEngine(_paged(tmodel, gen, kv_pool_blocks=17)).serve(
        prompts, seeds=[2] * 4)
    for prompt, resp, w, ref in zip(prompts, resps, want, refs):
        _assert_no_near_tie(jmodel, params, prompt, w)
        assert resp.tokens == w == ref
    assert reg.counter("serve.kv.prefix_hits").value - h0 > 0
    assert reg.counter("serve.kv.cow_forks").value - f0 > 0
    assert reg.counter("serve.kv.fork_traces").value - ft0 == 1


def _offload_workload():
    shared = _mixed_prompts((8,), seed=21)[0]     # 2 cacheable blocks
    filler = _mixed_prompts((12,), seed=22)[0]    # evicts them
    return [shared + [3, 5], filler, shared + [7, 9]]


def test_offload_restore_equals_pipe_tpu(models):
    """Spill mid-run, restore on re-reference: greedy tokens equal JAX's
    engine on the same tight pool and the port's cold one-shot runs."""
    jmodel, params, tmodel = models
    prompts = _offload_workload()
    want = [r.tokens for r in _serial(JServeEngine(_jpaged(
        jmodel, params, JGenCfg(max_new_tokens=4, temperature=0.0),
        kv_pool_blocks=6, kv_offload=True)), prompts, 6)]
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    refs = _one_shot(tmodel, prompts, gen)
    reg = get_registry()
    o0 = reg.counter("serve.kv.offload_out").value
    r0 = reg.counter("serve.kv.offload_restores").value
    resps = _serial(ServeEngine(_paged(tmodel, gen, kv_pool_blocks=6,
                                       kv_offload=True)), prompts, 6)
    assert reg.counter("serve.kv.offload_out").value - o0 > 0
    assert reg.counter("serve.kv.offload_restores").value - r0 > 0
    for prompt, resp, w, ref in zip(prompts, resps, want, refs):
        _assert_no_near_tie(jmodel, params, prompt, w)
        assert resp.status == "ok" and resp.tokens == w == ref


# ---------------------------------------------------------------------------
# the laws of tests/test_kvpool.py and tests/test_kv_radix.py, host side


def test_block_demand_and_validation():
    assert tkv.block_demand(5, 6, 4) == 3     # 10 rows
    assert tkv.block_demand(4, 1, 4) == 1     # 4 rows
    assert tkv.block_demand(1, 16, 4) == 4    # 16 rows
    with pytest.raises(ValueError, match="power of two"):
        _pool(block_size=3)
    with pytest.raises(ValueError, match="sacrificial"):
        _pool(num_blocks=1)


def test_admit_release_accounting_and_sacrificial_row():
    pool = _pool(prefix_cache=False)
    prompt = list(range(1, 6))
    adm = pool.admit(0, prompt, 6)        # 10 rows -> 3 blocks
    assert len(adm.blocks) == 3 and 0 not in adm.blocks
    assert pool.free_blocks == 5 and _conserved(pool)
    assert list(pool.table[0][:3]) == adm.blocks
    assert not pool.table[0][3:].any()
    with pytest.raises(RuntimeError, match="admitted twice"):
        pool.admit(0, prompt, 6)
    pool.release(0)
    assert not pool.table[0].any()        # dead slot -> block 0 forever
    assert pool.free_blocks == 8 and _conserved(pool)
    pool.release(0)                       # idempotent


def test_prefix_reuse_and_cow_fork_plan():
    pool = _pool(num_blocks=17)
    shared = list(range(1, 9))            # exactly 2 full blocks
    a = pool.admit(0, shared + [20, 21], 4, chunk=4)
    assert a.prefix_hits == 0 and not a.cow_forks
    b = pool.admit(1, shared + [30], 4, chunk=4)
    assert b.prefix_hits == 2 and not b.cow_forks
    assert b.resume_from == 8 and b.blocks[:2] == a.blocks[:2]
    assert pool.stats()["shared_blocks"] == 2
    pool.release(0)
    pool.release(1)
    c = pool.admit(0, shared, 4, chunk=4)  # full hit: the tail block forks
    assert c.prefix_hits == 2 and len(c.cow_forks) == 1
    assert c.resume_from == 4
    assert c.blocks[0] == a.blocks[0] and c.blocks[1] != a.blocks[1]
    assert _conserved(pool)


def test_release_failed_unpublishes_registered_entries():
    pool = _pool()
    prompt = list(range(1, 9))
    pool.admit(0, prompt, 4, chunk=4)
    assert pool.cached_prefix_blocks(prompt) == 2
    pool.release(0, failed=True)          # prefill died mid-write
    assert pool.cached_prefix_blocks(prompt) == 0
    assert pool.free_blocks == 8 and _conserved(pool)


def test_lru_eviction_and_invalidate():
    reg = get_registry()
    pool = _pool(num_blocks=7, num_slots=3, max_len=32)
    p1, p2 = list(range(1, 9)), list(range(40, 48))
    pool.admit(0, p1, 1, chunk=4)
    pool.release(0)                       # refs 0 -> LRU, not free
    assert pool.free_blocks == 4 and pool.evictable_blocks == 2
    pool.admit(1, p2, 1, chunk=4)
    pool.release(1)
    ev0 = reg.counter("serve.kv.evictions").value
    pool.admit(2, list(range(60, 82)), 2, chunk=4)   # 6 blocks
    assert reg.counter("serve.kv.evictions").value - ev0 == 4
    assert pool.cached_prefix_blocks(p1) == 0
    pool.release(2)
    pool2 = _pool()
    pool2.admit(0, p1, 1, chunk=4)
    pool2.release(0)
    assert pool2.invalidate(pool2.prefix_hashes(p1)) == 2
    assert pool2.evictable_blocks == 0 and pool2.free_blocks == 8
    assert _conserved(pool2)


def test_pool_exhausted_detail_and_can_admit():
    pool = _pool(num_blocks=4)            # 3 allocatable
    assert pool.can_admit(5, 6) is True
    assert pool.can_admit(9, 8) is False
    pool.admit(0, [1, 2, 3, 4, 5], 6)
    assert pool.can_admit(2, 2) is False
    with pytest.raises(tkv.PoolExhausted) as ei:
        pool.admit(1, [1, 2], 2)
    assert ei.value.free == 0 and ei.value.total == 3
    assert ei.value.demand == 1 and _conserved(pool)


def test_fragmentation_counts_unwritable_tail_rows():
    pool = _pool(prefix_cache=False)
    pool.admit(0, [1, 2, 3], 3)           # 5 rows over 2 blocks (8 rows)
    assert pool.stats()["fragmentation"] == pytest.approx(3 / 8)
    pool.release(0)
    assert pool.stats()["fragmentation"] == 0.0


def test_generation_config_kv_knobs():
    assert GenerationConfig().kv_block_size is None
    assert GenerationConfig().prefix_cache is True
    assert GenerationConfig(kv_block_size=8).kv_block_size == 8
    for bad in (0, 3, 6, -4):
        with pytest.raises(ValueError, match="power of two"):
            GenerationConfig(kv_block_size=bad)


def test_prefix_hash_chain_and_match_depth():
    h = tkv.prefix_hashes(list(range(1, 13)), 4)
    assert len(h) == 3 and len(set(h)) == 3
    bent = list(range(1, 13))
    bent[0] = 77
    assert all(a != b for a, b in zip(h, tkv.prefix_hashes(bent, 4)))
    bent2 = list(range(1, 13))
    bent2[5] = 77
    h2 = tkv.prefix_hashes(bent2, 4)
    assert h2[0] == h[0] and h2[1] != h[1] and h2[2] != h[2]
    assert tkv.prefix_match_depth(h, set(h)) == 3
    assert tkv.prefix_match_depth(h, {h[0], h[2]}) == 1
    assert tkv.prefix_match_depth(h, set()) == 0


def test_radix_insert_match_and_split_on_divergence():
    pool = _pool(num_blocks=17, max_len=32, num_slots=3)
    a = _mixed_prompts((16,), seed=1)[0]
    pool.admit(0, a, 1, chunk=4)
    pool.release(0)
    assert pool.stats()["radix_nodes"] == 1
    b = a[:8] + _mixed_prompts((8,), seed=2)[0]
    assert pool.admit(0, b, 1, chunk=4).prefix_hits == 2
    pool.release(0)
    assert pool.stats()["radix_nodes"] == 3
    ha, hb = pool.prefix_hashes(a), pool.prefix_hashes(b)
    node, pos = pool._node_of[ha[1]]
    assert pos == len(node.run) - 1 and len(node.children) == 2
    d = pool.prefix_digest_summary()
    assert set(d["digests"]) == set(ha) | set(hb) and d["block_size"] == 4
    assert _conserved(pool)


def test_refcount_lifecycle_across_fork_and_retire():
    pool = _pool(num_blocks=17, max_len=32, num_slots=3)
    shared = _mixed_prompts((8,), seed=3)[0]
    ha = pool.prefix_hashes(shared)
    pool.admit(0, shared + [7, 9], 2, chunk=4)
    pool.admit(1, shared + [11], 2, chunk=4)
    assert [pool._cached[h].refs for h in ha] == [2, 2]
    assert pool.hot_prefixes(2)[0]["tokens"] == [int(t) for t in shared]
    pool.release(0)
    pool.release(1)
    assert [pool._cached[h].refs for h in ha] == [0, 0]
    adm = pool.admit(2, shared, 2, chunk=4)
    assert len(adm.cow_forks) == 1
    assert [pool._cached[h].refs for h in ha] == [1, 0]
    pool.release(2)
    assert _conserved(pool)


def test_eviction_never_frees_a_node_with_resident_descendants():
    reg = get_registry()
    pool = _pool(num_blocks=6, num_slots=2)
    p1 = _mixed_prompts((12,), seed=4)[0]
    pool.admit(0, p1, 1, chunk=4)
    pool.release(0)
    e0 = reg.counter("serve.kv.evictions").value
    pool.admit(1, _mixed_prompts((9,), seed=5)[0], 4, chunk=4)
    assert reg.counter("serve.kv.evictions").value - e0 == 1
    assert pool.cached_prefix_blocks(p1) == 2     # the leaf went first
    pool.release(1)
    assert _conserved(pool)


def test_offload_spill_and_restore_roundtrip_bitwise():
    reg = get_registry()
    pool = _pool(num_blocks=6, num_slots=2)
    store = tkv.HostKvStore()
    pool.attach_offload(store, _fake_payload)
    p1 = _mixed_prompts((12,), seed=6)[0]
    pool.admit(0, p1, 1, chunk=4)
    leaf_block = pool._cached[pool.prefix_hashes(p1)[2]].block
    pool.release(0)
    r0 = reg.counter("serve.kv.offload_restores").value
    pool.admit(1, _mixed_prompts((9,), seed=7)[0], 4, chunk=4)
    assert pool.offloaded_blocks == 1 and pool.cached_prefix_blocks(p1) == 3
    assert pool.stats()["host_kv_bytes"] == store.nbytes
    pool.release(1)
    pool.invalidate(pool.prefix_hashes(_mixed_prompts((9,), seed=7)[0]))
    adm = pool.admit(0, p1 + _mixed_prompts((4,), seed=10)[0], 1, chunk=4)
    assert reg.counter("serve.kv.offload_restores").value - r0 == 1
    want = _fake_payload(leaf_block)
    _, payload = adm.restores[0]
    for name in want:
        np.testing.assert_array_equal(payload[name], want[name])
        assert payload[name].dtype == want[name].dtype
    assert pool.offloaded_blocks == 0
    pool.release(0)
    assert _conserved(pool)


def test_host_store_caps_age_out_oldest():
    store = tkv.HostKvStore(max_blocks=2)
    pay = _fake_payload(1)
    assert store.put("a", pay) == [] and store.put("b", pay) == []
    assert store.put("c", pay) == ["a"]
    assert "a" not in store and "b" in store and len(store) == 2
    tiny = tkv.HostKvStore(max_bytes=8)
    assert "x" in tiny.put("x", pay) and "x" not in tiny
    assert store.get("b") is pay and "b" in store
    assert store.pop("b") is pay and "b" not in store


def test_pool_survives_store_dropping_its_own_put():
    reg = get_registry()
    pool = _pool(num_blocks=6, num_slots=2)
    pool.attach_offload(tkv.HostKvStore(max_bytes=8), _fake_payload)
    p1 = _mixed_prompts((12,), seed=8)[0]
    pool.admit(0, p1, 1, chunk=4)
    pool.release(0)
    d0 = reg.counter("serve.kv.offload_dropped").value
    pool.admit(1, _mixed_prompts((9,), seed=9)[0], 4, chunk=4)
    assert reg.counter("serve.kv.offload_dropped").value - d0 == 1
    assert pool.offloaded_blocks == 0 and pool.cached_prefix_blocks(p1) == 2
    pool.release(1)
    assert _conserved(pool)


# ---------------------------------------------------------------------------
# the laws of tests/test_kvpool.py and tests/test_kv_radix.py, engine side


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_paged_tokens_equal_the_slab(models, temperature):
    """The paged layout changes where K/V rows live, not what the model
    computes: greedy and sampled tokens equal the slab backend's (same
    slots, same keyed draws; the views have the slab's rows)."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=temperature,
                           top_k=12 if temperature else None)
    prompts = _mixed_prompts((3, 5, 4))
    slab = ServeEngine(SingleDeviceSlotBackend(
        tmodel, num_slots=2, max_len=16, gen=gen)).serve(
            prompts, seeds=[5] * 3)
    paged = ServeEngine(_paged(tmodel, gen)).serve(prompts, seeds=[5] * 3)
    assert [r.tokens for r in paged] == [r.tokens for r in slab]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_offload_restore_equals_an_unpressured_run(models,
                                                          temperature):
    """Spill and restore mid-run: tokens equal a pool where nothing is
    evicted, greedy and sampled (payloads are raw bytes)."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=4, temperature=temperature,
                           top_k=12 if temperature else None)
    prompts = _offload_workload()
    reg = get_registry()
    roomy = _serial(ServeEngine(_paged(tmodel, gen, kv_pool_blocks=32)),
                    prompts, 6)
    o0 = reg.counter("serve.kv.offload_out").value
    r0 = reg.counter("serve.kv.restore_traces").value
    tight = _serial(ServeEngine(_paged(tmodel, gen, kv_pool_blocks=6,
                                       kv_offload=True)), prompts, 6)
    assert reg.counter("serve.kv.offload_out").value - o0 > 0
    assert reg.counter("serve.kv.restore_traces").value - r0 == 1
    assert [r.tokens for r in tight] == [r.tokens for r in roomy]


def test_engine_offload_restore_run_identical_int8(models):
    """int8 KV payloads spill as raw codes and scales, so an offloaded run
    is token-identical to an unpressured one: the round trip never
    requantizes."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    prompts = _offload_workload()

    def run(pool_blocks, offload):
        return [r.tokens for r in _serial(ServeEngine(_paged(
            tmodel, gen, kv_pool_blocks=pool_blocks, kv_dtype="int8",
            kv_offload=offload)), prompts, 0)]

    reg = get_registry()
    o0 = reg.counter("serve.kv.offload_out").value
    want = run(32, False)
    assert reg.counter("serve.kv.offload_out").value == o0
    got = run(6, True)
    assert reg.counter("serve.kv.offload_out").value - o0 > 0
    assert got == want


def test_offload_read_block_is_a_copy(models):
    """The offload payload is a host copy of the stored bytes, not a view
    of the pool (on the CPU ``.cpu()`` would alias it)."""
    _, _, tmodel = models
    backend = _paged(tmodel, GenerationConfig(max_new_tokens=4),
                     kv_dtype="int8")
    backend._pool_kv["k"][:, 3] = 7
    payload = backend._offload_read_block(3)
    backend._pool_kv["k"][:, 3] = 0
    assert (payload["k"] == 7).all() and payload["k"].dtype == np.int8
    assert sorted(payload) == ["k", "k_scale", "v", "v_scale"]


def test_int8_kv_blocks_top1_agreement(models):
    """int8 KV rows (quantize on scatter, dequantize in the gather):
    greedy tokens agree with the fp32 pool's on at least 0.8 of steps."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = _mixed_prompts((5, 7), seed=4)
    refs = _one_shot(tmodel, prompts, gen)
    resps = ServeEngine(_paged(tmodel, gen, kv_dtype="int8")).serve(
        prompts, seeds=[0] * 2)
    agree = sum(int(a == b) for r, ref in zip(resps, refs)
                for a, b in zip(r.tokens, ref))
    assert agree / sum(len(r) for r in refs) >= 0.8


def test_kv_options_require_the_paged_pool(models):
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=4)
    for kw in (dict(kv_dtype="int8"), dict(kv_offload=True)):
        with pytest.raises(ValueError, match="paged"):
            SingleDeviceSlotBackend(tmodel, num_slots=2, max_len=16,
                                    gen=gen, **kw)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _paged(tmodel, gen, prefill_chunk=0)
    with pytest.raises(ValueError, match="kv_dtype"):
        _paged(tmodel, gen, kv_dtype="fp8")
    paged = SingleDeviceSlotBackend(
        tmodel, num_slots=2, max_len=16,
        gen=dataclasses.replace(gen, kv_block_size=4))
    assert paged.paged and paged.pool.num_blocks == 2 * 4 + 1


def test_kv_headroom_validation_names_the_waste(models):
    gen = GenerationConfig(max_new_tokens=6)
    gen.check_kv_headroom(18, 8)
    with pytest.raises(ValueError) as ei:
        gen.check_kv_headroom(16, 8)
    assert "does not divide" in str(ei.value)
    assert "waste 2 of 8 rows" in str(ei.value)
    _, _, tmodel = models
    with pytest.raises(ValueError, match="does not divide"):
        SingleDeviceSlotBackend(tmodel, num_slots=2, max_len=24, gen=gen,
                                buckets=BucketSpec.of(16), kv_block_size=8,
                                prefill_chunk=4)


def test_validate_rejects_what_the_pool_can_never_hold(models):
    _, _, tmodel = models
    eng = ServeEngine(_paged(tmodel, GenerationConfig(max_new_tokens=8),
                             kv_pool_blocks=3))
    with pytest.raises(ValueError, match="whole pool holds 2"):
        eng.submit(list(range(1, 9)), max_new_tokens=4)


def test_admission_parks_at_head_until_blocks_free(models):
    """A pool too small for two concurrent requests parks the second at
    the queue head and admits it when the first retires."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = _mixed_prompts((5, 4, 6), seed=9)
    refs = _one_shot(tmodel, prompts, gen)
    reg = get_registry()
    b0 = reg.counter("serve.kv.admission_blocked").value
    eng = ServeEngine(_paged(tmodel, gen, kv_pool_blocks=6))
    ids = [eng.submit(p, seed=1).id for p in prompts]
    eng.run_until_idle()
    assert reg.counter("serve.kv.admission_blocked").value - b0 > 0
    for rid, ref in zip(ids, refs):
        resp = eng.response(rid)
        assert resp.status == "ok" and resp.tokens == ref
    assert reg.gauge("serve.kv.blocks_in_use").value == 0.0


def test_admission_skips_blocked_head_for_smaller_request(models):
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    big_a, big_b = _mixed_prompts((5, 6), seed=31)
    small = _mixed_prompts((4,), seed=32)[0]
    reg = get_registry()
    s0 = reg.counter("serve.engine.admission_skipped").value
    b0 = reg.counter("serve.kv.admission_blocked").value
    eng = ServeEngine(_paged(tmodel, gen, kv_pool_blocks=6))
    ra = eng.submit(big_a, seed=2).id
    eng.tick()
    rb = eng.submit(big_b, seed=2).id
    rs = eng.submit(small, max_new_tokens=2, seed=2).id
    eng.tick()
    assert reg.counter("serve.kv.admission_blocked").value - b0 >= 1
    assert reg.counter("serve.engine.admission_skipped").value - s0 == 1
    assert eng.response(rb) is None and eng.queue.depth == 1
    eng.run_until_idle()
    refs = _one_shot(tmodel, [big_a, big_b, small], gen)
    assert eng.response(ra).tokens == refs[0]
    assert eng.response(rb).tokens == refs[1]
    assert eng.response(rs).tokens == refs[2][:2]


def test_admission_skip_respects_priority_order(models):
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    big = _mixed_prompts((6,), seed=33)[0]
    lo, hi = _mixed_prompts((4, 4), seed=34)
    eng = ServeEngine(_paged(tmodel, gen, kv_pool_blocks=6),
                      RequestQueue(policy="priority"))
    eng.submit(_mixed_prompts((5,), seed=35)[0], seed=0, priority=9)
    eng.tick()
    eng.submit(big, seed=0, priority=8)                 # head: blocked
    rl = eng.submit(lo, max_new_tokens=2, seed=0, priority=1).id
    rh = eng.submit(hi, max_new_tokens=2, seed=0, priority=5).id
    eng.tick()
    assert eng.response(rl) is None and eng.queue.depth == 2
    eng.run_until_idle()
    assert eng.response(rh).status == "ok"
    assert eng.response(rl).status == "ok"


def test_failed_prefill_releases_its_reservation(models, monkeypatch):
    """A prefill that raises mid-chunk releases the slot's blocks with
    ``failed=True``: the half-written prefix is unpublished and the pool
    drains; the engine retires only that request, with the pool's state
    intact for the next."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    backend = _paged(tmodel, gen)
    prompt = list(range(1, 13))
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("injected")

    monkeypatch.setattr(backend, "_first_prog", boom)
    eng = ServeEngine(backend)
    rid = eng.submit(prompt).id
    eng.tick()
    assert eng.response(rid).status == "error" and calls
    assert backend.pool.cached_prefix_blocks(prompt) == 0
    assert backend.pool.stats()["blocks_in_use"] == 0
    monkeypatch.undo()
    assert ServeEngine(backend).serve([prompt])[0].tokens == _one_shot(
        tmodel, [prompt], gen)[0]


def test_pool_gauges_follow_the_ticks(models):
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    eng = ServeEngine(_paged(tmodel, gen))
    eng.submit(_mixed_prompts((7,))[0])
    eng.tick()
    reg = get_registry()
    assert reg.gauge("serve.kv.blocks_in_use").value == 3.0
    assert 0.0 < reg.gauge("serve.kv.occupancy").value < 1.0
    eng.run_until_idle()
    assert reg.gauge("serve.kv.blocks_in_use").value == 0.0
