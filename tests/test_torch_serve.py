"""pipe_tpu_torch's serve subsystem (continuous batching over slots) against
pipe_tpu's.

The same numpy weights (``convert.load_pipelined_lm``) go through the JAX
``ServeEngine`` and the port's, on the CPU at the config of
tests/test_serve.py. The port's engine runs S slots as S-row products, which
need not give batch-1 bits, so its greedy tokens are held to JAX's engine
and to the port's batch-1 ``Generator`` wherever JAX's top-2 logit margin is
wide (TIE_MARGIN): a near tie fails as a tie, not as a wrong token. On top
of that: the one-capture pin (``serve.engine.decode_traces`` rises by 1
across staggered traffic), one prefill shape per bucket touched, the queue
semantics of tests/test_serve.py (backpressure, deadlines, cancellation,
priority), the per-row-position decode against the host-integer one, the
keyed sampling draws (reproducible, independent of co-tenants, inside the
top k, distributed as ``softmax(logits / T)``), and the ``apps.serve`` and
``apps.generate --prompts-file`` entry points.
"""

import json
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.serve import BucketSpec as JBucketSpec
from pipe_tpu.serve import RequestQueue as JRequestQueue
from pipe_tpu.serve import ServeEngine as JServeEngine
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.apps import serve as serve_app
from pipe_tpu_torch.inference import (GenerationConfig, Generator,
                                      keyed_uniform, sample_logits,
                                      sequence_lengths)
from pipe_tpu_torch.inference.generate import seed_word
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.ops import flash_attention as tfa
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.serve import (BucketSpec, EngineDraining, QueueFull,
                                  RequestQueue, ServeEngine,
                                  SingleDeviceSlotBackend)

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
# The two frameworks' fp32 logits differ by ~1e-6 here; a JAX top-2 margin
# below this would let rounding pick the other token.
TIE_MARGIN = 1e-4


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


def _backend(model, gen_cfg, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 16)
    kw.setdefault("buckets", BucketSpec.of(4, 8))
    return SingleDeviceSlotBackend(model, gen=gen_cfg, **kw)


def _one_shot(tmodel, prompts, gen_cfg):
    g = Generator(tmodel, gen_cfg)
    return [g.generate([p])[0].tolist() for p in prompts]


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


def _staggered(eng, prompts, seed):
    ids = [eng.submit(prompts[0], seed=seed).id]
    eng.tick()
    ids += [eng.submit(p, seed=seed).id for p in prompts[1:3]]
    eng.tick()
    ids += [eng.submit(p, seed=seed).id for p in prompts[3:]]
    eng.run_until_idle()
    return [eng.response(i) for i in ids]


# ---------------------------------------------------------------------------
# the equality law + the one-capture pin


def test_staggered_arrivals_match_one_shot_generator(models):
    """Mixed prompt lengths arriving mid-flight, greedy: every response
    equals JAX's ServeEngine and the port's batch-1 Generator (no near tie
    in JAX's logits), the decode step was prepared exactly once, and two
    buckets touched make two prefill shapes."""
    jmodel, params, tmodel = models
    prompts = _mixed_prompts((3, 5, 4, 7, 5))
    jgen = JGenCfg(max_new_tokens=6, temperature=0.0)
    jeng = JServeEngine(JBackend(jmodel, params, num_slots=2, max_len=16,
                                 gen=jgen, buckets=JBucketSpec.of(4, 8)))
    want = [r.tokens for r in _staggered(jeng, prompts, 7)]

    gen_cfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    refs = _one_shot(tmodel, prompts, gen_cfg)
    backend = _backend(tmodel, gen_cfg)
    traces0 = get_registry().counter("serve.engine.decode_traces").value
    resps = _staggered(ServeEngine(backend), prompts, 7)
    for prompt, resp, w, ref in zip(prompts, resps, want, refs):
        _assert_no_near_tie(jmodel, params, prompt, w)
        assert resp.status == "ok" and resp.finish_reason == "length"
        assert resp.tokens == w == ref
        assert resp.ttft is not None and resp.latency >= resp.ttft
    assert get_registry().counter(
        "serve.engine.decode_traces").value - traces0 == 1
    stats = backend.program_stats()
    assert stats["prefill_programs"] == 2 and stats["kv"] == "slab"
    assert not stats["decode_graph"]             # the CPU runs it eagerly


def test_chunked_decode_parity(models):
    """decode_chunk=3 chops the same step into 3-token ticks: the tokens
    are those of the one-shot generator and of the 1-token engine."""
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = _mixed_prompts((3, 5, 4, 7, 5))
    refs = _one_shot(tmodel, prompts, gen_cfg)
    resps = ServeEngine(_backend(tmodel, gen_cfg, decode_chunk=3)).serve(
        prompts, seeds=[7] * len(prompts))
    assert [r.tokens for r in resps] == refs


def test_serve_eos_retires_early(models):
    """With eos_token_id set, the engine retires the slot at the EOS token
    and the emitted tokens are the one-shot run truncated at its sequence
    length."""
    _, _, tmodel = models
    prompts = _mixed_prompts((4, 6))
    free = _one_shot(tmodel, prompts,
                     GenerationConfig(max_new_tokens=8, temperature=0.0))
    eos = int(free[0][2])   # a token greedy decoding actually emits
    gen_cfg = GenerationConfig(max_new_tokens=8, temperature=0.0,
                               eos_token_id=eos)
    refs = _one_shot(tmodel, prompts, gen_cfg)
    lens = [int(sequence_lengths(torch.tensor([r]), eos)[0]) for r in refs]
    resps = ServeEngine(_backend(tmodel, gen_cfg)).serve(prompts,
                                                         seeds=[7, 7])
    assert resps[0].finish_reason == "eos"
    for resp, ref, n in zip(resps, refs, lens):
        assert resp.tokens == ref[:n]
        if resp.finish_reason == "eos":
            assert resp.tokens[-1] == eos
        assert len(resp.tokens) == n


def test_validate_rejects_unservable_requests(models):
    """Bad requests bounce at submit — they never cost a slot."""
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    eng = ServeEngine(_backend(tmodel, gen_cfg))
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(list(range(1, 10)))          # longest bucket is 8
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2, 3], max_new_tokens=60)
    with pytest.raises(ValueError, match="slot cache"):
        _backend(tmodel, gen_cfg, max_len=12).validate(8, 6)
    assert eng.queue.depth == 0


# ---------------------------------------------------------------------------
# queue semantics: backpressure, deadlines, cancellation, priority


def test_backpressure_rejects_when_full(models):
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    eng = ServeEngine(_backend(tmodel, gen_cfg), RequestQueue(capacity=2))
    reg = get_registry()
    rejected0 = reg.counter("serve.engine.rejected").value
    eng.submit([1, 2, 3])
    eng.submit([4, 5])
    with pytest.raises(QueueFull):
        eng.submit([6, 7, 8])
    assert reg.counter("serve.engine.rejected").value - rejected0 == 1
    eng.run_until_idle()                         # draining frees capacity
    eng.submit([6, 7, 8])
    eng.run_until_idle()


def test_deadline_timeout_retires_running_slot(models):
    """A running request whose deadline passes is retired mid-stream:
    status=timeout, partial tokens kept, slot freed for the next
    admission."""
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=50, temperature=0.0)
    backend = _backend(tmodel, gen_cfg, num_slots=1, max_len=64,
                       buckets=BucketSpec.of(4))
    t = [0.0]
    eng = ServeEngine(backend, RequestQueue(clock=lambda: t[0]))
    doomed = eng.submit([1, 2, 3], timeout_s=5.0)
    eng.tick()  # admit + first decode
    assert eng.live_slots == 1
    t[0] = 6.0
    finished = eng.tick()
    assert [r.request_id for r in finished] == [doomed.id]
    resp = eng.response(doomed.id)
    assert resp.status == "timeout" and resp.finish_reason == "deadline"
    assert len(resp.tokens) >= 1           # partial output survives
    assert eng.live_slots == 0
    ok = eng.submit([4, 5, 6], max_new_tokens=3)
    eng.run_until_idle()
    assert eng.response(ok.id).status == "ok"


def test_deadline_timeout_reaps_queued_request(models):
    """A request that dies WAITING is reaped before ever costing a
    prefill: no tokens, no ttft."""
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    t = [0.0]
    eng = ServeEngine(_backend(tmodel, gen_cfg),
                      RequestQueue(clock=lambda: t[0]))
    req = eng.submit([1, 2, 3], timeout_s=1.0)
    t[0] = 2.0
    eng.tick()
    resp = eng.response(req.id)
    assert resp.status == "timeout" and resp.tokens == []
    assert resp.ttft is None


def test_cancellation_frees_slot(models):
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=50, temperature=0.0)
    eng = ServeEngine(_backend(tmodel, gen_cfg, num_slots=1, max_len=64,
                               buckets=BucketSpec.of(4)))
    victim = eng.submit([1, 2, 3])
    queued = eng.submit([4, 5, 6], max_new_tokens=3)
    eng.tick()
    assert eng.live_slots == 1 and eng.queue.depth == 1
    assert eng.cancel(victim.id)
    eng.run_until_idle()
    v = eng.response(victim.id)
    assert v.status == "cancelled" and v.finish_reason == "cancelled"
    assert eng.response(queued.id).status == "ok"
    assert not eng.cancel(victim.id)     # a finished id is a no-op


def test_cancel_while_queued_never_prefills(models):
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    eng = ServeEngine(_backend(tmodel, gen_cfg, num_slots=1,
                               buckets=BucketSpec.of(4)))
    running = eng.submit([1, 2], max_new_tokens=4)
    waiting = eng.submit([3, 4], max_new_tokens=4)
    eng.tick()
    eng.cancel(waiting.id)
    eng.run_until_idle()
    assert eng.response(waiting.id).status == "cancelled"
    assert eng.response(waiting.id).tokens == []
    assert eng.response(running.id).status == "ok"


def test_drain_sheds_queued_and_finishes_live(models):
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    eng = ServeEngine(_backend(tmodel, gen_cfg, num_slots=1,
                               buckets=BucketSpec.of(4)))
    running = eng.submit([1, 2], max_new_tokens=4)
    waiting = eng.submit([3, 4], max_new_tokens=4)
    eng.tick()
    eng.drain()
    with pytest.raises(EngineDraining):
        eng.submit([5])
    eng.run_until_idle()
    assert eng.drained
    assert eng.response(running.id).status == "ok"
    shed = eng.response(waiting.id)
    assert shed.status == "shed" and shed.finish_reason == "drain"


@pytest.mark.parametrize("qmod", ["jax", "port"])
def test_priority_queue_orders_admissions(qmod):
    cls = JRequestQueue if qmod == "jax" else RequestQueue
    q = cls(capacity=8, policy="priority", clock=lambda: 0.0)
    a = q.submit([1], max_new_tokens=1, seed=0, priority=0)
    b = q.submit([2], max_new_tokens=1, seed=0, priority=5)
    c = q.submit([3], max_new_tokens=1, seed=0, priority=5)
    d = q.submit([4], max_new_tokens=1, seed=0, priority=1)
    # highest priority first; FIFO among equals
    assert [q.pop().id for _ in range(4)] == [b.id, c.id, d.id, a.id]


@pytest.mark.parametrize("qmod", ["jax", "port"])
def test_fifo_queue_is_fifo(qmod):
    cls = JRequestQueue if qmod == "jax" else RequestQueue
    q = cls(capacity=4, clock=lambda: 0.0)
    ids = [q.submit([i], max_new_tokens=1, seed=0).id for i in range(3)]
    assert [q.pop().id for _ in range(3)] == ids


def test_shed_lowest_order_matches_pipe_tpu():
    def run(cls):
        t = [0.0]
        q = cls(capacity=8, clock=lambda: t[0])
        for i, prio in enumerate((0, 2, 0, 1, 2, 0)):
            t[0] = float(i)
            q.submit([i + 1], max_new_tokens=1, priority=prio)
        return [r.prompt for r in q.shed_lowest(4)], \
            [r.prompt for r in q.admission_order()]
    assert run(RequestQueue) == run(JRequestQueue)


# ---------------------------------------------------------------------------
# buckets + prefill-shape hygiene


@pytest.mark.parametrize("cls", [BucketSpec, JBucketSpec])
def test_bucket_spec_selection_and_padding(cls):
    spec = cls.of(4, 8, 16)
    assert spec.bucket_for(1) == 4
    assert spec.bucket_for(4) == 4
    assert spec.bucket_for(5) == 8
    assert spec.bucket_for(16) == 16
    with pytest.raises(ValueError):
        spec.bucket_for(17)
    padded, n = spec.pad([7, 7, 7, 7, 7], pad_token_id=9)
    assert padded == [7, 7, 7, 7, 7, 9, 9, 9] and n == 5
    assert spec.max_len == 16


@pytest.mark.parametrize("cls", [BucketSpec, JBucketSpec])
def test_bucket_pow2_ladder(cls):
    assert cls.pow2(min_len=8, max_len=100).lengths == (8, 16, 32, 64, 100)
    assert cls.pow2(16, 128).lengths == (16, 32, 64, 128)


def test_unbucketed_prefill_warns_past_threshold(models):
    """Bucketing disabled + many distinct prompt lengths -> one loud
    RuntimeWarning when the shape count passes the threshold."""
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=2, temperature=0.0)
    backend = _backend(tmodel, gen_cfg, num_slots=1, buckets=None,
                       shape_cache_warn=2)
    eng = ServeEngine(backend)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for n in (2, 3, 4):
            eng.serve([_mixed_prompts((n,))[0]])
        hits = [x for x in w if issubclass(x.category, RuntimeWarning)
                and "bucketing DISABLED" in str(x.message)]
    assert len(hits) == 1
    assert backend.program_stats()["prefill_programs"] == 3


def test_not_ported_options_name_their_roadmap_item(models):
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=2, temperature=0.0)
    for kw, item in ((dict(kv_block_size=8), "A.6"),
                     (dict(kv_dtype="int8"), "A.6"),
                     (dict(kv_offload=True), "A.6"),
                     (dict(resident=True), "A.6"),
                     (dict(spec_tokens=4), "A.6"),
                     (dict(draft="tree"), "A.6")):
        with pytest.raises(NotImplementedError, match=item):
            _backend(tmodel, gen_cfg, **kw)
    backend = _backend(tmodel, gen_cfg, resident="auto")
    assert not backend.resident
    for call in (lambda: backend.export_prefix_payload([1]),
                 lambda: backend.import_prefix_payload({})):
        with pytest.raises(NotImplementedError, match="A.7"):
            call()
    for kw in (dict(watchdog=object()), dict(chaos=object()),
               dict(phase="decode")):
        with pytest.raises(NotImplementedError, match="A.7"):
            ServeEngine(backend, **kw)


# ---------------------------------------------------------------------------
# per-row decode positions


@pytest.mark.parametrize("q", [1, 3])
def test_per_row_positions_equal_the_host_integer_form(models, q):
    """``decode`` with a position tensor equals, row by row, a host-integer
    decode of that row alone at its position: outputs and cache rows (to
    rounding: a 4-row product need not give a 1-row one's bits). A
    row past its cache (a dead slot) clamps its write to the last rows and
    leaves the other rows' results alone; ``embed_at`` clamps the same
    way."""
    _, _, tmodel = models
    blk = tmodel.blocks[0]
    gen = torch.Generator().manual_seed(0)
    max_len = 12
    pos = torch.tensor([0, 4, 9, 30])                    # row 3: dead slot
    x = torch.randn(4, q, CFG["d_model"], generator=gen)
    base = blk.attn.make_cache(4, max_len)
    for c in base.values():
        c.copy_(torch.randn(c.shape, generator=gen))
    with torch.no_grad():
        cache = {n: c.clone() for n, c in base.items()}
        got, _ = blk.decode(x, cache, pos)
        for r, p in enumerate(pos.tolist()):
            one = {n: c[r:r + 1].clone() for n, c in base.items()}
            p = min(p, max_len - q)
            want, _ = blk.decode(x[r:r + 1], one, p)
            if r < 3:
                torch.testing.assert_close(got[r:r + 1], want, rtol=0,
                                           atol=1e-6)
            for n in ("k", "v"):
                torch.testing.assert_close(cache[n][r], one[n][0], rtol=0,
                                           atol=1e-6)
        assert torch.isfinite(got).all()
        table = tl.causal_table(max_len, "cpu")
        rows = pos.clamp(0, max_len - q)[:, None] + torch.arange(q)
        again, _ = blk.decode(x, {n: c.clone() for n, c in base.items()},
                              pos, allowed=table[rows])
        assert torch.equal(again, got)
        tokens = torch.tensor([[5] * q] * 2)
        far = tmodel.embed_at(tokens, torch.tensor([2, 10 ** 6]))
        assert torch.equal(far[0], tmodel.embed_at(tokens[:1], 2)[0])
        limit = tmodel.max_position()
        assert torch.equal(far[1], tmodel.embed_at(tokens[:1],
                                                   limit - q)[0])
    with pytest.raises(ValueError, match="host-integer"):
        blk.decode(x, blk.attn.make_cache(4, max_len), pos,
                   tree=np.ones((q, q), bool))


# ---------------------------------------------------------------------------
# keyed sampling draws


def _sampled(k=12, n=6):
    return GenerationConfig(max_new_tokens=n, temperature=0.8, top_k=k)


def test_keyed_draws_are_reproducible_and_independent_of_cotenants(models):
    """A sampled request's tokens are a function of its prompt and seed:
    the same in a 1-slot engine and among other requests in a 3-slot one,
    the same again on a second run, other for another seed."""
    _, _, tmodel = models
    prompts = _mixed_prompts((3, 5, 4, 7, 5))
    seeds = [11, 12, 13, 14, 15]
    alone = [ServeEngine(_backend(tmodel, _sampled(), num_slots=1)).serve(
        [p], seeds=[s])[0].tokens for p, s in zip(prompts, seeds)]
    crowd = ServeEngine(_backend(tmodel, _sampled(), num_slots=3)).serve(
        prompts, seeds=seeds)
    again = ServeEngine(_backend(tmodel, _sampled(), num_slots=3)).serve(
        prompts, seeds=seeds)
    other = ServeEngine(_backend(tmodel, _sampled(), num_slots=3)).serve(
        prompts, seeds=[s + 100 for s in seeds])
    assert [r.tokens for r in crowd] == alone == [r.tokens for r in again]
    assert [r.tokens for r in other] != alone


def test_keyed_draws_stay_inside_the_top_k(models):
    _, _, tmodel = models
    k = 5
    prompts = _mixed_prompts((3, 5, 4, 7))
    resps = ServeEngine(_backend(tmodel, _sampled(k=k, n=8), max_len=24)
                        ).serve(prompts, seeds=[1, 2, 3, 4])
    for prompt, resp in zip(prompts, resps):
        full = torch.tensor([prompt + resp.tokens])
        with torch.no_grad():
            logits = tmodel.post_fn(tmodel.stage_fn(
                1, tmodel.stage_fn(0, tmodel.pre_fn(full))))[0]
        chosen = logits[len(prompt) - 1:-1]
        kth = torch.topk(chosen, k, dim=-1).values[..., -1]
        picked = chosen[torch.arange(len(resp.tokens)),
                        torch.tensor(resp.tokens)]
        assert (picked >= kth).all()


def test_keyed_uniform_is_a_function_of_seed_step_and_index():
    seeds = torch.tensor([seed_word(s) for s in (3, 3, 4, -1)])
    steps = torch.tensor([0, 1, 0, 0])
    u = keyed_uniform(seeds, steps, 50)
    assert u.shape == (4, 50) and u.dtype == torch.float64
    assert ((u > 0) & (u < 1)).all()
    assert torch.equal(u[1:2], keyed_uniform(seeds[1:2], steps[1:2], 50))
    assert torch.equal(u[:, :20], keyed_uniform(seeds, steps, 20))
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert seed_word(2 ** 64 - 1) == -1 and seed_word(5) == 5


@pytest.mark.parametrize("temperature,top_k", [(0.8, None), (1.3, 12)])
def test_keyed_draw_distribution_chi_square(temperature, top_k):
    """One step, 40,000 keyed draws (40,000 seeds) from the same logits:
    counts against ``softmax(logits / T)`` (top-k renormalised),
    chi-square p > 1e-4."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(0, 2, size=40).astype(np.float32))
    n = 40_000
    cfg = GenerationConfig(temperature=temperature, top_k=top_k)
    seeds = torch.arange(n, dtype=torch.int64) * 7919 + 1
    u = keyed_uniform(seeds, torch.full((n,), 3), 40)
    draws = sample_logits(logits.expand(n, -1), cfg, uniform=u)
    counts = np.bincount(draws.numpy(), minlength=40)
    scaled = logits / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k).values[-1]
        scaled = torch.where(scaled >= kth, scaled, -float("inf"))
    p = torch.softmax(scaled.double(), -1).numpy()
    assert counts[p == 0].sum() == 0
    expected = p * n
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    keep = exp > 0
    stat, pval = scipy.stats.chisquare(obs[keep], exp[keep])
    assert pval > 1e-4, (stat, pval)


def test_engine_launches_no_flash_kernel_and_counts_its_metrics(models):
    _, _, tmodel = models
    gen_cfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    reg = get_registry()
    names = ("serve.engine.submitted", "serve.engine.admitted",
             "serve.engine.retired", "serve.engine.tokens")
    before = [reg.counter(n).value for n in names]
    launches = tfa.flash_attention_fwd.launches
    resps = ServeEngine(_backend(tmodel, gen_cfg)).serve(
        _mixed_prompts((3, 5, 4)))
    assert tfa.flash_attention_fwd.launches == launches
    moved = [reg.counter(n).value - b for n, b in zip(names, before)]
    assert moved == [3, 3, 3, 3 * 3]       # the first token is prefill's
    assert reg.histogram("serve.engine.ttft_sec").count >= 3
    assert all(len(r.tokens) == 4 for r in resps)


# ---------------------------------------------------------------------------
# entry points


def test_serve_cli_streams_requests_and_a_summary(capsys, tmp_path):
    events = tmp_path / "events.jsonl"
    assert serve_app.main(["--tiny", "--device", "cpu", "--requests", "5",
                           "--slots", "2", "--max-new", "4",
                           "--decode-chunk", "2",
                           "--events", str(events)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    reqs, summary = lines[:-1], lines[-1]["summary"]
    assert sorted(r["request"] for r in reqs) == list(range(5))
    assert all(r["status"] == "ok" and len(r["tokens"]) == 4 for r in reqs)
    assert summary["finished"] == 5 and summary["rejected"] == 0
    assert summary["device"] == "cpu" and not summary["decode_graph"]
    assert summary["metrics"]["serve.engine.decode_traces"] >= 1
    kinds = [json.loads(ln)["kind"] for ln in events.read_text().split("\n")
             if ln]
    assert kinds.count("request") == 10           # prefill + terminal


def test_generate_cli_prompts_file_serves_through_the_engine(
        capsys, tmp_path):
    """Each line of the file prints the row a one-shot generator call on
    that prompt prints."""
    path = tmp_path / "prompts.txt"
    path.write_text("1,2,3\n4,5,6,7,8\n\n9,10\n")
    assert gen_app.main(["--tiny", "--device", "cpu", "--prompts-file",
                         str(path), "--max-new", "5", "--slots", "2"]) == 0
    rows = capsys.readouterr().out.split()
    want = []
    for prompt in ("1,2,3", "4,5,6,7,8", "9,10"):
        assert gen_app.main(["--tiny", "--device", "cpu", "--prompt",
                             prompt, "--max-new", "5"]) == 0
        want += capsys.readouterr().out.split()
    assert rows == want


@pytest.mark.parametrize("argv,message", [
    (["--stages", "2"], "A.8"), (["--replicas", "2"], "A.7"),
    (["--fleet", "proc"], "A.7"), (["--metrics-port", "0"], "A.7"),
    (["--slo-ttft-p99", "1"], "A.7"), (["--trace-out", "t.jsonl"], "A.7"),
    (["--resident", "on"], "A.6"), (["--spec-tokens", "4"], "A.6"),
    (["--draft", "tree"], "A.6"), (["--kv", "paged"], "A.6"),
    (["--family", "gpt2"], "A.10"),
    (["--prompts-file", "/nonexistent/p.txt"], "no such file"),
    (["--eos", "101"], r"--eos must be in \[0, 101\)"),
    (["--max-new", "0"], "max_new_tokens must be >= 1"),
])
def test_serve_cli_refusals_exit_2(argv, message, capsys):
    assert serve_app.main(["--tiny", "--device", "cpu"] + argv) == 2
    err = capsys.readouterr().err
    assert re.search(message, err), err
