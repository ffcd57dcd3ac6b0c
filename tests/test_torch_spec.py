"""pipe_tpu_torch's speculative serve lane against its own tick path and
against pipe_tpu's spec engine.

Each resident iteration of a spec backend is a draft/verify round: the
drafter (n-gram, truncated or tree) proposes K-1 tokens per slot, one
teacher-forced [S, Q] decode verifies them, the longest matching prefix
plus one correction token is emitted. The laws of tests/test_resident.py's
spec section, on the CPU at its config, with JAX's weights converted:

* spec tokens equal the port's non-spec tick tokens bitwise, slab and
  paged, greedy and sampled, for every drafter (n-gram, truncated, tree of
  2 and 3 branches); greedy also equals JAX's spec engine and the port's
  batch-1 ``Generator`` where JAX's top-2 margin is wide, and greedy
  n-gram counts JAX's rounds and emitted tokens exactly;
* the lane emits more than one token a round on draftable greedy text;
* int8 weights and int8 KV rows; the adaptive ladder, one-token prompts,
  EOS inside an accepted run, knob validation with JAX's messages, the
  speculative headroom;
* a frozen (ghost) truncated or tree round writes into every cache row
  exactly the next real round's bits; a tree node at depth d draws at
  ``step + d``;
* ``apps.serve --spec-tokens`` serves with each drafter and the ladder.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.obs.telemetry import get_registry as jget_registry
from pipe_tpu.serve import BucketSpec as JBucketSpec
from pipe_tpu.serve import ServeEngine as JServeEngine
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import serve as serve_app
from pipe_tpu_torch.inference import DraftSource, GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                  SingleDeviceSlotBackend)
from pipe_tpu_torch.serve import engine as engine_mod

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
TIE_MARGIN = 1e-4
PROMPTS = [[5, 6, 5, 6, 5, 6], [3, 3, 3, 3]]


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


def _layout_kw(layout, jax_side=False):
    if layout == "paged":
        return dict(kv_block_size=4, prefill_chunk=4)
    return dict(buckets=(JBucketSpec if jax_side else BucketSpec).of(4, 8))


def _backend(model, gen, layout="slab", max_len=24, **kw):
    kw = {**_layout_kw(layout), **kw}
    kw.setdefault("num_slots", 2)
    return SingleDeviceSlotBackend(model, max_len=max_len, gen=gen, **kw)


def _drive_staggered(eng_cls, backend, prompts, seed):
    """Mid-flight arrivals: slot churn relaunches with mixed budgets."""
    eng = eng_cls(backend)
    ids = [eng.submit(prompts[0], seed=seed).id]
    eng.tick()
    ids += [eng.submit(p, seed=seed).id for p in prompts[1:]]
    eng.run_until_idle()
    return [[int(t) for t in eng.response(r).tokens] for r in ids]


def _counted(reg, fn):
    """``fn()``'s result and the rise of the spec counters of ``reg``."""
    names = ("serve.engine.spec_rounds", "serve.engine.spec_emitted")
    base = [reg.counter(n).value for n in names]
    out = fn()
    return out, [reg.counter(n).value - b for n, b in zip(names, base)]


def _gen(temp, **kw):
    return GenerationConfig(max_new_tokens=8, temperature=temp,
                            top_k=12 if temp else None, **kw)


_TICK = {}


def _tick_ref(tmodel, layout, temp, prompts=PROMPTS, seed=11, **gkw):
    """The port's non-spec tick tokens (module-cached per traffic)."""
    key = (layout, temp, tuple(map(tuple, prompts)), seed,
           tuple(sorted(gkw.items())))
    if key not in _TICK:
        _TICK[key] = _drive_staggered(
            ServeEngine, _backend(tmodel, _gen(temp, **gkw), layout,
                                  resident=False), prompts, seed)
    return _TICK[key]


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


DRAFTS = [("ngram", None), ("truncated", None), ("tree", 2), ("tree", 3)]
SPEC_CASES = [(l, t, d, b) for l in ("slab", "paged") for t in (0.0, 0.8)
              for d, b in DRAFTS]
SPEC_IDS = [f"{d}{b or ''}-{l}-{'greedy' if t == 0.0 else 'sampled'}"
            for l, t, d, b in SPEC_CASES]


@pytest.mark.parametrize("layout,temp,draft,branches", SPEC_CASES,
                         ids=SPEC_IDS)
def test_spec_matches_tick(layout, temp, draft, branches, models):
    """K = 3 rounds, 4 a launch, staggered arrivals: bitwise the tick
    path's tokens. Greedy: also JAX's spec engine (its rounds and emitted
    tokens too, for the n-gram draft, whose rounds depend only on the
    tokens) and the port's batch-1 Generator, and more than one token a
    round on the draftable prompts."""
    jmodel, params, tmodel = models
    reg = get_registry()
    backend = _backend(tmodel, _gen(temp), layout, resident=True,
                       resident_chunks=4, spec_tokens=3, draft=draft,
                       spec_branches=branches)
    got, (rounds, emitted) = _counted(reg, lambda: _drive_staggered(
        ServeEngine, backend, PROMPTS, 11))
    assert got == _tick_ref(tmodel, layout, temp)
    assert emitted >= sum(len(g) for g in got) - len(PROMPTS)
    assert 0 < rounds <= emitted
    if draft != "ngram":
        assert reg.gauge("serve.spec.draft_cost_frac").value > 0.0
    if temp != 0.0:
        return
    assert emitted > rounds
    jb = JBackend(jmodel, params, num_slots=2, max_len=24,
                  gen=JGenCfg(max_new_tokens=8, temperature=0.0),
                  resident=True, resident_chunks=4, spec_tokens=3,
                  draft=draft, spec_branches=branches,
                  **_layout_kw(layout, jax_side=True))
    want, jcounts = _counted(jget_registry(), lambda: _drive_staggered(
        JServeEngine, jb, PROMPTS, 11))
    one = Generator(tmodel, _gen(0.0))
    for p, g, w in zip(PROMPTS, got, want):
        assert _jax_margin_ok(jmodel, params, p, w)
        assert g == w == one.generate([p])[0].tolist()
    if draft == "ngram":
        assert [rounds, emitted] == jcounts


@pytest.mark.parametrize("int8", ["weights", "kv"])
def test_spec_int8_matches_tick(int8, models):
    """int8 block weights (the truncated draft reads the same dequantized
    weights as the verify) and int8 KV rows (paged): the spec lane's
    tokens equal the tick path's on the same backend settings."""
    from pipe_tpu_torch.inference import quantize_params

    _, _, tmodel = models
    model, layout, kw = ((quantize_params(tmodel), "slab", {})
                         if int8 == "weights"
                         else (tmodel, "paged", dict(kv_dtype="int8")))
    gen = _gen(0.8)
    ref = _drive_staggered(ServeEngine, _backend(
        model, gen, layout, resident=False, **kw), PROMPTS, 11)
    got = _drive_staggered(ServeEngine, _backend(
        model, gen, layout, resident=True, resident_chunks=4,
        spec_tokens=3, draft="truncated", **kw), PROMPTS, 11)
    assert got == ref


def test_adaptive_ladder(models):
    """A draftable slot beside an adversarial one switches rungs
    mid-stream: tokens equal the tick path's, each rung is prepared once
    (traces <= rungs), misses shrink the EWMA below its start, and a
    second drive of the same traffic prepares nothing."""
    _, _, tmodel = models
    prompts = [[5, 6, 5, 6, 5, 6, 5, 6], _mixed_prompts((7,), seed=3)[0]]
    gen = GenerationConfig(max_new_tokens=10, temperature=0.8, top_k=12)
    ref = _drive_staggered(ServeEngine, _backend(
        tmodel, gen, max_len=32, resident=False), prompts, 13)
    backend = _backend(tmodel, gen, max_len=32, resident=True,
                       resident_chunks=4, spec_tokens=4,
                       spec_adaptive=True)
    assert backend._spec_ladder == [2, 3, 4]
    reg = get_registry()
    t0 = reg.counter("serve.engine.resident_traces").value
    got = _drive_staggered(ServeEngine, backend, prompts, 13)
    assert got == ref
    traced = reg.counter("serve.engine.resident_traces").value - t0
    assert 1 <= traced <= len(backend._spec_ladder)
    assert backend._spec_ewma.min() < float(backend.spec_tokens)
    assert _drive_staggered(ServeEngine, backend, prompts, 13) == got
    assert reg.counter("serve.engine.resident_traces").value - t0 == traced


@pytest.mark.parametrize("draft", ["ngram", "truncated"])
def test_spec_empty_history_slots(draft, models):
    """One-token prompts: the n-gram draft has no history to match, the
    truncated draft extends a one-row prefix; junk drafts are rejected
    back to the tick path's tokens."""
    _, _, tmodel = models
    prompts = [[7], [3]]
    got = _drive_staggered(ServeEngine, _backend(
        tmodel, GenerationConfig(max_new_tokens=6, temperature=0.0),
        resident=True, resident_chunks=4, spec_tokens=3, draft=draft),
        prompts, 5)
    assert got == _drive_staggered(ServeEngine, _backend(
        tmodel, GenerationConfig(max_new_tokens=6, temperature=0.0),
        resident=False), prompts, 5)


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_spec_eos_mid_accepted_run(layout, models):
    """An EOS inside an accepted run: the response stops at it with the
    tick path's truncation, early, and the round's tokens after it are
    pad."""
    _, _, tmodel = models
    free = _tick_ref(tmodel, layout, 0.0)
    eos = int(free[0][3])
    got = _drive_staggered(ServeEngine, _backend(
        tmodel, _gen(0.0, eos_token_id=eos), layout, resident=True,
        resident_chunks=4, spec_tokens=3), PROMPTS, 11)
    assert got == _tick_ref(tmodel, layout, 0.0, eos_token_id=eos)
    assert any(t and t[-1] == eos and len(t) < 8 for t in got)


class _Oracle(DraftSource):
    """Drafts the stream ``seqs [S, H]`` holds at the next positions: every
    draft of a greedy run on that stream is accepted."""

    name = "oracle"

    def __init__(self, seqs):
        self.seqs = seqs

    def propose(self, model, caches, table, tok, pos, hist, K,
                buffers=None):
        idx = (pos[:, None] + 1 + torch.arange(K - 1)).clamp(
            max=self.seqs.shape[1] - 1)
        return self.seqs.gather(1, idx)[:, None]

    def draft_cost_frac(self, K, n_layers):
        return 0.0


def test_spec_round_pads_after_an_eos(models):
    """One round that accepts all 8 drafts: the tokens after the first
    EOS among them are pad, the EOS is emitted, and the slot is done."""
    _, _, tmodel = models
    prompt = PROMPTS[0]
    free = Generator(tmodel, GenerationConfig(
        max_new_tokens=9, temperature=0.0)).generate([prompt])[0].tolist()
    e = next(k for k in range(2, 8) if free[k] not in free[:k])
    seqs = torch.full((2, 40), 0, dtype=torch.int64)
    seqs[0, len(prompt):len(prompt) + 9] = torch.tensor(free)
    b = _backend(tmodel, _gen(0.0, eos_token_id=free[e], pad_token_id=88),
                 resident=True, resident_chunks=2, spec_tokens=8,
                 max_len=32, draft=_Oracle(seqs))
    assert b.prefill(0, prompt, 11) == free[0]
    toks, valid = b.decode(np.array([True, False]),
                           budgets=np.array([8, 0]))
    assert toks.shape == (2, 8) and valid[0].all() and not valid[1].any()
    assert toks[0].tolist() == free[1:e + 1] + [88] * (8 - e)


def test_spec_knob_validation(models):
    """JAX's single-device rejections, with its messages."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    cases = [(dict(resident=True, spec_tokens=1), "spec_tokens must be"),
             (dict(resident=False, spec_tokens=3), "needs the resident"),
             (dict(resident=True, draft="truncated"), "speculative lane"),
             (dict(resident=True, spec_tokens=3, draft="tree"),
              "spec_branches >= 2"),
             (dict(resident=True, spec_tokens=3, draft="truncated",
                   draft_stages=2), "STRICT prefix"),
             (dict(resident=True, spec_tokens=3, draft="medusa"),
              "unknown draft source")]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            _backend(tmodel, gen, max_len=16, **kw)
    # a paged pool whose block does not divide the speculative span
    with pytest.raises(ValueError, match="speculative headroom 2"):
        SingleDeviceSlotBackend(tmodel, num_slots=2, max_len=16, gen=gen,
                                buckets=BucketSpec.of(4, 8),
                                kv_block_size=4, resident=True,
                                spec_tokens=3)


def test_spec_headroom_tightens_validate(models):
    """A verify writes branches x (K-1) rows past the last emitted one:
    validate rejects at submit, naming the speculative headroom; the same
    request without the lane is servable."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0)
    for draft, br, extra in (("ngram", None, 2), ("tree", 2, 4)):
        eng = ServeEngine(_backend(tmodel, gen, resident=True,
                                   spec_tokens=3, draft=draft,
                                   spec_branches=br,
                                   buckets=BucketSpec.of(16)))
        with pytest.raises(ValueError,
                           match=f"speculative headroom {extra}"):
            eng.submit(list(range(1, 16)), max_new_tokens=8)
        eng.submit(list(range(1, 24 - 8 - extra + 1)), max_new_tokens=8)
    ServeEngine(_backend(tmodel, gen, resident=True,
                         buckets=BucketSpec.of(16))).submit(
        list(range(1, 16)), max_new_tokens=8)


def _rows(backend):
    """Every KV row and per-slot value the spec programs write."""
    st = backend._state
    out = {n: st[n].clone() for n in ("tok", "pos", "step", "hist")}
    if backend.paged:
        out.update({f"pool_{n}": a.clone()
                    for n, a in backend._pool_kv.items()})
        out.update({f"view_{n}": a.clone() for n, a in st["views"].items()})
    else:
        for l, cache in enumerate(st["caches"]):
            out.update({f"{n}{l}": c.clone() for n, c in cache.items()})
    return out


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("draft,branches", [("truncated", None),
                                            ("tree", 2)])
def test_ghost_round_writes_what_the_next_real_round_writes(
        draft, branches, layout, models):
    """Two launches of one real round each with two ghost rounds behind
    them leave every cache row (slab), pool row and view row (paged)
    bitwise as three real launches do: a frozen round recomputes the next
    real round from the same state, drafts and tree relocation included.
    The frozen per-slot state (history too) equals two real launches'."""
    _, _, tmodel = models
    gen = GenerationConfig(max_new_tokens=12, temperature=0.8, top_k=12)
    prompts = _mixed_prompts((3, 4), seed=5)

    def launched(rounds, launches):
        b = _backend(tmodel, gen, layout, max_len=32, resident=True,
                     resident_chunks=rounds, spec_tokens=3, draft=draft,
                     spec_branches=branches)
        for slot, p in enumerate(prompts):
            b.prefill(slot, p, seed=11 + slot)
        toks = [b.decode(np.array([True, True]),
                         budgets=np.array([100, 100]), r_max=1)
                for _ in range(launches)]
        return toks, _rows(b)

    ghost_toks, ghost = launched(3, 2)
    real2_toks, real2 = launched(1, 2)
    _, real3 = launched(1, 3)
    for (gt, gv), (rt, rv) in zip(ghost_toks, real2_toks):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gv, rv)
    for n in ("tok", "pos", "step", "hist"):
        assert torch.equal(ghost[n], real2[n]), n
    rows = [n for n in ghost if n not in ("tok", "pos", "step", "hist")]
    for n in rows:
        assert torch.equal(ghost[n], real3[n]), n
    assert any(not torch.equal(ghost[n], real2[n]) for n in rows)


def test_tree_nodes_draw_at_their_depth(models, monkeypatch):
    """A sampled tree round keys row r's draw by (seed, step + depth[r]):
    the d-th sequential draw whatever branch the node sits on."""
    _, _, tmodel = models
    from pipe_tpu_torch.inference.draft import tree_layout
    seen = []
    real = engine_mod.keyed_uniform

    def spy(seeds, steps, vocab):
        seen.append((seeds.clone(), steps.clone()))
        return real(seeds, steps, vocab)

    b = _backend(tmodel, _gen(0.8), resident=True, resident_chunks=1,
                 spec_tokens=3, draft="tree", spec_branches=2)
    b.prefill(0, PROMPTS[0], 21)
    b.prefill(1, PROMPTS[1], 22)
    step = b._state["step"].clone()
    monkeypatch.setattr(engine_mod, "keyed_uniform", spy)
    b.decode(np.array([True, True]), budgets=np.array([8, 8]))
    (seeds, steps), = seen
    depths, _ = tree_layout(3, 2)
    Q = len(depths)
    want = (step[:, None] + torch.from_numpy(depths.astype(np.int64)))
    assert torch.equal(steps.reshape(2, Q), want)
    assert torch.equal(seeds.reshape(2, Q),
                       b._state["seed"][:, None].expand(2, Q))


@pytest.mark.parametrize("argv", [
    ["--spec-tokens", "4"],
    ["--spec-tokens", "4", "--draft", "truncated"],
    ["--spec-tokens", "4", "--draft", "tree", "--spec-branches", "2",
     "--kv", "paged", "--kv-block-size", "2"],
    ["--spec-tokens", "4", "--spec-adaptive"],
], ids=["ngram", "truncated", "tree-paged", "adaptive"])
def test_serve_cli_spec(argv, capsys):
    """``apps.serve --spec-tokens 4 --resident on`` serves every request
    to its length with each drafter and the ladder; the summary names the
    lane and carries its metrics."""
    assert serve_app.main(["--tiny", "--device", "cpu", "--requests", "4",
                           "--slots", "2", "--max-new", "8", "--resident",
                           "on", "--resident-chunks", "3"] + argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(ln) for ln in lines[:-1]]
    summary = json.loads(lines[-1])["summary"]
    assert len(rows) == 4 and all(r["status"] == "ok" for r in rows)
    assert all(len(r["tokens"]) == 8 for r in rows)
    assert summary["spec_tokens"] == 4
    assert summary["draft"] == (argv[argv.index("--draft") + 1]
                                if "--draft" in argv else "ngram")
    m = summary["metrics"]
    assert m["serve.engine.spec_emitted"] >= m["serve.engine.spec_rounds"]
    assert 0.0 <= m["serve.spec.acceptance_rate"] <= 1.0
    assert "serve.spec.draft_cost_frac" in m
