"""pipe_tpu_torch's draft sources and tree verification against pipe_tpu's.

On the CPU at the config of tests/test_resident.py, with the same numpy
weights (``convert.load_pipelined_lm``):

* ``tree_layout`` bitwise, ``resolve_draft`` with the same results and
  messages on tests/test_draft.py's combinations, ``draft_cost_frac``
  equal;
* ``NgramDraft.propose`` bitwise on random histories, with no match, a
  match at the last position and a window clamped at the end;
* ``TruncatedDraft`` and ``TreeDraft`` drafts equal JAX's on prefilled
  slots at two positions, where JAX's tied-head margins exceed TIE_MARGIN;
* the two repairs the slot engine's tree verify needs:
  ``MultiHeadAttention.decode`` with a tree at per-row tensor positions
  and ``embed_tree`` with a position tensor, against JAX's per-slot
  (vmapped) forms, and their K/V rows and embeddings bitwise those of the
  port's host-integer forms, row by row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference import draft as jdraft
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.ops import layers as jl
from pipe_tpu.serve import BucketSpec as JBucketSpec
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig
from pipe_tpu_torch.inference import draft as tdraft
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.serve import BucketSpec, SingleDeviceSlotBackend

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
TOL = 1e-5
TIE_MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    tmodel = tlm.PipelinedLM(tlm.LMConfig(**CFG), 2, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, tmodel


# -- static pieces -------------------------------------------------------


@pytest.mark.parametrize("branches", [1, 2, 3])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_tree_layout_matches_pipe_tpu(K, branches):
    jd, ja = jdraft.tree_layout(K, branches)
    td, ta = tdraft.tree_layout(K, branches)
    assert td.dtype == jd.dtype and ta.dtype == ja.dtype
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ta, ja)


RESOLVE_CASES = [
    ("ngram", dict(n_stages=1, layers_per_stage=4, draft_stages=99)),
    ("truncated", dict(n_stages=4, layers_per_stage=2, draft_stages=3)),
    ("tree", dict(n_stages=2, layers_per_stage=2, spec_branches=3)),
    ("truncated", dict(n_stages=2, layers_per_stage=2, draft_stages=2)),
    ("truncated", dict(n_stages=1, layers_per_stage=4)),
    ("tree", dict(n_stages=2, layers_per_stage=2, draft_stages=0,
                  spec_branches=2)),
    ("tree", dict(n_stages=2, layers_per_stage=2)),
    ("tree", dict(n_stages=2, layers_per_stage=2, spec_branches=1)),
    ("medusa", dict(n_stages=2, layers_per_stage=2)),
]


def _resolved(module, name, kw):
    try:
        d = module.resolve_draft(name, **kw)
    except ValueError as e:
        return ("error", str(e))
    return (type(d).__name__, d.branches, getattr(d, "draft_layers", None))


@pytest.mark.parametrize("name,kw", RESOLVE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(RESOLVE_CASES)])
def test_resolve_draft_matches_pipe_tpu(name, kw):
    """The same drafter, or the same ValueError message, as JAX's."""
    assert _resolved(tdraft, name, kw) == _resolved(jdraft, name, kw)


@pytest.mark.parametrize("args,msg", [((1, 2), "branches"),
                                      ((2, 0), "draft layer")])
def test_tree_and_truncated_refuse_like_pipe_tpu(args, msg):
    for cls in ("TreeDraft", "TruncatedDraft"):
        a = args if cls == "TreeDraft" else args[1:]
        if cls == "TruncatedDraft" and msg == "branches":
            continue
        with pytest.raises(ValueError) as je:
            getattr(jdraft, cls)(*a)
        with pytest.raises(ValueError) as te:
            getattr(tdraft, cls)(*a)
        assert str(te.value) == str(je.value) and msg in str(te.value)


@pytest.mark.parametrize("K,L", [(2, 4), (3, 4), (4, 16)])
def test_draft_cost_frac_matches_pipe_tpu(K, L):
    pairs = [(jdraft.NgramDraft(), tdraft.NgramDraft())]
    for ld in (1, 2, 8):
        pairs.append((jdraft.TruncatedDraft(ld), tdraft.TruncatedDraft(ld)))
        for b in (2, 3):
            pairs.append((jdraft.TreeDraft(b, ld), tdraft.TreeDraft(b, ld)))
    for j, t in pairs:
        assert t.draft_cost_frac(K, L) == j.draft_cost_frac(K, L)


# -- n-gram ----------------------------------------------------------------


def _ngram_case(kind, rng, S=6, H=20, K=4):
    hist = rng.randint(1, 9, size=(S, H))
    pos = rng.randint(2, H - 1, size=S)
    tok = hist[np.arange(S), pos]
    if kind == "no_match":
        hist[:, :] = np.where(hist == tok[:, None], 0, hist)
        hist[np.arange(S), pos] = tok
    elif kind == "last":
        hist[np.arange(S), pos - 1] = tok
    elif kind == "clamped":
        pos[:] = H - 1
        tok = hist[:, H - 1].copy()
        hist[:, H - 2] = tok           # match at H-2: window would pass H
    return hist, tok, pos, K


@pytest.mark.parametrize("kind", ["random", "no_match", "last", "clamped"])
def test_ngram_propose_bitwise(kind):
    rng = np.random.RandomState({"random": 0, "no_match": 1, "last": 2,
                                 "clamped": 3}[kind])
    for _ in range(4):
        hist, tok, pos, K = _ngram_case(kind, rng)
        want, _ = jdraft.NgramDraft().propose(
            None, None, None, None, None, jnp.asarray(tok, jnp.int32),
            jnp.asarray(pos, jnp.int32), jnp.asarray(hist, jnp.int32), K,
            False)
        got = tdraft.NgramDraft().propose(
            None, None, None, torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(hist), K)
        assert got.dtype == torch.int64 and got.shape == (len(tok), 1, K - 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- model drafts ----------------------------------------------------------


PROMPTS = ([5, 6, 5, 6, 5, 6, 7], [3, 9, 4])       # two positions


def _prefilled(models, draft, branches, K):
    """A JAX and a port backend (slab, 2 slots), both slots prefilled."""
    jmodel, params, tmodel = models
    jb = JBackend(jmodel, params, num_slots=2, max_len=24,
                  gen=JGenCfg(max_new_tokens=8, temperature=0.0),
                  buckets=JBucketSpec.of(4, 8), resident=True,
                  spec_tokens=K, draft=draft, spec_branches=branches)
    tb = SingleDeviceSlotBackend(
        tmodel, num_slots=2, max_len=24,
        gen=GenerationConfig(max_new_tokens=8, temperature=0.0),
        buckets=BucketSpec.of(4, 8), resident=True, spec_tokens=K,
        draft=draft, spec_branches=branches)
    for slot, p in enumerate(PROMPTS):
        assert jb.prefill(slot, p, 3) == tb.prefill(slot, p, 3)
    return jb, tb


def _jax_margins(jmodel, jb, K):
    """JAX's tied-head margins along its own rollout: every top-2 gap of
    a greedy step, and for a tree the gaps among the root's top B+1."""
    Ld, B = jb._drafter.draft_layers, jb._drafter.branches
    dstack = jdraft._slice_draft(jb._block_stack, Ld)
    dc = jdraft._slice_draft(jb._caches, Ld)
    pre = jb._pre

    def gaps(logits, n):
        top = np.sort(np.asarray(logits), axis=-1)[:, ::-1][:, :n + 1]
        return (top[:, :-1] - top[:, 1:]).min(axis=1)

    h, dc = jdraft._draft_step(jmodel, dstack, dc, pre, jb._tok, jb._pos,
                               False)
    logits = jdraft._tied_logits(jmodel, pre, h)
    out = [gaps(logits, B)]
    cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    p = jb._pos + 1
    if B > 1:
        dc = jax.tree_util.tree_map(lambda a: jnp.repeat(a, B, axis=1), dc)
        cur = jax.lax.top_k(logits, B)[1].astype(jnp.int32).reshape(-1)
        p = jnp.repeat(p, B)
    for _ in range(K - 2):
        h, dc = jdraft._draft_step(jmodel, dstack, dc, pre, cur, p, False)
        logits = jdraft._tied_logits(jmodel, pre, h)
        out.append(gaps(logits, 1).reshape(-1, B).min(axis=1))
        cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        p = p + 1
    return np.min(np.stack(out), axis=0)                    # [S]


@pytest.mark.parametrize("draft,branches,K", [
    ("truncated", None, 3), ("truncated", None, 4), ("tree", 2, 2),
    ("tree", 2, 4), ("tree", 3, 3)])
def test_model_drafts_match_pipe_tpu(draft, branches, K, models):
    """Truncated and tree drafts from prefilled slots at different
    positions equal JAX's where JAX's margins are clear, and write the
    root row (and, truncated, every draft row) into the draft layers'
    caches within TOL of JAX's."""
    jmodel, _, tmodel = models
    jb, tb = _prefilled(models, draft, branches, K)
    margins = _jax_margins(jmodel, jb, K)
    want, jcaches = jb._drafter.propose(
        jmodel, jb.gen, jb._pre, jb._block_stack, jb._caches, jb._tok,
        jb._pos, jb._hist, K, False)
    st = tb._state
    with torch.no_grad():
        got = tb._drafter.propose(tmodel, st["caches"], st["table"],
                                  st["tok"], st["pos"], st["hist"], K)
    assert got.shape == tuple(want.shape)
    clear = margins > TIE_MARGIN
    assert clear.any()
    np.testing.assert_array_equal(got.numpy()[clear],
                                  np.asarray(want)[clear])
    Ld = jb._drafter.draft_layers
    rows = 1 if branches else K - 1
    for l in range(Ld):
        for s, p in enumerate(np.asarray(jb._pos)):
            if not clear[s]:
                continue
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    st["caches"][l][name][s, p:p + rows].numpy(),
                    np.asarray(jcaches[name][l, s, p:p + rows]),
                    rtol=TOL, atol=TOL)


# -- the two repairs -------------------------------------------------------


@pytest.mark.parametrize("cls", [tl.TransformerEncoderLayer, tl.PreLNBlock])
def test_tree_decode_at_tensor_positions_matches_pipe_tpu(cls):
    """A tree_layout(3, 2) chunk at per-slot positions 6 and 9 after a
    12-row prefill: outputs against JAX's vmapped ``block.decode(...,
    tree=anc)`` within TOL, and the written K/V rows bitwise those of the
    port's host-integer form, slot by slot."""
    jcls = {tl.TransformerEncoderLayer: jl.TransformerEncoderLayer,
            tl.PreLNBlock: jl.PreLNBlock}[cls]
    jblk = jcls(32, 4, 64, dropout=0.0, causal=True)
    x = np.array(jax.random.normal(jax.random.key(5), (2, 17, 32)))
    params = jax.tree_util.tree_map(
        np.asarray, jblk.init(jax.random.key(6), jnp.asarray(x)))
    tblk = cls(32, 4, 64, dropout=0.0, causal=True, device="cpu")
    convert.load_params(tblk, params)
    _, anc = tdraft.tree_layout(3, 2)
    Q = anc.shape[0]
    pos = np.array([6, 9])
    jcache = jblk.attn.make_cache(2, 20)
    tcache = tblk.attn.make_cache(2, 20)
    _, jcache = jblk.decode(params, jnp.asarray(x[:, :12]), jcache, 0)
    chunk = np.stack([x[s, 12:12 + Q] for s in range(2)])

    def one(xs, c, p):
        out, c2 = jblk.decode(params, xs[None],
                              {n: a[None] for n, a in c.items()}, p,
                              tree=anc)
        return out[0], {n: a[0] for n, a in c2.items()}

    jout, jc2 = jax.vmap(one)(jnp.asarray(chunk), jcache,
                              jnp.asarray(pos, jnp.int32))
    with torch.no_grad():
        _, tcache = tblk.decode(torch.from_numpy(x[:, :12]), tcache, 0)
        ref = {n: c.clone() for n, c in tcache.items()}
        tout, tc2 = tblk.decode(torch.from_numpy(chunk), tcache,
                                torch.from_numpy(pos), tree=anc)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=TOL, atol=TOL)
        for s, p in enumerate(pos):
            one_cache = {n: c[s:s + 1].clone() for n, c in ref.items()}
            hout, hc = tblk.decode(torch.from_numpy(chunk[s:s + 1]),
                                   one_cache, int(p), tree=anc)
            torch.testing.assert_close(tout[s:s + 1], hout, rtol=TOL,
                                       atol=TOL)
            for n in ("k", "v"):
                for r in range(20):
                    assert torch.equal(tc2[n][s, r], hc[n][0, r]), (n, s, r)
                np.testing.assert_allclose(tc2[n][s].numpy(),
                                           np.asarray(jc2[n][s]),
                                           rtol=TOL, atol=TOL)


def test_embed_tree_at_tensor_positions_matches_pipe_tpu(models):
    """``embed_tree(tokens [S, Q], pos [S], depths)`` against JAX's
    per-slot ``embed_tree`` and, row by row, bitwise the port's
    host-integer form."""
    jmodel, params, tmodel = models
    depths, _ = tdraft.tree_layout(3, 2)
    tokens = np.random.RandomState(0).randint(0, CFG["vocab"], size=(2, 5))
    pos = np.array([6, 9])
    want = jax.vmap(lambda t, p: jmodel.embed_tree(
        params[1], t[None], p, jnp.asarray(depths))[0])(
            jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32))
    with torch.no_grad():
        got = tmodel.embed_tree(torch.from_numpy(tokens),
                                torch.from_numpy(pos),
                                torch.from_numpy(depths.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
        for s, p in enumerate(pos):
            one = tmodel.embed_tree(torch.from_numpy(tokens[s:s + 1]),
                                    int(p), torch.from_numpy(
                                        depths.astype(np.int64)))
            for r in range(tokens.shape[1]):
                assert torch.equal(got[s, r], one[0, r])
