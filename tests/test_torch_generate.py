"""pipe_tpu_torch's KV-cached generation against pipe_tpu's.

The same numpy weights (``convert.load_pipelined_lm``) and prompts go
through the JAX ``Generator`` and the port's, on the CPU at the tiny config
of tests/test_generate.py: block decode and the speculative ``tree`` mask,
teacher-forced cached logits, greedy, EOS and beam tokens (bitwise), beam
scores, ``layer_scan``, every ``GenerationConfig`` check,
``sequence_lengths``, ``check_positions``, ``Trainer.generate`` and the
``apps.generate`` entry point. Greedy equality is asserted only where
JAX's top-2 logit margin is wide (TIE_MARGIN), so that a near tie shows as
one and not as a wrong token. Sampling cannot reproduce JAX's key chain:
it is held to its own seed, to the top-k support and, by a chi-square
test, to ``softmax(logits / T)``.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference import Generator as JGenerator
from pipe_tpu.inference.generate import check_positions as jcheck_positions
from pipe_tpu.inference.generate import sequence_lengths as jseq_lengths
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.ops import layers as jl
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.inference import generate as tgen
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.train import loop as tloop

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
TOL_BLOCK = 2e-5
TOL_LOGITS = 5e-5
TOL_SCORES = 1e-5
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


def _prompt(seed, shape):
    return np.array(jax.random.randint(jax.random.key(seed), shape, 0,
                                         CFG["vocab"], jnp.int32))


def _jax_full_logits(jmodel, params, tokens):
    sp, pre, post = params
    ctx = JCtx(train=False)
    h = jmodel.pre_fn(pre, jnp.asarray(tokens), ctx)
    for blocks in sp:
        h = jmodel.stage_fn(blocks, h, ctx)
    return np.asarray(jmodel.post_fn(post, h, ctx))


def _port_logits(model):
    def full_logits(tokens):
        with torch.no_grad():
            h = model.pre_fn(torch.from_numpy(tokens).long())
            for s in range(model.n_stages):
                h = model.stage_fn(s, h)
            return model.post_fn(h).numpy()
    return full_logits


def _assert_no_near_tie(full_logits, prompt, toks):
    """The top-2 margin of ``full_logits`` (JAX's forward, or the port's
    where JAX's model is not at hand) at every position that chose a
    generated token."""
    full = np.concatenate([prompt, np.asarray(toks)], axis=1)
    logits = full_logits(full)
    p = prompt.shape[1]
    chosen = logits[:, p - 1:p - 1 + toks.shape[1]]
    top2 = np.sort(chosen, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min()
    assert margin > TIE_MARGIN, f"near tie in JAX's logits: {margin:.2e}"


def _block_pair(cls, seed):
    jcls = {tl.TransformerEncoderLayer: jl.TransformerEncoderLayer,
            tl.PreLNBlock: jl.PreLNBlock}[cls]
    jblk = jcls(32, 4, 64, dropout=0.0, causal=True)
    x = jax.random.normal(jax.random.key(seed), (2, 16, 32))
    params = jax.tree_util.tree_map(
        np.asarray, jblk.init(jax.random.key(seed + 1), x))
    tblk = cls(32, 4, 64, dropout=0.0, causal=True, device="cpu")
    convert.load_params(tblk, params)
    return jblk, params, tblk, np.array(x)


@pytest.mark.parametrize("cls", [tl.TransformerEncoderLayer, tl.PreLNBlock])
def test_block_decode_matches_pipe_tpu(cls):
    """Prefill of 10 rows then 6 one-token steps into a 20-row cache:
    outputs and cache rows against JAX's ``decode``."""
    jblk, params, tblk, x = _block_pair(cls, 1)
    jcache = jblk.attn.make_cache(2, 20)
    tcache = tblk.attn.make_cache(2, 20)
    spans = [(0, 10)] + [(t, t + 1) for t in range(10, 16)]
    with torch.no_grad():
        for a, b in spans:
            jout, jcache = jblk.decode(params, jnp.asarray(x[:, a:b]),
                                       jcache, a)
            tout, tcache = tblk.decode(torch.from_numpy(x[:, a:b]), tcache,
                                       a)
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                       rtol=TOL_BLOCK, atol=TOL_BLOCK)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   rtol=TOL_BLOCK, atol=TOL_BLOCK)
    np.testing.assert_array_equal(tcache["k"][:, 16:].numpy(), 0.0)


@pytest.mark.parametrize("cls", [tl.TransformerEncoderLayer, tl.PreLNBlock])
def test_block_tree_decode_matches_pipe_tpu(cls):
    """A 5-node draft tree (root, two children, a grandchild under each)
    verified at pos 8 after an 8-row prefill, against JAX's tree mask."""
    jblk, params, tblk, x = _block_pair(cls, 3)
    tree = np.array([[1, 0, 0, 0, 0],
                     [1, 1, 0, 0, 0],
                     [1, 0, 1, 0, 0],
                     [1, 1, 0, 1, 0],
                     [1, 0, 1, 0, 1]], bool)
    jcache = jblk.attn.make_cache(2, 16)
    tcache = tblk.attn.make_cache(2, 16)
    _, jcache = jblk.decode(params, jnp.asarray(x[:, :8]), jcache, 0)
    with torch.no_grad():
        _, tcache = tblk.decode(torch.from_numpy(x[:, :8]), tcache, 0)
        tout, _ = tblk.decode(torch.from_numpy(x[:, 8:13]), tcache, 8,
                              tree=tree)
    jout, _ = jblk.decode(params, jnp.asarray(x[:, 8:13]), jcache, 8,
                          tree=tree)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=TOL_BLOCK, atol=TOL_BLOCK)


def test_decode_refuses_a_write_past_the_cache():
    """``pipe_tpu``'s dynamic_update_slice clamps such a write; the port
    raises (a deliberate difference, ROADMAP.md C)."""
    blk = tl.TransformerEncoderLayer(32, 4, 64, device="cpu")
    cache = blk.attn.make_cache(1, 8)
    with torch.no_grad():
        blk.decode(torch.zeros(1, 8, 32), cache, 0)
        with pytest.raises(ValueError, match="cache of 8 rows"):
            blk.decode(torch.zeros(1, 1, 32), cache, 8)
    noncausal = tl.MultiHeadAttention(32, 4, causal=False, device="cpu")
    with pytest.raises(ValueError, match="causal"):
        noncausal.decode(torch.zeros(1, 1, 32), noncausal.make_cache(1, 4), 0)


def test_teacher_forced_cached_logits_match_pipe_tpu(models):
    """A fixed 20-token sequence fed one token a step through the cached
    path: logits against JAX's cached path and its full forward."""
    jmodel, params, tmodel = models
    sp, pre, post = params
    tokens = _prompt(5, (2, 20))
    jgen = JGenerator(jmodel, JGenCfg(max_new_tokens=1))
    blocks = jgen._blocks(sp)
    jcaches = [jmodel.block.attn.make_cache(2, 20) for _ in blocks]
    tcaches = [blk.attn.make_cache(2, 20) for blk in tmodel.blocks]
    jgot, tgot = [], []
    with torch.no_grad():
        for t in range(20):
            h = jmodel.embed_at(pre, jnp.asarray(tokens[:, t:t + 1]), t)
            g = tmodel.embed_at(torch.tensor(tokens[:, t:t + 1]).long(),
                                t)
            for l, bp in enumerate(blocks):
                h, jcaches[l] = jmodel.block.decode(bp, h, jcaches[l], t)
                g, tcaches[l] = tmodel.blocks[l].decode(g, tcaches[l], t)
            jgot.append(np.asarray(jgen._head(post, h))[:, 0])
            tgot.append(tgen.head_logits(tmodel, g)[:, 0].numpy())
    jgot, tgot = np.stack(jgot, 1), np.stack(tgot, 1)
    np.testing.assert_allclose(tgot, jgot, rtol=TOL_LOGITS, atol=TOL_LOGITS)
    np.testing.assert_allclose(tgot, _jax_full_logits(jmodel, params, tokens),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


@pytest.mark.parametrize("seed,batch,plen,max_new", [
    (6, 2, 8, 6), (11, 3, 5, 10), (13, 1, 12, 16)])
def test_greedy_tokens_equal_pipe_tpu(models, seed, batch, plen, max_new):
    jmodel, params, tmodel = models
    prompt = _prompt(seed, (batch, plen))
    cfg = dict(max_new_tokens=max_new, temperature=0.0)
    want = np.asarray(JGenerator(jmodel, JGenCfg(**cfg)).generate(
        params, jnp.asarray(prompt)))
    _assert_no_near_tie(lambda t: _jax_full_logits(jmodel, params, t),
                        prompt, want)
    got = Generator(tmodel, GenerationConfig(**cfg)).generate(prompt)
    assert got.dtype == torch.int64 and got.shape == (batch, max_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_lengths_and_pad_match_pipe_tpu(models):
    """EOS set to the token row 0 emits at step 2: the EOS is emitted, pad
    follows, and rows that never emit it run the full width."""
    jmodel, params, tmodel = models
    prompt = _prompt(11, (3, 5))
    free = Generator(tmodel, GenerationConfig(
        max_new_tokens=10, temperature=0.0)).generate(prompt)
    eos = int(free[0, 2])
    cfg = dict(max_new_tokens=10, temperature=0.0, eos_token_id=eos,
               pad_token_id=7)
    want, want_len = JGenerator(jmodel, JGenCfg(**cfg)).generate_with_lengths(
        params, jnp.asarray(prompt))
    got, got_len = Generator(tmodel, GenerationConfig(
        **cfg)).generate_with_lengths(prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len[0]) <= 3 and (got[0, int(got_len[0]):] == 7).all()


def test_beam_tokens_and_scores_match_pipe_tpu(models):
    jmodel, params, tmodel = models
    prompt = _prompt(20, (3, 6))
    cfg = dict(max_new_tokens=5, num_beams=4)
    want, want_s = JGenerator(jmodel, JGenCfg(**cfg)).generate_with_scores(
        params, jnp.asarray(prompt))
    gen = Generator(tmodel, GenerationConfig(**cfg))
    got, got_s = gen.generate_with_scores(prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=TOL_SCORES, atol=TOL_SCORES)
    assert torch.equal(gen.generate(prompt), got)        # dispatches to beam
    with pytest.raises(ValueError, match="num_beams"):
        Generator(tmodel, GenerationConfig(max_new_tokens=2)
                  ).generate_with_scores(prompt)


@pytest.mark.parametrize("beams", [1, 3])
def test_max_new_tokens_one_matches_pipe_tpu(models, beams):
    jmodel, params, tmodel = models
    prompt = _prompt(21, (2, 5))
    cfg = dict(max_new_tokens=1, temperature=0.0, num_beams=beams)
    want = np.asarray(JGenerator(jmodel, JGenCfg(**cfg)).generate(
        params, jnp.asarray(prompt)))
    _assert_no_near_tie(lambda t: _jax_full_logits(jmodel, params, t),
                        prompt, want)
    got = Generator(tmodel, GenerationConfig(**cfg)).generate(prompt)
    assert got.shape == (2, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_layer_scan_false_equals_default(models):
    _, _, tmodel = models
    prompt = _prompt(30, (2, 8))
    cfg = GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=20)
    a = Generator(tmodel, cfg).generate(prompt, seed=3)
    b = Generator(tmodel, cfg, layer_scan=False).generate(prompt, seed=3)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="layer_scan"):
        Generator(tmodel, GenerationConfig(max_new_tokens=2, num_beams=2),
                  layer_scan=False)


def test_generator_refusals(models):
    _, _, tmodel = models

    class NoEmbed:
        pass

    with pytest.raises(TypeError, match="embed_at"):
        Generator(NoEmbed())
    assert Generator(tmodel, phase_timing=True).phase_timing  # obs/ ported
    with pytest.raises(ValueError, match="positional table"):
        Generator(tmodel, GenerationConfig(max_new_tokens=4990)).generate(
            np.zeros((1, 20), np.int64))


_BAD_CONFIGS = [
    dict(max_new_tokens=0), dict(temperature=-0.5), dict(top_k=0),
    dict(num_beams=0), dict(eos_token_id=-1), dict(pad_token_id=-2),
    dict(kv_block_size=0), dict(kv_block_size=12),
    dict(num_beams=2, eos_token_id=3), dict(spec_tokens=1),
    dict(spec_tokens=4, num_beams=2),
]


@pytest.mark.parametrize("kw", _BAD_CONFIGS)
def test_generation_config_errors_match_pipe_tpu(kw):
    with pytest.raises(ValueError) as want:
        JGenCfg(**kw)
    with pytest.raises(ValueError) as got:
        GenerationConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("check,cfg_kw,args,raises", [
    ("check_kv_headroom", dict(kv_block_size=16, max_new_tokens=10), (20,),
     True),
    ("check_kv_headroom", dict(max_new_tokens=10), (20, 8, 3), True),
    ("check_kv_headroom", dict(kv_block_size=16, max_new_tokens=12), (20,),
     False),
    ("check_kv_headroom", dict(max_new_tokens=12), (20, None), False),
    ("check_decode_headroom", dict(max_new_tokens=8), (30, 8, 24), True),
    ("check_decode_headroom", dict(max_new_tokens=8), (20, 8, 24, 4), False),
    ("check_decode_headroom", dict(max_new_tokens=8), (24, 8, 24), False),
])
def test_headroom_checks_match_pipe_tpu(check, cfg_kw, args, raises):
    """Each headroom check raises with JAX's message, or passes where JAX's
    passes."""
    def outcome(cfg):
        try:
            getattr(cfg, check)(*args)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(JGenCfg(**cfg_kw))
    assert outcome(GenerationConfig(**cfg_kw)) == want
    assert (want is not None) == raises


@pytest.mark.parametrize("eos", [None, 3, 9])
def test_sequence_lengths_match_pipe_tpu(eos):
    toks = np.array([[1, 3, 5, 3], [9, 9, 9, 9], [2, 2, 2, 2],
                     [4, 4, 4, 3]], np.int32)
    want = np.asarray(jseq_lengths(jnp.asarray(toks), eos))
    got = tgen.sequence_lengths(torch.from_numpy(toks), eos)
    np.testing.assert_array_equal(got.numpy(), want)
    got3 = tgen.sequence_lengths(torch.from_numpy(toks[None]), eos)
    assert got3.shape == (1, 4)


def test_check_positions_matches_pipe_tpu(models):
    jmodel, _, tmodel = models
    assert tmodel.max_position() == jmodel.max_position() == 5000
    tgen.check_positions(tmodel, 4000, 1000)
    for fn, model in ((jcheck_positions, jmodel),
                      (tgen.check_positions, tmodel)):
        with pytest.raises(ValueError, match=r"4001 \+ max_new_tokens 1000"):
            fn(model, 4001, 1000)
    tgen.check_positions(object(), 10 ** 9, 1)       # no capacity given


def test_sampling_reproducible_and_in_top_k(models):
    """Same seed, same tokens; another seed, other tokens; a passed
    generator equals its seed; every token lies in the top k of the
    teacher-forced logits of the sequence it extends."""
    _, _, tmodel = models
    prompt = np.zeros((3, 4), np.int64)
    k = 16
    g = Generator(tmodel, GenerationConfig(max_new_tokens=8, temperature=0.8,
                                           top_k=k))
    a = g.generate(prompt, seed=7)
    assert torch.equal(a, g.generate(prompt, seed=7))
    assert not torch.equal(a, g.generate(prompt, seed=8))
    assert torch.equal(a, g.generate(
        prompt, generator=torch.Generator().manual_seed(7)))
    full = torch.cat([torch.from_numpy(prompt), a], dim=1)
    with torch.no_grad():
        logits = tmodel.post_fn(tmodel.stage_fn(
            1, tmodel.stage_fn(0, tmodel.pre_fn(full))))
    chosen = logits[:, 3:-1]
    kth = torch.topk(chosen, k, dim=-1).values[..., -1]
    picked = torch.gather(chosen, -1, a[..., None])[..., 0]
    assert (picked >= kth).all()


def test_top_k_keeps_ties_and_greedy_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 2.0, 3.0, 2.0, -5.0]])
    cfg = GenerationConfig(temperature=0.0)
    assert int(tgen.sample_logits(logits, cfg)) == 1
    cfg = GenerationConfig(temperature=1.0, top_k=2)
    gen = torch.Generator().manual_seed(0)
    seen = {int(tgen.sample_logits(logits, cfg, gen)) for _ in range(200)}
    assert seen == {1, 3}
    cfg = GenerationConfig(temperature=1.0, top_k=3)      # ties at the 3rd
    seen = {int(tgen.sample_logits(logits, cfg, gen)) for _ in range(400)}
    assert seen == {1, 2, 3, 4}


@pytest.mark.parametrize("temperature,top_k", [(0.8, None), (1.3, 12)])
def test_sampling_distribution_chi_square(temperature, top_k):
    """One step, 40,000 draws from the same logits: counts against
    ``softmax(logits / T)`` (top-k renormalised), chi-square p > 1e-4."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(0, 2, size=40).astype(np.float32))
    n = 40_000
    cfg = GenerationConfig(temperature=temperature, top_k=top_k)
    draws = tgen.sample_logits(logits.expand(n, -1), cfg,
                               torch.Generator().manual_seed(1))
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


def test_from_sequential_shares_the_modules():
    cfg = tlm.LMConfig(**CFG)
    seq = tlm.build_sequential(cfg, device="cpu")
    model = tlm.PipelinedLM.from_sequential(cfg, seq, 2)
    assert model.embed is seq[0] and model.posenc is seq[1]
    assert all(a is b for a, b in zip(model.blocks, list(seq)[2:-1]))
    assert model.head is seq[-1] is model.decoder
    assert list(model.stage_blocks(1)) == list(seq)[4:6]
    keys = model.state_dict()
    assert len(keys) == len(seq.state_dict())
    assert {"embed.weight", "blocks.3.ff1.weight",
            "decoder.proj.weight"} <= set(keys)
    fresh = tlm.PipelinedLM(cfg, 2, device="cpu")
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)         # the same weights from seed 0
    with pytest.raises(ValueError, match="must divide"):
        tlm.PipelinedLM(cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="tutorial LM"):
        tlm.PipelinedLM.from_sequential(cfg, seq[:-1])


def test_pipelined_lm_forward_matches_pipe_tpu(models):
    """pre_fn -> stage_fn per stage -> post_fn on both sides."""
    jmodel, params, tmodel = models
    tokens = _prompt(8, (2, 12))
    with torch.no_grad():
        h = tmodel.pre_fn({"tokens": torch.from_numpy(tokens).long()})
        for s in range(tmodel.n_stages):
            h = tmodel.stage_fn(s, h)
        got = tmodel.post_fn(h).numpy()
    np.testing.assert_allclose(got, _jax_full_logits(jmodel, params, tokens),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


def test_embed_tree_matches_pipe_tpu(models):
    jmodel, params, tmodel = models
    tokens = _prompt(9, (2, 5))
    depths = np.array([0, 1, 1, 2, 2])
    want = jmodel.embed_tree(params[1], jnp.asarray(tokens), 7,
                             jnp.asarray(depths))
    with torch.no_grad():
        got = tmodel.embed_tree(torch.from_numpy(tokens).long(), 7,
                                torch.from_numpy(depths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_load_pipelined_lm_takes_both_layouts(models):
    from pipe_tpu.parallel.spmd import stack_stage_params
    _, (sp, pre, post), tmodel = models
    stacked = jax.tree_util.tree_map(np.asarray, stack_stage_params(sp))
    other = tlm.PipelinedLM(tlm.LMConfig(**CFG), 1, device="cpu")
    convert.load_pipelined_lm(other, (stacked, pre, post))
    for a, b in zip(other.parameters(), tmodel.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tmodel.blocks[3].ff1.weight.detach().numpy(),
                                  sp[1][1]["ff1"]["w"].T)
    with pytest.raises(ValueError, match="4 blocks of params"):
        convert.load_pipelined_lm(
            tlm.PipelinedLM(dataclasses.replace(tlm.LMConfig(**CFG),
                                                n_layers=2), device="cpu"),
            (sp, pre, post))


def _tiny_trainers():
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=2,
                               attn_impl="xla")
    tcfg = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2,
                               attn_impl="xla")
    kw = dict(batch_size=8, eval_batch_size=8, bptt=16, chunks=2,
              n_stages=2, n_data=1, lr=1e-2)
    jtr = jloop.Trainer(jcfg, jloop.TrainerConfig(**kw))
    jstate = jtr.init_state()
    ttr = tloop.Trainer(tcfg, tloop.TrainerConfig(**kw), device="cpu")
    tstate = ttr.init_state()
    convert.load_pipelined_lm_params(
        ttr.pipe, jax.tree_util.tree_map(np.asarray, jstate.params))
    return jtr, jstate, ttr, tstate


@pytest.mark.parametrize("num_beams", [1, 2])
def test_trainer_generate_matches_pipe_tpu(num_beams):
    jtr, jstate, ttr, tstate = _tiny_trainers()
    prompt = np.array(jax.random.randint(jax.random.key(4), (2, 6), 0,
                                         101, jnp.int32))
    want = np.asarray(jtr.generate(jstate, jnp.asarray(prompt),
                                   max_new_tokens=8, num_beams=num_beams))
    if num_beams == 1:
        _assert_no_near_tie(_port_logits(tlm.PipelinedLM.from_sequential(
            ttr.model_cfg, tl.Sequential(list(ttr.pipe)))), prompt, want)
    got = ttr.generate(tstate, prompt, max_new_tokens=8, num_beams=num_beams)
    np.testing.assert_array_equal(got.numpy(), want)
    # the trainer's own modules: a change of its weights shows in the next
    # call (negated logits)
    with torch.no_grad():
        for p in ttr.pipe[-1].parameters():
            p.neg_()
    assert not torch.equal(
        ttr.generate(tstate, prompt, max_new_tokens=8, num_beams=num_beams),
        got)


def test_generate_cli_resumes_a_trainer_checkpoint(tmp_path, capsys):
    """A 2-stage Trainer's checkpoint through ``--resume``: the same tokens
    as ``Trainer.generate``, greedy and int8 runs finish."""
    cfg = tlm.LMConfig().tiny()                      # 4 layers, vocab 101
    tr = tloop.Trainer(cfg, tloop.TrainerConfig(n_stages=2, chunks=2),
                       device="cpu")
    state = tr.init_state(seed=5)
    tr.save(str(tmp_path), state)
    want = tr.generate(state, np.array([[1, 2, 3, 4]] * 2),
                       max_new_tokens=7)
    argv = ["--tiny", "--device", "cpu", "--resume", str(tmp_path),
            "--max-new", "7", "--batch", "2"]
    assert gen_app.main(argv) == 0
    rows = [[int(t) for t in ln.split(",")]
            for ln in capsys.readouterr().out.split()]
    np.testing.assert_array_equal(np.array(rows), want.numpy())
    assert gen_app.main(argv + ["--int8", "--beams", "2"]) == 0
    assert len(capsys.readouterr().out.split()) == 2


@pytest.mark.parametrize("argv,message", [
    (["--stages", "2"], "A.8"),
    (["--prompts-file", "p.txt"], "no such file"),
    (["--context-shards", "2"], "A.10"),
    (["--family", "gpt2"], "A.10"),
    (["--prompt", "1,x"], "comma-separated integer"),
    (["--prompt", "1,101"], r"prompt ids must be in \[0, 101\)"),
    (["--prompt", ""], r"prompt ids must be in \[0, 101\)"),
    (["--eos", "101"], r"--eos must be in \[0, 101\)"),
    (["--eos", "3", "--beams", "2"], "--eos with beam search"),
    (["--batch", "0"], "--batch must be >= 1"),
    (["--max-new", "0"], "max_new_tokens must be >= 1"),
    (["--temperature", "-1"], "temperature must be >= 0"),
    (["--top-k", "0"], "top_k must be >= 1"),
    (["--resume", "/nonexistent/ckpt"], "no such directory"),
])
def test_generate_cli_bad_arguments_exit_2(argv, message, capsys):
    assert gen_app.main(["--tiny", "--device", "cpu"] + argv) == 2
    err = capsys.readouterr().err
    assert re.search(message, err), err


def test_generate_cli_checkpoint_of_another_depth_exits_2(tmp_path, capsys):
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2)
    tr = tloop.Trainer(cfg, tloop.TrainerConfig(n_stages=1, chunks=1),
                       device="cpu")
    tr.save(str(tmp_path), tr.init_state())
    assert gen_app.main(["--tiny", "--device", "cpu", "--resume",
                         str(tmp_path)]) == 2
    assert "2 blocks but the model has 4" in capsys.readouterr().err
