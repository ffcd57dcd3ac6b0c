"""GPT-2 generation and serving in pipe_tpu_torch against pipe_tpu's, at
``GPT2Config().tiny()`` from converted weights.

* ``PipelinedGPT2.embed_at`` at per-row tensor positions (the serve engine's
  slots) equals pipe_tpu's ``embed_at`` per row, a clamped row included
  (``dynamic_slice_in_dim`` clamps the window into ``wpe``): before the port
  took tensor positions, every served GPT-2 request failed after its first
  token.
* The port's ``ServeEngine`` over ``SingleDeviceSlotBackend(PipelinedGPT2)``
  returns ``ok`` requests whose greedy tokens equal pipe_tpu's engine and the
  port's batch-1 ``Generator`` wherever JAX's top-2 logit margin exceeds
  ``TIE_MARGIN`` (a near tie fails as a tie); the paged pool and the n-gram
  speculative lane give the tick path's tokens bit for bit.
* pipe_tpu's laws of tests/test_generate.py on the port: greedy generation
  equals a naive re-forward (the head's final LayerNorm included), and a
  request past ``wpe`` is refused by the position guard.
* ``apps.generate`` and ``apps.serve --family gpt2 --tiny --device cpu`` run;
  a tree draft exits 2 with the engine's message (GPT-2 has no
  ``embed_tree``, in pipe_tpu too); ``--resume`` exits 2.
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
from pipe_tpu.models import gpt2 as jgpt2
from pipe_tpu.serve import BucketSpec as JBucketSpec
from pipe_tpu.serve import ServeEngine as JServeEngine
from pipe_tpu.serve import SingleDeviceSlotBackend as JBackend
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.apps import serve as serve_app
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import gpt2 as tgpt2
from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                  SingleDeviceSlotBackend)

JCFG = jgpt2.GPT2Config().tiny()          # seq_len 16 = wpe rows
TCFG = tgpt2.GPT2Config().tiny()
# The two frameworks' fp32 logits differ by ~1e-6 here; a JAX top-2 margin
# below this would let rounding pick the other token.
TIE_MARGIN = 1e-4
PROMPTS = [[5, 9, 2], [7, 1, 8, 3, 4], [11, 6, 2, 9], [3, 3, 8, 1, 5, 7, 2]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    """(JAX PipelinedGPT2, its numpy params, the port's model with them)."""
    jmodel = jgpt2.PipelinedGPT2(JCFG, 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(9)))
    tmodel = tgpt2.PipelinedGPT2(TCFG, 2, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, tmodel


def _jax_logits(jmodel, params, seq):
    sp, pre, post = params
    ctx = JCtx(train=False)
    h = jmodel.pre_fn(pre, jnp.asarray(seq, jnp.int32), ctx)
    for blocks in sp:
        h = jmodel.stage_fn(blocks, h, ctx)
    return np.asarray(jmodel.head.apply(post["head"], h, ctx=ctx))


def _assert_no_near_tie(jmodel, params, prompt, toks):
    logits = _jax_logits(jmodel, params, [list(prompt) + list(toks)])[0]
    p = len(prompt)
    top2 = np.sort(logits[p - 1:p - 1 + len(toks)], axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min()
    assert margin > TIE_MARGIN, f"near tie in JAX's logits: {margin:.2e}"


def test_embed_at_takes_per_row_positions_like_pipe_tpu(models):
    jmodel, params, tmodel = models
    _, pre, _ = params
    q = 3
    tokens = np.random.default_rng(0).integers(0, JCFG.vocab, (4, q))
    # the last row's window [15, 18) runs past wpe: both clamp it to [13, 16)
    pos = np.array([0, 4, JCFG.seq_len - q, JCFG.seq_len - 1])
    want = np.asarray(jax.vmap(
        lambda t, p: jmodel.embed_at(pre, t[None], p)[0])(
            jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32)))
    with torch.no_grad():
        got = tmodel.embed_at(torch.from_numpy(tokens).long(),
                              torch.from_numpy(pos).long()).numpy()
        host = [tmodel.embed_at(torch.from_numpy(tokens[r:r + 1]).long(),
                                p)[0].numpy()
                for r, p in ((1, 4), (3, JCFG.seq_len - q))]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], host[0])
    np.testing.assert_array_equal(got[3], host[1])          # the clamped row
    with pytest.raises(ValueError, match="positional table"):   # past wpe
        tmodel.embed_at(torch.zeros((1, q), dtype=torch.long),
                        JCFG.seq_len - 1)


def _staggered(eng, prompts):
    ids = [eng.submit(prompts[0], seed=3).id]
    eng.tick()
    ids += [eng.submit(p, seed=3).id for p in prompts[1:]]
    eng.run_until_idle()
    return [eng.response(i) for i in ids]


def _port_engine(tmodel, **kw):
    gen = GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0)
    kw.setdefault("max_len", 8 + MAX_NEW)
    return ServeEngine(SingleDeviceSlotBackend(
        tmodel, num_slots=2, gen=gen, buckets=BucketSpec.of(4, 8), **kw))


def test_engine_greedy_tokens_equal_pipe_tpus_engine_and_generator(models):
    jmodel, params, tmodel = models
    jeng = JServeEngine(JBackend(
        jmodel, params, num_slots=2, max_len=8 + MAX_NEW,
        gen=JGenCfg(max_new_tokens=MAX_NEW, temperature=0.0),
        buckets=JBucketSpec.of(4, 8)))
    want = [r.tokens for r in _staggered(jeng, PROMPTS)]
    gen = Generator(tmodel, GenerationConfig(max_new_tokens=MAX_NEW,
                                             temperature=0.0))
    refs = [gen.generate([p])[0].tolist() for p in PROMPTS]
    resps = _staggered(_port_engine(tmodel), PROMPTS)
    for prompt, resp, w, ref in zip(PROMPTS, resps, want, refs):
        _assert_no_near_tie(jmodel, params, prompt, w)
        assert resp.status == "ok" and resp.finish_reason == "length"
        assert resp.tokens == w == ref
    # the paged pool and the n-gram speculative lane: the tick path's bits
    tick = [r.tokens for r in resps]
    paged = _staggered(_port_engine(tmodel, kv_block_size=2,
                                    prefill_chunk=4), PROMPTS)
    assert [r.tokens for r in paged] == tick
    # (the verify writes K - 1 = 2 rows of headroom past the request cap)
    spec = _staggered(_port_engine(tmodel, resident=True, resident_chunks=2,
                                   spec_tokens=3, max_len=8 + MAX_NEW + 2),
                      PROMPTS)
    assert [r.status for r in spec] == ["ok"] * len(PROMPTS)
    assert [r.tokens for r in spec] == tick


def test_greedy_generation_matches_naive_reforward(models):
    """pipe_tpu's test_gpt2_greedy_generation_matches_naive_reforward on the
    port: the cached decode equals re-running the whole sequence, and JAX's
    generator where its margins are wide."""
    jmodel, params, tmodel = models
    prompt = np.random.default_rng(10).integers(0, JCFG.vocab, (2, 6))
    gen_cfg = GenerationConfig(max_new_tokens=5, temperature=0.0)
    fast = Generator(tmodel, gen_cfg).generate(prompt).numpy()
    seq = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(5):
            h = tmodel.pre_fn(seq)
            for s in range(tmodel.n_stages):
                h = tmodel.stage_fn(s, h)
            nxt = tmodel.post_fn(h)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(fast, seq[:, 6:].numpy())
    from pipe_tpu.inference import Generator as JGenerator
    want = np.asarray(JGenerator(jmodel, JGenCfg(
        max_new_tokens=5, temperature=0.0)).generate(
            params, jnp.asarray(prompt, jnp.int32)))
    for row, w, p in zip(fast, want, prompt):
        _assert_no_near_tie(jmodel, params, p, w)
        np.testing.assert_array_equal(row, w)


def test_position_guard(models):
    _, _, tmodel = models
    g = Generator(tmodel, GenerationConfig(max_new_tokens=14))
    with pytest.raises(ValueError, match="positional table"):
        g.generate(torch.zeros((1, 4), dtype=torch.long))   # 4 + 14 > 16


def test_generate_and_serve_clis_run_gpt2(tmp_path, capsys):
    assert gen_app.main(["--family", "gpt2", "--tiny", "--device", "cpu",
                         "--max-new", "6", "--batch", "2"]) == 0
    rows = capsys.readouterr().out.split()
    assert len(rows) == 2 and len(rows[0].split(",")) == 6
    prompts = tmp_path / "p.txt"
    prompts.write_text("".join(",".join(map(str, p)) + "\n"
                               for p in PROMPTS))
    argv = ["--family", "gpt2", "--tiny", "--device", "cpu",
            "--prompts-file", str(prompts), "--max-new", "4"]
    assert serve_app.main(argv + ["--slots", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(l)["status"] for l in lines[:-1]] == \
        ["ok"] * len(PROMPTS)
    assert serve_app.main(argv + ["--resident", "on", "--draft", "tree",
                                  "--spec-tokens", "3",
                                  "--spec-branches", "2"]) == 2
    assert "PipelinedGPT2 has no embed_tree" in capsys.readouterr().err
    assert gen_app.main(["--family", "gpt2", "--tiny", "--device", "cpu",
                         "--resume", str(tmp_path)]) == 2
    assert "tutorial LM" in capsys.readouterr().err
