"""pipe_tpu_torch's ``ContextShardedGenerator``
(``inference/long_context.py``) and ``apps.generate --context-shards N``,
against pipe_tpu's.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_context_cases.py`` (no JAX there): each rank holds
every weight of ``pipe_tpu``'s ``ContextParallelLM.init`` params
(``convert.load_pipelined_lm``) on a context line of 2 (two data
replicas) or 4 ranks. The JAX references run once per case on the virtual
CPU devices: ``ContextShardedGenerator`` over ``make_mesh(1, 1,
n_context=n)`` at tests/test_long_context_gen.py's cases (greedy tokens bit
for bit, beam tokens bit for bit and scores within 1e-5), with the port's
one-device ``Generator`` on the same weights beside them. Sampled tokens
are the port's one-device ``Generator`` stream, seed for seed (JAX's key
chain is not reproduced, ROADMAP.md C.24).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_context_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.apps import generate as jgen_app
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference.long_context import ContextShardedGenerator as JCSG
from pipe_tpu.models.long_context_lm import ContextParallelLM as JCPLM
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.runtime import World

CFG = dict(vocab=83, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=64,
           dropout=0.0)
SHAPES = {2: (1, 2, 2), 4: (1, 1, 4)}
TOL_SCORES = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


_PARAMS = {}


def _params():
    """``pipe_tpu``'s ``ContextParallelLM(CFG, 2).init`` params (numpy),
    as tests/test_long_context_gen.py draws them."""
    if not _PARAMS:
        jmodel = JCPLM(JLMConfig(**CFG), n_stages=2)
        _PARAMS["p"] = jax.tree_util.tree_map(
            np.asarray, jmodel.init(jax.random.key(0)))
    return _PARAMS["p"]


def _prompt(b, p, seed=1):
    return np.array(jax.random.randint(jax.random.key(seed), (b, p), 0,
                                       CFG["vocab"], jnp.int32))


def _jax(n, gen_kw, prompt):
    g = JCSG(jmake_mesh(1, 1, n_context=n), JCPLM(JLMConfig(**CFG), 2),
             JGenCfg(**gen_kw))
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    if gen_kw.get("num_beams", 1) > 1:
        toks, sc = g.generate_with_scores(params, jnp.asarray(prompt))
        return np.asarray(toks), np.asarray(sc)
    return np.asarray(g.generate(params, jnp.asarray(prompt))), None


def _one_device(gen_kw, prompt, seed=0):
    model = tlm.PipelinedLM(tlm.LMConfig(attn_impl="xla", **CFG), 2,
                            device="cpu")
    convert.load_pipelined_lm(model, _params())
    g = Generator(model, GenerationConfig(**gen_kw))
    if gen_kw.get("num_beams", 1) > 1:
        return [t.numpy() for t in g.generate_with_scores(prompt)]
    return g.generate(prompt, seed=seed).numpy()


@pytest.mark.parametrize("n_ctx,b,p,max_new", [
    (2, 2, 16, 6),
    (4, 2, 16, 5),
    (4, 1, 32, 4),
])
def test_greedy_matches_pipe_tpu(world, n_ctx, b, p, max_new):
    """Greedy tokens of every rank bit for bit JAX's context-sharded
    generator's and the port's one-device ``Generator``'s; each layer of
    each decode step is one max and one sum all-reduce over the line."""
    prompt = _prompt(b, p)
    gen_kw = dict(max_new_tokens=max_new, temperature=0.0)
    want, _ = _jax(n_ctx, gen_kw, prompt)
    np.testing.assert_array_equal(_one_device(gen_kw, prompt), want)
    res = world.run(cases.generate, _params(), CFG, SHAPES[n_ctx], prompt,
                    gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
    # the first token: one sum; each decode step: a max and a sum a layer
    coll = res[0]["stats"]["collectives"]
    assert coll == 1 + 2 * CFG["n_layers"] * (max_new - 1)


@pytest.mark.parametrize("n_ctx,b,p,max_new,k", [
    (2, 2, 16, 6, 3),
    (4, 2, 16, 4, 2),
    (2, 1, 16, 1, 2),   # max_new=1: beams seeded by prefill only
])
def test_beam_matches_pipe_tpu(world, n_ctx, b, p, max_new, k):
    """Beam tokens bit for bit JAX's context-sharded beam search, scores
    within 1e-5 relative; ``generate`` with beams routes to it."""
    prompt = _prompt(b, p)
    gen_kw = dict(max_new_tokens=max_new, num_beams=k)
    want, want_sc = _jax(n_ctx, gen_kw, prompt)
    res = world.run(cases.generate, _params(), CFG, SHAPES[n_ctx], prompt,
                    gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_array_equal(r["routed"], want)
        np.testing.assert_allclose(r["scores"], want_sc, rtol=TOL_SCORES,
                                   atol=TOL_SCORES)


def test_sampling_is_the_generators_stream(world):
    """Sampled (temperature 0.9, top-k 8): every rank draws the same
    uniforms from a generator seeded alike, so the tokens agree on every
    rank, repeat for a seed, change with it, and are the port's one-device
    ``Generator`` stream seed for seed."""
    prompt = np.zeros((2, 8), np.int64)
    gen_kw = dict(max_new_tokens=6, temperature=0.9, top_k=8)
    got = {s: world.run(cases.generate, _params(), CFG, SHAPES[2], prompt,
                        gen_kw, s) for s in (5, 6)}
    for s, res in got.items():
        for r in res:
            np.testing.assert_array_equal(r["tokens"], res[0]["tokens"])
        np.testing.assert_array_equal(res[0]["tokens"],
                                      _one_device(gen_kw, prompt, seed=s))
    again = world.run(cases.generate, _params(), CFG, SHAPES[4], prompt,
                      gen_kw, 5)
    np.testing.assert_array_equal(again[0]["tokens"], got[5][0]["tokens"])
    assert (got[5][0]["tokens"] != got[6][0]["tokens"]).any()
    assert ((got[5][0]["tokens"] >= 0)
            & (got[5][0]["tokens"] < CFG["vocab"])).all()


def test_validations_are_pipe_tpus(world):
    """JAX's ``test_context_sharded_validations``: the prompt must divide,
    ``generate_with_scores`` needs beams, the mesh needs a context axis;
    and the positional table's guard."""
    res = world.run(cases.generator_refusals, _params(), CFG, SHAPES[2])[0]
    assert res["divide"] == (
        "ValueError", "prompt length 7 must divide over 2 context shards")
    assert res["beams"] == ("ValueError",
                            "generate_with_scores requires num_beams >= 2")
    assert res["mesh"] == ("ValueError", "mesh must have a 'context' axis")
    assert res["positions"][0] == "ValueError"
    assert "exceeds the positional table" in res["positions"][1]
    g = JCSG(jmake_mesh(1, 1, n_context=2), JCPLM(JLMConfig(**CFG), 2),
             JGenCfg(max_new_tokens=2))
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    with pytest.raises(ValueError, match=res["divide"][1]):
        g.generate(params, jnp.zeros((1, 7), jnp.int32))
    with pytest.raises(ValueError, match=res["beams"][1]):
        g.generate_with_scores(params, jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError, match=res["mesh"][1]):
        JCSG(jmake_mesh(2, 1), JCPLM(JLMConfig(**CFG), 2),
             JGenCfg(max_new_tokens=2))


def test_generate_cli_context_shards_2(capsys):
    """``apps.generate --context-shards 2 --tiny --device cpu``: the rows
    of rank 0 are ``--context-shards 1``'s and JAX's context-sharded
    generator's on the same (the port's seed-drawn) weights."""
    from types import SimpleNamespace

    base = ["--tiny", "--device", "cpu", "--max-new", "6", "--batch", "2",
            "--prompt", "3,1,4,1,5,9,2,6"]
    assert gen_app.main(base + ["--context-shards", "2"]) == 0
    got = capsys.readouterr().out.split()
    assert gen_app.main(base) == 0
    assert capsys.readouterr().out.split() == got and len(got) == 2
    args = SimpleNamespace(family="lm", seed=0, device="cpu", int8=False,
                           resume=None)
    cfg = tlm.LMConfig().tiny()
    model = gen_app.build_model(args, cfg, None)
    jcfg = JLMConfig().tiny()
    template = JCPLM(jcfg, 1).init(jax.random.key(0))
    params = convert.pipelined_lm_tree(
        model, {n: p.detach().numpy() for n, p in model.named_parameters()},
        template)
    want = JCSG(jmake_mesh(1, 1, n_context=2), JCPLM(jcfg, 1),
                JGenCfg(max_new_tokens=6, temperature=0.0)).generate(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray([[3, 1, 4, 1, 5, 9, 2, 6]] * 2, jnp.int32))
    assert got == [",".join(str(int(t)) for t in row)
                   for row in np.asarray(want)]


@pytest.mark.parametrize("argv", [
    ["--family", "gpt2"],
    ["--stages", "2"],
    ["--beams", "2"],
    ["--int8"],
    ["--prompt", "1,2,3,4,5"],
    ["--prompts-file", "FILE"],
])
def test_generate_cli_context_refusals_are_pipe_tpus(argv, tmp_path,
                                                     capsys):
    """Every refusal of ``--context-shards 2`` exits 2 with ``pipe_tpu``'s
    words: the plain LM's single-stage float path only, a prompt length
    that divides, no ``--prompts-file``."""
    path = tmp_path / "prompts.txt"
    path.write_text("1,2\n")
    argv = [str(path) if a == "FILE" else a for a in argv]
    argv = ["--tiny", "--context-shards", "2"] + argv
    assert jgen_app.main(argv) == 2
    want = capsys.readouterr().err.strip()
    assert gen_app.main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip() == want
    assert want
