"""pipe_tpu_torch's ``TPShardedGenerator`` (``inference/tp.py``) over a
model line of 2 and of 4 ranks, against pipe_tpu's.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_tp_cases.py`` (no JAX there): each rank loads every
weight of ``pipe_tpu``'s ``TPPipelinedLM.init`` params
(``convert.load_pipelined_lm``) and the generator cuts the sharded leaves
to its model block, on a mesh of ``(1, 2, 2)`` (two data replicas of a
line of 2) or ``(1, 1, 4)``. tests/test_tp_gen.py's cases: greedy tokens
bit for bit against JAX's ``Generator`` on the unsharded model and JAX's
``TPShardedGenerator`` over ``make_mesh(1, 1, n_model=tp)``; beam tokens
bit for bit and scores within 1e-5; every rank's tokens equal. Sampled
tokens are the port's one-device ``Generator`` stream, seed for seed (JAX's
key chain is not reproduced). The three validations use JAX's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference import Generator as JGenerator
from pipe_tpu.inference.tp import TPShardedGenerator as JTPGen
from pipe_tpu.models.tp_lm import TPPipelinedLM as JTPLM
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models.tp_lm import TPPipelinedLM
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.runtime import World

CFG = dict(vocab=73, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
SHAPES = {2: (1, 2, 2), 4: (1, 1, 4)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


_JAX = {}


def _params():
    """``pipe_tpu``'s ``TPPipelinedLM(CFG, 2, tp_axis=None).init`` params
    (numpy), as tests/test_tp_gen.py draws them."""
    if "p" not in _JAX:
        _JAX["p"] = jax.tree_util.tree_map(np.asarray, JTPLM(
            JLMConfig(**CFG), 2, tp_axis=None).init(jax.random.key(0)))
    return _JAX["p"]


def _prompt(b, p):
    return np.random.default_rng(1).integers(0, CFG["vocab"], (b, p)
                                             ).astype(np.int64)


def _jax_tokens(tp, prompt, gen_kw):
    """JAX's ``Generator`` (unsharded) and ``TPShardedGenerator`` tokens
    (with the beams' scores), once per case."""
    key = (tp, prompt.shape, tuple(sorted(gen_kw.items())))
    if key not in _JAX:
        params = _params()
        cfg = JGenCfg(**gen_kw)
        jp = jnp.asarray(prompt, jnp.int32)
        one = JGenerator(JTPLM(JLMConfig(**CFG), 2, tp_axis=None), cfg)
        g = JTPGen(jmake_mesh(1, 1, n_model=tp,
                              devices=jax.devices()[:tp]),
                   JTPLM(JLMConfig(**CFG), 2), cfg)
        if cfg.num_beams > 1:
            ref = [np.asarray(a) for a in one.generate_with_scores(params,
                                                                   jp)]
            got = [np.asarray(a) for a in g.generate_with_scores(params,
                                                                 jp)]
        else:
            ref = [np.asarray(one.generate(params, jp))]
            got = [np.asarray(g.generate(params, jp))]
        _JAX[key] = (ref, got)
    return _JAX[key]


@pytest.mark.parametrize("tp,b,p,max_new", [(2, 2, 8, 6), (4, 2, 8, 4)])
def test_greedy_matches_pipe_tpu(world, tp, b, p, max_new):
    prompt = _prompt(b, p)
    gen_kw = dict(max_new_tokens=max_new, temperature=0.0)
    (ref,), (jtp,) = _jax_tokens(tp, prompt, gen_kw)
    np.testing.assert_array_equal(jtp, ref)
    res = world.run(cases.generate, _params(), CFG, SHAPES[tp], prompt,
                    gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], ref)
        assert r["heads"] == CFG["nhead"] // tp
        assert r["cache"] == (1, 4, CFG["nhead"] // tp,
                              CFG["d_model"] // CFG["nhead"])


@pytest.mark.parametrize("tp", [2, 4])
def test_beam_matches_pipe_tpu(world, tp):
    """Tokens and scores of ``generate_with_scores`` against JAX's
    unsharded ``Generator`` and its ``TPShardedGenerator``; ``generate``
    routes beams through beam search."""
    prompt = _prompt(2, 8)
    gen_kw = dict(max_new_tokens=5, num_beams=3)
    (ref_toks, ref_scores), (jtoks, _) = _jax_tokens(tp, prompt, gen_kw)
    np.testing.assert_array_equal(jtoks, ref_toks)
    res = world.run(cases.generate, _params(), CFG, SHAPES[tp], prompt,
                    gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["beam"], ref_toks)
        np.testing.assert_allclose(r["scores"], ref_scores, rtol=1e-5)
        np.testing.assert_array_equal(r["tokens"], ref_toks)


def test_sampled_is_the_one_device_stream(world):
    """Sampled tokens over a line of 2: every rank's equal to the port's
    one-device ``Generator``'s for the seed."""
    prompt = _prompt(2, 8)
    gen_kw = dict(max_new_tokens=8, temperature=0.8, top_k=20)
    model = TPPipelinedLM(LMConfig(**CFG), 1, tp_axis=None, device="cpu")
    convert.load_pipelined_lm(model, _params())
    want = Generator(model, GenerationConfig(**gen_kw)).generate(
        prompt, seed=11).numpy()
    res = world.run(cases.generate, _params(), CFG, SHAPES[2], prompt,
                    gen_kw, 11)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)


def test_generator_validations_are_pipe_tpus(world):
    res = world.run(cases.generator_refusals, CFG, SHAPES[4])[0]
    assert res["tp_axis"] == (
        "ValueError", "TPShardedGenerator needs a model built with "
        "tp_axis='model' (got None)")
    assert res["axis"] == ("ValueError", "mesh must have a 'model' axis")
    assert res["nhead"] == ("ValueError", "nhead=2 must divide over tp=4")
    assert res["beams"] == ("ValueError", "generate_with_scores requires "
                            "num_beams >= 2")
