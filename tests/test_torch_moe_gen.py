"""pipe_tpu_torch's MoE decoding: ``moe_block_decode`` through the one-device
``Generator`` and ``TPShardedGenerator`` over ``MoEPipelinedLM`` on a model
line of 2 and of 4 ranks, against pipe_tpu's.

tests/test_moe_gen.py's ``CFG`` (capacity factor = n_experts: nothing ever
drops, in the cached decode or a full-sequence forward, so the two agree
exactly). One 4-rank gloo world of CPU ranks is spawned for the module and
fed the cases of ``tests/torch_moe_cases.py`` (no JAX there): each rank
loads every weight of ``pipe_tpu``'s ``MoEPipelinedLM.init`` params and the
generator cuts the heads and experts to its model block, on a mesh of
``(1, 2, 2)`` (two data replicas of a line of 2) or ``(1, 1, 4)`` (one
expert and one head a rank). Greedy tokens bit for bit against JAX's
``Generator`` on the unsharded model and JAX's ``TPShardedGenerator`` over
``make_mesh(1, 1, n_model=tp)``; beam tokens bit for bit and scores within
1e-5; every rank's tokens equal; three all-reduces a layer a decode call.
The port's ``Generator`` equals a naive re-forward of the whole sequence,
and JAX's. The validations use JAX's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference import Generator as JGenerator
from pipe_tpu.inference.tp import TPShardedGenerator as JTPGen
from pipe_tpu.models.moe_lm import MoELMConfig as JMoECfg
from pipe_tpu.models.moe_lm import MoEPipelinedLM as JMoELM
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu_torch import convert
from pipe_tpu_torch.core.partition import StageCtx
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models.moe_lm import MoELMConfig, MoEPipelinedLM
from pipe_tpu_torch.runtime import World

CFG = dict(vocab=67, d_model=32, nhead=4, d_ff=64, n_layers=2, seq_len=32,
           dropout=0.0, n_experts=4, top_k=2, capacity_factor=4.0)
SHAPES = {2: (1, 2, 2), 4: (1, 1, 4)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


_JAX = {}


def _params():
    """``pipe_tpu``'s ``MoEPipelinedLM(CFG, 2, ep_axis=None).init`` params
    (numpy), as tests/test_moe_gen.py draws them."""
    if "p" not in _JAX:
        _JAX["p"] = jax.tree_util.tree_map(np.asarray, JMoELM(
            JMoECfg(**CFG), 2, ep_axis=None).init(jax.random.key(4)))
    return _JAX["p"]


def _prompt(b, p, seed=1):
    return np.random.default_rng(seed).integers(0, CFG["vocab"], (b, p)
                                                ).astype(np.int64)


def _jax_tokens(tp, prompt, gen_kw):
    """JAX's ``Generator`` (unsharded) and ``TPShardedGenerator`` tokens
    (with the beams' scores), once per case."""
    key = (tp, prompt.shape, tuple(sorted(gen_kw.items())))
    if key not in _JAX:
        params = _params()
        cfg = JGenCfg(**gen_kw)
        jp = jnp.asarray(prompt, jnp.int32)
        one = JGenerator(JMoELM(JMoECfg(**CFG), 2, ep_axis=None), cfg)
        g = JTPGen(jmake_mesh(1, 1, n_model=tp,
                              devices=jax.devices()[:tp]),
                   JMoELM(JMoECfg(**CFG), 2), cfg)
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


def _port_model():
    model = MoEPipelinedLM(MoELMConfig(**CFG), 2, ep_axis=None, device="cpu")
    convert.load_pipelined_lm(model, _params())
    return model


@pytest.mark.parametrize("tp,b,p,max_new", [(2, 2, 8, 5), (4, 2, 8, 4)])
def test_greedy_matches_pipe_tpu(world, tp, b, p, max_new):
    """Every rank's greedy tokens equal JAX's unsharded ``Generator``'s (and
    its ``TPShardedGenerator``'s); each rank holds ``E / tp`` experts and
    ``H / tp`` heads and caches its heads; the greedy call's all-reduces
    are three a layer a decode call (the prefill and one a new token but
    the last)."""
    prompt = _prompt(b, p)
    gen_kw = dict(max_new_tokens=max_new, temperature=0.0)
    (ref,), (jtp,) = _jax_tokens(tp, prompt, gen_kw)
    np.testing.assert_array_equal(jtp, ref)
    res = world.run(cases.generate, _params(), CFG, SHAPES[tp], prompt,
                    gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], ref)
        assert r["heads"] == CFG["nhead"] // tp
        assert r["experts"] == CFG["n_experts"] // tp
        assert r["cache"] == (1, 4, CFG["nhead"] // tp,
                              CFG["d_model"] // CFG["nhead"])
        assert r["allreduces"] == 3 * CFG["n_layers"] * max_new


@pytest.mark.parametrize("tp", [2, 4])
def test_beam_matches_pipe_tpu(world, tp):
    """Tokens and scores of ``generate_with_scores`` over the expert-sharded
    weights against JAX's unsharded ``Generator`` and its
    ``TPShardedGenerator`` (the dense dispatch holds under the b*k beam
    batch); ``generate`` routes beams through beam search."""
    prompt = _prompt(2, 8, seed=5)
    gen_kw = dict(max_new_tokens=5, num_beams=2)
    (ref_toks, ref_scores), (jtoks, jscores) = _jax_tokens(tp, prompt,
                                                           gen_kw)
    np.testing.assert_array_equal(jtoks, ref_toks)
    res = world.run(cases.generate, _params(), CFG, SHAPES[tp], prompt,
                    gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["beam"], ref_toks)
        np.testing.assert_allclose(r["scores"], ref_scores, rtol=1e-5)
        np.testing.assert_array_equal(r["tokens"], ref_toks)


def test_greedy_is_the_naive_reforward_and_pipe_tpus():
    """tests/test_moe_gen.py's law on the port: the cached greedy stream
    equals the argmax of a naive re-forward of the whole sequence through
    ``stage_fn`` (eval), token for token, and JAX's ``Generator``'s."""
    model = _port_model()
    prompt = _prompt(2, 6, seed=3)
    max_new = 5
    fast = Generator(model, GenerationConfig(max_new_tokens=max_new,
                                             temperature=0.0)
                     ).generate(torch.from_numpy(prompt)).numpy()
    seq = torch.from_numpy(prompt)
    ctx = StageCtx(train=False)
    naive = []
    with torch.no_grad():
        for _ in range(max_new):
            h = model.pre_fn({"tokens": seq}, ctx)
            for s in range(model.n_stages):
                h = model.stage_fn(s, h, ctx)
            logits = model.post_fn(h, ctx)
            nxt = logits[:, -1].argmax(-1)
            naive.append(nxt.numpy())
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(fast, np.stack(naive, axis=1))
    (ref,), _ = _jax_tokens(2, prompt, dict(max_new_tokens=max_new,
                                            temperature=0.0))
    np.testing.assert_array_equal(fast, ref)


def test_generator_validations_are_pipe_tpus(world):
    """The model built without the model axis, experts that the line does
    not divide (JAX's words of ``moe_ffn_apply``), heads that it does
    not."""
    res = world.run(cases.generator_refusals, CFG, SHAPES[4])[0]
    assert res["ep_axis"] == (
        "ValueError", "TPShardedGenerator needs a model built with "
        "tp_axis='model' (got None)")
    assert res["experts"] == (
        "ValueError", "n_experts=6 not divisible by the expert-axis size 4: "
        "orphaned experts would receive router mass but produce zero "
        "output")
    assert res["nhead"] == ("ValueError", "nhead=2 must divide over tp=4")
