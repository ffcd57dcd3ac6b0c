"""pipe_tpu_torch's ring decoder (``inference/pipelined.py``) and
``Trainer.generate`` over a mesh, against pipe_tpu's.

One 4-rank gloo world of CPU ranks (``torch.set_num_threads(1)``) is spawned
for the module and fed the cases of ``tests/torch_ring_cases.py``, which
imports no JAX: each rank takes its stage of ``pipe_tpu``'s stage-stacked
params (``convert.load_ring_stage``) on a 2-stage (2 x 2 data: two rings) or
4-stage mesh. The JAX references run once per case on the virtual CPU
devices: ``PipelinedGenerator`` over ``make_mesh(n, 1)`` and the port's
one-device ``Generator`` from the same weights, at the cases of
tests/test_pipelined_gen.py (greedy and beam at 2 and 4 stages,
``max_new=1``), EOS lengths, int8 weights (``quantize_params``' codes),
the batch refusal, sampled draws (the port's ``Generator`` stream, seed for
seed), and ``Trainer.generate`` over a 2 x 2 mesh against JAX's
``Trainer(n_stages=2, n_data=2)``, the interleaved layout included.
Attention is plain on both sides.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ring_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference.pipelined import PipelinedGenerator as JRing
from pipe_tpu.inference.quant import QuantLeaf
from pipe_tpu.inference.quant import quantize_params as jquantize
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.runtime import World

CFG = dict(vocab=79, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
TOL_SCORES = 1e-5            # relative, beam scores
SHAPES = {2: (2, 2), 4: (4, 1)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


_MODELS = {}


def _setup(n):
    """JAX's ``PipelinedLM`` of ``n`` stages and its params (numpy), as
    tests/test_pipelined_gen.py draws them, once per stage count."""
    if n not in _MODELS:
        jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), n)
        params = jax.tree_util.tree_map(np.asarray,
                                        jmodel.init(jax.random.key(0)))
        _MODELS[n] = (jmodel, params)
    return _MODELS[n]


def _numpy(tree):
    """A JAX tree as numpy, each ``QuantLeaf`` as a namespace of its codes
    and scales (the ranks import no JAX)."""
    return jax.tree_util.tree_map(
        lambda x: (types.SimpleNamespace(q=np.asarray(x.q),
                                         scale=np.asarray(x.scale))
                   if isinstance(x, QuantLeaf) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, QuantLeaf))


def _ring_params(params, int8=False):
    sp, pre, post = params
    if int8:
        sp = jquantize(jax.tree_util.tree_map(jnp.asarray, sp))
    return (_numpy(stack_stage_params(sp)), pre, post)


def _jax_ring(n, params, gen_kw, prompt, int8=False):
    jmodel, _ = _setup(n)
    sp, pre, post = params
    if int8:
        sp = jquantize(jax.tree_util.tree_map(jnp.asarray, sp))
    ring = JRing(jmake_mesh(n, 1), jmodel, JGenCfg(**gen_kw))
    args = (stack_stage_params(sp), pre, post, jnp.asarray(prompt))
    if gen_kw.get("num_beams", 1) > 1:
        toks, scores = ring.generate_with_scores(*args)
        return np.asarray(toks), np.asarray(scores)
    toks, lens = ring.generate_with_lengths(*args)
    return np.asarray(toks), np.asarray(lens)


def _port_generator(n, params):
    tmodel = tlm.PipelinedLM(tlm.LMConfig(attn_impl="xla", **CFG), n,
                             device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return tmodel


def _prompt(batch, p, seed=1):
    return np.array(jax.random.randint(jax.random.key(seed), (batch, p), 0,
                                       CFG["vocab"], jnp.int32))


@pytest.mark.parametrize("n_stages,batch,p,max_new", [
    (2, 4, 8, 6),
    (4, 4, 5, 5),
    (2, 2, 8, 1),   # max_new=1: prefill-only output
])
def test_ring_greedy_matches_pipe_tpu(world, n_stages, batch, p, max_new):
    """Greedy tokens of every rank bit for bit JAX's ring decoder's and
    the port's one-device ``Generator``'s."""
    _, params = _setup(n_stages)
    prompt = _prompt(batch, p)
    gen_kw = dict(max_new_tokens=max_new, temperature=0.0)
    want, _ = _jax_ring(n_stages, params, gen_kw, prompt)
    one = Generator(_port_generator(n_stages, params),
                    GenerationConfig(**gen_kw)).generate(prompt).numpy()
    np.testing.assert_array_equal(one, want)
    res = world.run(cases.ring_generate, _ring_params(params), CFG,
                    SHAPES[n_stages], prompt, gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)


@pytest.mark.parametrize("n_stages,batch,p,max_new,k", [
    (2, 4, 8, 6, 3),
    (4, 4, 5, 4, 2),
    (2, 2, 8, 1, 2),   # max_new=1: beams seeded by prefill only
])
def test_ring_beam_matches_pipe_tpu(world, n_stages, batch, p, max_new, k):
    """Beam tokens bit for bit JAX's ring beam search, scores within 1e-5
    relative: the parents riding the ring reorder every stage's rows."""
    _, params = _setup(n_stages)
    prompt = _prompt(batch, p)
    gen_kw = dict(max_new_tokens=max_new, num_beams=k)
    want, want_sc = _jax_ring(n_stages, params, gen_kw, prompt)
    res = world.run(cases.ring_generate, _ring_params(params), CFG,
                    SHAPES[n_stages], prompt, gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_allclose(r["scores"], want_sc, rtol=TOL_SCORES,
                                   atol=0)


def test_ring_eos_lengths_match_pipe_tpu(world):
    """EOS through the ring: the pad tail and the lengths as JAX's, at
    tests/test_serve.py's EOS case (the 4th free-running token of row 0 as
    the stop token)."""
    _, params = _setup(2)
    prompt = np.array(jax.random.randint(jax.random.key(2), (2, 6), 1,
                                         CFG["vocab"], jnp.int32))
    free, _ = _jax_ring(2, params, dict(max_new_tokens=6, temperature=0.0),
                        prompt)
    gen_kw = dict(max_new_tokens=6, temperature=0.0,
                  eos_token_id=int(free[0, 3]))
    want, want_len = _jax_ring(2, params, gen_kw, prompt)
    assert want_len[0] == 4 and (want[0, 4:] == 0).all()
    res = world.run(cases.ring_generate, _ring_params(params), CFG,
                    SHAPES[2], prompt, gen_kw)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_array_equal(r["lengths"], want_len)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_ring_int8_matches_pipe_tpu(world, n_stages):
    """``pipe_tpu``'s int8 ``QuantLeaf`` stage params, carried to each
    rank's ``QuantLinear``s: greedy tokens as JAX's ring decoder's."""
    _, params = _setup(n_stages)
    prompt = _prompt(4, 6, seed=3)
    gen_kw = dict(max_new_tokens=5, temperature=0.0)
    want, _ = _jax_ring(n_stages, params, gen_kw, prompt, int8=True)
    res = world.run(cases.ring_generate, _ring_params(params, int8=True),
                    CFG, SHAPES[n_stages], prompt, gen_kw, 0, True)
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)


def test_ring_batch_must_divide_into_groups(world):
    _, params = _setup(2)
    res = world.run(cases.ring_refusal, _ring_params(params), CFG, (2, 2),
                    np.zeros((3, 4), np.int64))
    assert res == ["batch 3 must divide into 2 ring groups"] * 4


def test_ring_sampling_is_the_generators_stream(world):
    """Sampled: stage n-1 draws each step's ``[batch, vocab]`` uniforms
    from its ``torch.Generator`` and each group takes its rows, so a seed
    gives the port's one-device ``Generator`` stream (tokens as that
    stream's, seed for seed); another seed gives others. ``pipe_tpu``'s
    key chain is not reproduced (C.6)."""
    _, params = _setup(2)
    prompt = np.zeros((4, 6), np.int64)
    gen_kw = dict(max_new_tokens=8, temperature=0.9, top_k=12)
    gen = Generator(_port_generator(2, params), GenerationConfig(**gen_kw))
    want3 = gen.generate(prompt, seed=3).numpy()
    want4 = gen.generate(prompt, seed=4).numpy()
    assert (want3 != want4).any()
    for seed, want in ((3, want3), (4, want4)):
        res = world.run(cases.ring_generate, _ring_params(params), CFG,
                        SHAPES[2], prompt, gen_kw, seed)
        for r in res:
            np.testing.assert_array_equal(r["tokens"], want)


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_trainer_generate_over_a_mesh_matches_pipe_tpu(world, schedule):
    """``Trainer.generate`` over a 2 x 2 mesh gathers the model over each
    rank's stage group and generates on every rank: the tokens of JAX's
    ``Trainer(n_stages=2, n_data=2)`` from the same params, in its
    stage-stacked or interleaved layout."""
    tiny = dict(CFG, n_layers=4)
    jcfg = dataclasses.replace(jlm.LMConfig(**tiny), attn_impl="xla")
    jtr = jloop.Trainer(jcfg, jloop.TrainerConfig(
        batch_size=4, bptt=CFG["seq_len"], chunks=4, n_stages=2, n_data=2,
        schedule=schedule))
    jstate = jtr.init_state()
    prompt = _prompt(2, 6, seed=4)
    want = np.asarray(jtr.generate(jstate, jnp.asarray(prompt),
                                   max_new_tokens=6))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    res = world.run(cases.trainer_generate, params, tiny, schedule, prompt,
                    6)
    for r in res:
        np.testing.assert_array_equal(r, want)
