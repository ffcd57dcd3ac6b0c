"""pipe_tpu_torch's int8 weight-only quantization against pipe_tpu's
(inference/quant.py): codes and scales bitwise (transposed: the port's
``Linear.weight`` is ``[out, in]``), the KV-row quantizer, the structure of
a quantized model, and int8 generation (greedy tokens bitwise, beam scores,
teacher-forced logits) from the same converted weights on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference import Generator as JGenerator
from pipe_tpu.inference import quant as jquant
from pipe_tpu.inference.generate import head_logits as jhead_logits
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import generate as tgen
from pipe_tpu_torch.inference import quant as tquant
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops.layers import Linear

from test_torch_generate import (CFG, TIE_MARGIN, TOL_LOGITS, TOL_SCORES,
                                 _assert_no_near_tie, _jax_full_logits,
                                 _prompt)

_WEIGHTS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
            ("ff1",), ("ff2",)]


@pytest.fixture(scope="module")
def quantized():
    """JAX model, float params, JAX-quantized stage params, and the port's
    float model and its ``quantize_params`` copy from the same weights."""
    jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(1)))
    # pipe_tpu quantizes jax arrays only, not numpy leaves
    qsp = jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray,
                                                        params[0]))
    tmodel = tlm.PipelinedLM(tlm.LMConfig(**CFG), 2, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, qsp, tmodel, tquant.quantize_params(tmodel)


def _module(block, path):
    for name in path:
        block = getattr(block, name)
    return block


def test_codes_and_scales_equal_pipe_tpu(quantized):
    _, _, qsp, _, qmodel = quantized
    jblocks = [b for stage in qsp for b in stage]
    for qblock, jblock in zip(qmodel.blocks, jblocks):
        for path in _WEIGHTS:
            mod = _module(qblock, path)
            leaf = (jblock[path[0]]["w"] if len(path) == 1
                    else jblock["attn"][path[1]])
            assert isinstance(mod, tquant.QuantLinear)
            assert mod.q.dtype == torch.int8
            np.testing.assert_array_equal(mod.q.numpy(),
                                          np.asarray(leaf.q).T)
            np.testing.assert_array_equal(mod.scale.numpy(),
                                          np.asarray(leaf.scale).T)


def test_quantize_params_keeps_structure_and_the_original(quantized):
    _, _, _, tmodel, qmodel = quantized
    for path in _WEIGHTS:
        assert isinstance(_module(tmodel.blocks[0], path), Linear)
    quantized_names = {n for n, m in qmodel.named_modules()
                       if isinstance(m, tquant.QuantLinear)}
    assert len(quantized_names) == 6 * CFG["n_layers"]
    assert all(n.startswith("blocks.") for n in quantized_names)
    assert isinstance(qmodel.decoder.proj, Linear)
    state = qmodel.state_dict()
    assert state["blocks.0.attn.wq.q"].dtype == torch.int8
    assert state["blocks.0.attn.wq.scale"].shape == (CFG["d_model"], 1)
    for name in ("blocks.0.attn.wq.bias", "blocks.0.ln1.weight",
                 "embed.weight", "decoder.proj.weight"):
        assert state[name].dtype == torch.float32
    deq = qmodel.blocks[0].ff1.leaf.dequant(torch.float32)
    assert deq.shape == tmodel.blocks[0].ff1.weight.shape


def test_quant_roundtrip_precision():
    w = torch.tensor(np.asarray(
        jax.random.normal(jax.random.key(0), (48, 64)) * 0.3))
    leaf = tquant.quantize_leaf(w)
    err = (leaf.dequant(torch.float32) - w).abs().amax(dim=1)
    rowmax = w.abs().amax(dim=1)
    assert (err <= rowmax / 127.0 * 1.01).all()      # per-channel bound
    zero = tquant.quantize_leaf(torch.zeros(3, 4))
    assert (zero.scale == 1.0).all() and (zero.q == 0).all()


@pytest.mark.parametrize("shape", [(2, 5, 4, 8), (3, 16)])
def test_quantize_kv_rows_equals_pipe_tpu(shape):
    rows = np.asarray(jax.random.normal(jax.random.key(2), shape)) * 3.0
    rows[0, 0] = 0.0
    jq, js = jquant.quantize_kv_rows(jnp.asarray(rows))
    tq, ts = tquant.quantize_kv_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequant_tree_maps_leaves_only():
    leaf = tquant.quantize_leaf(torch.randn(4, 3))
    bias = torch.randn(4)
    tree = {"w": leaf, "b": bias, "more": [leaf, (bias,)]}
    out = tquant.dequant_tree(tree, torch.float32)
    assert torch.equal(out["w"], leaf.dequant(torch.float32))
    assert out["b"] is bias and out["more"][1][0] is bias
    assert out["more"][0].dtype == torch.float32
    assert tquant.dequant_tree(leaf).dtype == torch.bfloat16


def test_int8_teacher_forced_logits_match_pipe_tpu(quantized):
    """Prefill logits of the int8 models against JAX's int8 path within
    TOL_LOGITS, and within JAX's 0.08 relative bound of the float model."""
    jmodel, params, qsp, tmodel, qmodel = quantized
    prompt = _prompt(1, (4, 8))
    jgen = JGenerator(jmodel, JGenCfg(max_new_tokens=1))
    blocks = jgen._blocks(qsp)
    caches = [jmodel.block.attn.make_cache(4, 8) for _ in blocks]
    h = jmodel.embed_at(params[1], jnp.asarray(prompt), 0)
    for l, bp in enumerate(blocks):
        h, caches[l] = jmodel.block.decode(jgen._dq(bp), h, caches[l], 0)
    want = np.asarray(jgen._head(params[2], h))

    def forced(model):
        with torch.no_grad():
            g = model.embed_at(torch.tensor(prompt).long(), 0)
            for blk in model.blocks:
                g, _ = blk.decode(g, blk.attn.make_cache(4, 8), 0)
            return tgen.head_logits(model, g).numpy()

    lq, lf = forced(qmodel), forced(tmodel)
    np.testing.assert_allclose(lq, want, rtol=TOL_LOGITS, atol=TOL_LOGITS)
    rel = np.abs(lf - lq).max() / (np.abs(lf).max() + 1e-9)
    assert 0 < rel < 0.08, f"relative logit error {rel}"


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_greedy_tokens_equal_pipe_tpu(quantized, seed):
    jmodel, params, qsp, _, qmodel = quantized
    prompt = _prompt(seed, (3, 6))
    cfg = dict(max_new_tokens=8, temperature=0.0)
    want = np.asarray(JGenerator(jmodel, JGenCfg(**cfg)).generate(
        (qsp, params[1], params[2]), jnp.asarray(prompt)))
    deq = (jquant.dequant_tree(qsp, jnp.float32), params[1], params[2])
    _assert_no_near_tie(lambda t: _jax_full_logits(jmodel, deq, t), prompt,
                        want)
    got = Generator(qmodel, GenerationConfig(**cfg)).generate(prompt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_beam_matches_pipe_tpu(quantized):
    jmodel, params, qsp, _, qmodel = quantized
    prompt = _prompt(5, (2, 4))
    cfg = dict(max_new_tokens=5, num_beams=3)
    want, want_s = JGenerator(jmodel, JGenCfg(**cfg)).generate_with_scores(
        (qsp, params[1], params[2]), jnp.asarray(prompt))
    got, got_s = Generator(qmodel, GenerationConfig(
        **cfg)).generate_with_scores(prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=TOL_SCORES, atol=TOL_SCORES)


def test_quantized_head_dequantizes_to_float32(quantized):
    """A quantized decoder (not what ``quantize_params`` does, but what
    ``head_logits`` takes) against JAX's ``head_logits`` on quantized post
    params."""
    jmodel, params, _, tmodel, _ = quantized
    post_q = {"decoder": jquant.quantize_params(jax.tree_util.tree_map(
        jnp.asarray, params[2]["decoder"]))}
    h = np.asarray(jax.random.normal(jax.random.key(6), (2, 3, 32)))
    want = np.asarray(jhead_logits(jmodel, post_q, jnp.asarray(h)))
    qhead = tlm.PipelinedLM(tlm.LMConfig(**CFG), 2, device="cpu")
    qhead.load_state_dict(tmodel.state_dict())
    qhead.decoder.proj = tquant.QuantLinear(qhead.decoder.proj)
    with torch.no_grad():
        got = tgen.head_logits(qhead, torch.tensor(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TIE_MARGIN / 10,
                               atol=TIE_MARGIN / 10)
