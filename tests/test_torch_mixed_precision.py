"""A bfloat16 ``compute_dtype`` against pipe_tpu's: float32 master weights,
bfloat16 compute, float32 logits and loss.

``pipe_tpu`` keeps every parameter in float32 and casts at use: the embed
stage casts its output to the compute dtype, each block casts its params to
it, the head reads the float32 decoder. The port does the same: its
weights stay float32 whatever ``compute_dtype`` is, its layers cast them to
the activations' dtype at use, and the trainer's Adam moments are float32.
The same numpy weights go through both packages at the tiny config of
tests/test_torch_generate.py (the trainer at tests/test_torch_train.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.inference import Generator as JGenerator
from pipe_tpu.models import common as jcommon
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import Pipe, convert
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.inference import GenerationConfig, Generator
from pipe_tpu_torch.models import common as tcommon
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.train import loop as tloop

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
# bfloat16 keeps 8 bits of mantissa (rounding 3.9e-3 relative), and the two
# frameworks round products, sums and norms at different points: their
# logits differ by up to 0.034 here (of a largest 2.1) and their losses by
# at most 2.6e-4 relative over three training steps; held at 2e-3.
TOL_LOSS_BF16 = 2e-3
# Greedy tokens are compared up to a row's first step whose JAX top-2 margin
# is below three times that logit difference.
TIE_MARGIN_BF16 = 0.1


@pytest.fixture(scope="module")
def models():
    """(JAX PipelinedLM at bf16 compute, its numpy params, the port's
    PipelinedLM at bf16 compute holding the same weights)."""
    jmodel = jlm.PipelinedLM(
        jlm.LMConfig(**CFG, compute_dtype=jnp.bfloat16), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    tmodel = tlm.PipelinedLM(
        tlm.LMConfig(**CFG, compute_dtype=torch.bfloat16), 2, device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, tmodel


def _tokens(seed, shape):
    return np.array(jax.random.randint(jax.random.key(seed), shape, 0,
                                       CFG["vocab"], jnp.int32))


def _jax_logits(jmodel, params, tokens):
    sp, pre, post = params
    ctx = JCtx(train=False)
    h = jmodel.pre_fn(pre, jnp.asarray(tokens), ctx)
    for blocks in sp:
        h = jmodel.stage_fn(blocks, h, ctx)
    return np.asarray(jmodel.post_fn(post, h, ctx))


def test_weights_stay_float32_and_compute_is_bfloat16(models):
    jmodel, params, tmodel = models
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(params)} == \
        {"float32"}
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    seq = tlm.build_sequential(
        tlm.LMConfig(**CFG, compute_dtype=torch.bfloat16), device="cpu")
    assert {p.dtype for p in seq.parameters()} == {torch.float32}
    tokens = torch.from_numpy(_tokens(1, (2, 8))).long()
    with torch.no_grad():
        h = tmodel.pre_fn(tokens)
        assert h.dtype == torch.bfloat16
        h = tmodel.stage_fn(0, h)
        assert h.dtype == torch.bfloat16
        assert tmodel.post_fn(h).dtype == torch.float32
        assert seq(tokens).dtype == torch.float32
        assert seq[1](seq[0](tokens)).dtype == torch.bfloat16


def test_pipe_loss_matches_pipe_tpu_bf16(models):
    """The port's ``Pipe`` over its bf16 ``Sequential`` (the trainer's
    stand-in for ``PipelinedLM``) against JAX's ``PipelinedLM`` stage
    functions at bf16 compute: per-row cross-entropy."""
    jmodel, params, _ = models
    tokens = _tokens(1, (4, 32))
    targets = _tokens(2, (4, 32))
    want = np.asarray(jcommon.per_row_ce(
        jnp.asarray(_jax_logits(jmodel, params, tokens)),
        jnp.asarray(targets)))
    seq = tlm.build_sequential(
        tlm.LMConfig(**CFG, compute_dtype=torch.bfloat16), device="cpu")
    pipe = Pipe(seq, chunks=2, balance=tlm.pipelined_lm_balance(4, 2),
                device="cpu")
    convert.load_pipelined_lm_params(pipe, params)
    assert {p.dtype for p in pipe.parameters()} == {torch.float32}
    with torch.no_grad():
        got = tcommon.per_row_ce(pipe(torch.from_numpy(tokens).long()),
                                 torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS_BF16, atol=0)


def test_trainer_two_steps_match_pipe_tpu_bf16():
    """Two training steps from the JAX Trainer's weights at bf16 compute:
    the losses agree within TOL_LOSS_BF16, and every port parameter and
    Adam moment is float32."""
    lines = lm_text.synthetic_corpus(30_000, 99, seed=3)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, lines))
    source = lm_text.batchify(lm_text.data_process(lines, vocab), 8)
    kw = dict(batch_size=8, eval_batch_size=8, bptt=16, chunks=2,
              n_stages=2, n_data=1, lr=1e-2)
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=2,
                               attn_impl="xla", compute_dtype=jnp.bfloat16)
    jtrainer = jloop.Trainer(jcfg, jloop.TrainerConfig(**kw))
    jstate = jtrainer.init_state()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tcfg = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2,
                               attn_impl="xla", compute_dtype=torch.bfloat16)
    trainer = tloop.Trainer(tcfg, tloop.TrainerConfig(**kw), device="cpu")
    state = trainer.init_state()
    convert.load_pipelined_lm_params(trainer.pipe, params)
    want, got = [], []
    for b in range(2):
        jstate, info = jtrainer.train_epoch(source, state=jstate,
                                            max_steps=b + 1, start_step=b,
                                            log_every=0)
        want.append(info["loss"])
        state, info = trainer.train_epoch(source, state=state,
                                          max_steps=b + 1, start_step=b,
                                          log_every=0)
        got.append(info["loss"])
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS_BF16, atol=0)
    assert {p.dtype for p in trainer.pipe.parameters()} == {torch.float32}
    moments = [v for s in trainer.optimizer.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(list(trainer.pipe.parameters()))
    assert {m.dtype for m in moments} == {torch.float32}


def test_greedy_tokens_match_pipe_tpu_bf16(models):
    """Greedy tokens of the bf16 generators, each row compared up to its
    first near tie in JAX's logits; at least a third of the steps are
    compared."""
    jmodel, params, tmodel = models
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    prompt = _tokens(2, (3, 6))
    n = 10
    want = np.asarray(JGenerator(
        jmodel, JGenCfg(max_new_tokens=n, temperature=0.0)).generate(
        params, jnp.asarray(prompt)))
    got = Generator(tmodel, GenerationConfig(
        max_new_tokens=n, temperature=0.0)).generate(prompt).numpy()
    logits = _jax_logits(jmodel, params,
                         np.concatenate([prompt, want], axis=1))
    top2 = np.sort(logits[:, prompt.shape[1] - 1:-1], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > TIE_MARGIN_BF16
    compared = 0
    for r in range(prompt.shape[0]):
        stop = n if clear[r].all() else int(np.argmin(clear[r]))
        np.testing.assert_array_equal(got[r, :stop], want[r, :stop])
        compared += stop
    assert compared >= n, compared
