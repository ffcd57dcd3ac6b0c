"""pipe_tpu_torch's streaming cross-entropy (ops/losses.py) against
pipe_tpu's ``streaming_xent`` and the dense ``per_row_ce``: values and the
gradients of h, w and b within 1e-5 (a block that does not divide the vocab
included), bf16 activations, and ``PipelinedLM.loss_post_fn`` with and
without ``loss_block`` against JAX's on converted weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.ops.losses import streaming_xent as jxent
from pipe_tpu_torch import convert
from pipe_tpu_torch.core.partition import StageCtx
from pipe_tpu_torch.models import common as tcommon
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops.losses import streaming_xent

TOL = 1e-5


def _inputs(seed, rows=3, s=7, d=16, V=101):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, (rows, s))
    g = rng.standard_normal((rows, s)).astype(np.float32)
    return h, w, b, tgt, g


def _torch_value_and_grads(fn, h, w, b, g):
    ts = [torch.tensor(a, requires_grad=True) for a in (h, w, b)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("block", [32, 101, 128, 7])
def test_streaming_xent_matches_pipe_tpu_and_dense(block):
    h, w, b, tgt, g = _inputs(block)
    tt = torch.from_numpy(tgt)
    got, got_g = _torch_value_and_grads(
        lambda a, c, e: streaming_xent(a, c, e, tt, block), h, w, b, g)

    want, vjp = jax.vjp(lambda a, c, e: jxent(a, c, e, jnp.asarray(tgt),
                                              block),
                        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    want_g = vjp(jnp.asarray(g))
    dense, dense_g = _torch_value_and_grads(
        lambda a, c, e: tcommon.per_row_ce(
            (a @ c + e).reshape(-1, c.shape[1]),
            tt.reshape(-1)).reshape(tt.shape), h, w, b, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)
    for a, c, e in zip(got_g, want_g, dense_g):
        np.testing.assert_allclose(a, np.asarray(c), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(a, e, rtol=TOL, atol=TOL)


def test_streaming_xent_bf16_activations_accumulate_in_float32():
    h, w, b, tgt, _ = _inputs(5, rows=2, s=5, d=8, V=37)
    h16 = torch.from_numpy(h).bfloat16()
    got = streaming_xent(h16, torch.from_numpy(w), torch.from_numpy(b),
                         torch.from_numpy(tgt), 16)
    assert got.dtype == torch.float32
    want = jxent(jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(w),
                 jnp.asarray(b), jnp.asarray(tgt), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    hq = h16.float().requires_grad_(True)
    h16 = h16.requires_grad_(True)
    streaming_xent(h16, torch.from_numpy(w), torch.from_numpy(b),
                   torch.from_numpy(tgt), 16).sum().backward()
    assert h16.grad.dtype == torch.bfloat16
    # both packages round the weight tile to h's dtype before the product
    w16 = torch.from_numpy(w).bfloat16().float()
    dense = tcommon.per_row_ce(
        (hq @ w16 + torch.from_numpy(b)).reshape(-1, 37),
        torch.from_numpy(tgt).reshape(-1)).reshape(tgt.shape)
    np.testing.assert_allclose(got.numpy(), dense.detach().numpy(),
                               rtol=TOL, atol=TOL)


def test_streaming_xent_refuses_a_nonpositive_block():
    h, w, b, tgt, _ = _inputs(0)
    with pytest.raises(ValueError, match="block"):
        streaming_xent(*(torch.from_numpy(a) for a in (h, w, b, tgt)), 0)


@pytest.mark.parametrize("loss_block", [None, 32, 101])
def test_loss_post_fn_matches_pipe_tpu(loss_block):
    """The tiny LM's in-pipeline loss, dense and streamed, against JAX's
    ``loss_post_fn`` on the same weights: per-row values and the decoder's
    and h's gradients."""
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), loss_block=loss_block)
    jm = jlm.PipelinedLM(jcfg, 2)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(2)))
    model = tlm.PipelinedLM(
        dataclasses.replace(tlm.LMConfig().tiny(), loss_block=loss_block),
        2, device="cpu")
    convert.load_pipelined_lm(model, params)
    rng = np.random.default_rng(7)
    h = rng.standard_normal((3, jcfg.seq_len, jcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, jcfg.vocab, (3, jcfg.seq_len))

    def jloss(post, hh):
        return jm.loss_post_fn(post, hh, {"targets": jnp.asarray(tgt)},
                               None)

    want, vjp = jax.vjp(jloss, params[2], jnp.asarray(h))
    gpost, gh = vjp(jnp.ones_like(want))
    ht = torch.tensor(h, requires_grad=True)
    got = model.loss_post_fn(ht, {"targets": torch.from_numpy(tgt)},
                             StageCtx())
    assert got.shape == (3,)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(model.decoder.proj.weight.grad.numpy(),
                               np.asarray(gpost["decoder"]["w"]).T,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(model.decoder.proj.bias.grad.numpy(),
                               np.asarray(gpost["decoder"]["b"]), rtol=TOL,
                               atol=TOL)
