"""pipe_tpu_torch's flash-attention backward and dropout against pipe_tpu's.

The port's plain backward (``flash_attention_bwd_ref``) and its autograd
``Function`` are held against ``jax.grad`` through the Pallas ``custom_vjp``
in interpret mode, as tests/test_pallas_attention.py runs it; the dropout
algebra against the Pallas kernels with their mask replaced by a
deterministic stub, fed to both sides as one ``[b*h, s, s]`` keep tensor;
the plain backward against torch autograd of the explicit formula; and the
Philox keep mask against Random123's known-answer vectors. Inputs are numpy
arrays from a seed. fp32 tolerance 1e-5 abs (the sums run in different
orders) unless a test states another.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipe_tpu.ops import pallas_attention as jfa
from pipe_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5


def _arrays(bh, s, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(n)]


def _jax_grads(q, k, v, do, causal, scale, block, rate=0.0):
    """O and (dq, dk, dv) of the Pallas custom_vjp (interpret mode)."""
    attend = jfa._make(causal, scale, block, block, True, rate)
    seed = jnp.zeros((1,), jnp.int32)
    args = [jnp.asarray(a) for a in (q, k, v)]
    o, vjp = jax.vjp(lambda q3, k3, v3: attend(q3, k3, v3, seed), *args)
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _cases():
    for s in (8, 16, 64, 256):
        for d in (8, 64):
            for causal in (True, False):
                yield s, d, causal


@pytest.mark.parametrize("s,d,causal", list(_cases()))
def test_plain_backward_and_function_match_pallas_vjp(s, d, causal):
    q, k, v, do = _arrays(2, s, d, seed=s * 10 + d)
    scale = 1.0 / math.sqrt(d)
    o_j, grads_j = _jax_grads(q, k, v, do, causal, scale, min(128, s))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv, causal, scale)
    plain = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                        causal=causal, scale=scale)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o_f = tfa._FlashAttention.apply(*leaves, causal, scale, 0, 0.0)
    o_f.backward(tdo)
    np.testing.assert_allclose(o_f.detach().numpy(), o_j, rtol=0, atol=TOL)
    for got_plain, leaf, want in zip(plain, leaves, grads_j):
        np.testing.assert_allclose(got_plain.numpy(), want, rtol=0, atol=TOL)
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dropout_algebra_matches_pallas_with_a_stub_mask(monkeypatch, causal):
    """The Pallas kernels' mask replaced by a stub of (seed, bh, iq, ik),
    assembled into the one full keep tensor both sides use: O and the three
    gradients agree, which pins the pre-dropout normaliser and the masked
    dp / dV of the port's plain versions against the reference kernels."""
    rate, bh, s, d, block = 0.3, 2, 32, 8, 16

    def stub(seed, bh_i, iq, ik, shape, r):
        a = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        b = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        z = (a * 7 + b * 13 + bh_i * 31 + iq * 17 + ik * 11 + seed) % 10
        return jnp.where(z >= jnp.int32(r * 10), 1.0 / (1.0 - r),
                         0.0).astype(jnp.float32)

    monkeypatch.setattr(jfa, "_drop_mask", stub)
    jfa._make.cache_clear()
    try:
        keep = np.zeros((bh, s, s), np.float32)
        for b in range(bh):
            for iq in range(s // block):
                for ik in range(s // block):
                    keep[b, iq * block:(iq + 1) * block,
                         ik * block:(ik + 1) * block] = np.asarray(
                             stub(0, b, iq, ik, (block, block), rate))
        q, k, v, do = _arrays(bh, s, d, seed=5)
        scale = 1.0 / math.sqrt(d)
        o_j, grads_j = _jax_grads(q, k, v, do, causal, scale, block, rate)
    finally:
        jfa._make.cache_clear()

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tkeep = torch.from_numpy(keep)
    o, lse = tfa.flash_attention_ref(tq, tk, tv, causal, scale, tkeep)
    np.testing.assert_allclose(o.numpy(), o_j, rtol=0, atol=TOL)
    grads = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                        causal=causal, scale=scale,
                                        keep=tkeep)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)

    # The autograd Function takes the same mask through dropout_keep.
    monkeypatch.setattr(tfa, "dropout_keep", lambda *a, **k: tkeep)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tfa._FlashAttention.apply(*leaves, causal, scale, 1, rate).backward(tdo)
    for leaf, want in zip(leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_plain_backward_matches_torch_autograd(causal, rate):
    """Independent of JAX: the plain backward against torch autograd of
    ``(softmax(s) * keep) V``, in float64 on the explicit side."""
    bh, s, d = 3, 40, 16
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(bh, s, d, seed=11))
    scale = 0.25
    keep = tfa.dropout_keep(321, rate, bh, s) if rate else None
    o, lse = tfa.flash_attention_ref(q, k, v, causal, scale, keep)
    got = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      scale=scale, keep=keep)

    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    scores = leaves[0] @ leaves[1].transpose(1, 2) * scale
    if causal:
        scores = scores.masked_fill(
            torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    w = torch.softmax(scores, dim=-1)
    if keep is not None:
        w = w * keep.double()
    torch.autograd.backward(w @ leaves[2], do.double())
    for a, leaf in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=TOL)


# --- the Philox keep mask -------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    words = tfa.philox4x32(*(torch.tensor(c) for c in counter), *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_keep_rate_within_four_sigma(rate):
    keep = tfa.dropout_keep(2024, rate, 4, 64)
    assert keep.shape == (4, 64, 64) and keep.dtype == torch.float32
    assert set(torch.unique(keep).tolist()) == {0.0, np.float32(1 / (1 - rate))}
    kept = (keep > 0).double().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / keep.numel())
    assert abs(kept - (1 - rate)) <= 4 * sigma


def test_mask_does_not_depend_on_tiling():
    """Slicing the full mask equals generating the slice: the mask is a
    function of absolute positions, whatever tiles a kernel walks."""
    seed, rate = (1 << 45) + 17, 0.2
    full = tfa.dropout_keep(seed, rate, 5, 70)
    bh = torch.arange(2, 5)[:, None, None]
    q = torch.arange(13, 61)[None, :, None]
    k = torch.arange(3, 67)[None, None, :]
    bits = tfa.keep_bits(seed, bh, q, k)
    assert torch.equal(bits >= tfa._threshold(rate), full[2:5, 13:61, 3:67] > 0)


def test_mask_changes_with_the_seed():
    a, b = tfa.dropout_keep(1, 0.2, 2, 32), tfa.dropout_keep(2, 0.2, 2, 32)
    c = tfa.dropout_keep(1 + (1 << 32), 0.2, 2, 32)   # the key's high word
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, tfa.dropout_keep(1, 0.2, 2, 32))
