"""The numerics of the forward and dK/dV kernels' tensor-core products, on the
CPU: fp32-accurate products from three TF32 passes (3xTF32).

The kernels round an fp32 value x to TF32 as ``cvt.rna.tf32.f32`` does (round
to nearest, ties away from zero, to 10 mantissa bits), written as two integer
operations on its bits (``csrc/tc_tf32.cuh``, ``tf32``); split it as
x = big + small with big = tf32(x) and small = tf32(x - big); and take a
product a b as small_a big_b + big_a small_b + big_a big_b. A TF32 product is
exact in fp32, so the passes are emulated here by fp32 matrix products of the
rounded operands. At the tutorial LM's training shape (b*h 256, s 128, d 64,
causal) the four products of the two kernels (Q K^T, P V, dS^T Q, P^T dO) hold
the kernels' gate against their plain versions, 1e-4 x max(1, max|ref|), and
come within a small multiple of fp32's own error from a float64 product; one
TF32 pass does not.
"""

import functools

import numpy as np
import pytest
import torch

BH, S, D = 256, 128, 64
SCALE = 1.0 / D ** 0.5
TOL = 1e-4            # the kernels' fp32 gate, x max(1, max|ref|)
FP32_MULTIPLE = 4.0   # three passes stay within this multiple of fp32's error


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite float32 values, as the kernels compute
    it: add half of the 13 dropped bits' range to the bits, then clear them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def three_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def one_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


@functools.lru_cache(maxsize=None)
def _products():
    """The operands of the four products at the training shape, float32, from
    seeded numpy inputs; the probabilities and dS computed in float64 and
    rounded to float32, as the kernels hold them in registers."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, S, D),
                                                        dtype=np.float32))
                   for _ in range(4))
    qs = q * SCALE
    scores = qs.double() @ k.double().transpose(1, 2)
    causal = torch.triu(torch.ones(S, S, dtype=torch.bool), 1)
    p = torch.softmax(scores.masked_fill(causal, float("-inf")), -1)
    dp = do.double() @ v.double().transpose(1, 2)
    delta = (do.double() * (p @ v.double())).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).float()
    p = p.float()
    return {"qk": (qs, k.transpose(1, 2)), "pv": (p, v),
            "dsq": (ds.transpose(1, 2), qs), "pdo": (p.transpose(1, 2), do)}


def _errors(name: str):
    a, b = (x.contiguous() for x in _products()[name])
    ref = a.double() @ b.double()
    gate = TOL * max(1.0, ref.abs().max().item())

    def err(got):
        return (got.double() - ref).abs().max().item()

    return gate, err(a @ b), err(three_pass(a, b)), err(one_pass(a, b))


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10           # TF32's spacing above 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + ulp / 2 + 2 ** -23, 3.0, 0.0, -0.0, 2.0 ** -130],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0,
                         -0.0, 2.0 ** -130], dtype=torch.float32)
    assert torch.equal(tf32(x).view(torch.int32), want.view(torch.int32))


def test_split_keeps_22_bits_and_bf16_is_exact():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        100_000).astype(np.float32)) * 1e3
    big, small = split(x)
    rel = ((x.double() - big.double() - small.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22
    bf = x.to(torch.bfloat16).float()
    assert torch.equal(tf32(bf), bf)
    assert torch.equal(split(bf)[1], torch.zeros_like(bf))


@pytest.mark.parametrize("name", ["qk", "pv", "dsq", "pdo"])
def test_three_passes_hold_the_fp32_gate(name):
    gate, e_fp32, e_three, _ = _errors(name)
    assert e_three <= gate
    assert e_three <= FP32_MULTIPLE * e_fp32


@pytest.mark.parametrize("name", ["qk", "pv", "dsq", "pdo"])
def test_one_pass_misses_the_gate(name):
    gate, e_fp32, _, e_one = _errors(name)
    assert e_one > gate
    assert e_one > 100 * e_fp32
