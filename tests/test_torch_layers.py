"""pipe_tpu_torch's layers against pipe_tpu's, from converted weights.

Each layer is initialised by pipe_tpu (a JAX key), its params are carried
across with ``pipe_tpu_torch.convert``, and the same numpy input goes through
both. fp32, 1e-5 abs: the frameworks sum in different orders. Attention with
``impl="flash"`` runs the Pallas kernel in interpret mode on the JAX side and
the kernel's plain version on the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.ops import layers as jl
from pipe_tpu_torch import convert
from pipe_tpu_torch.ops import flash_attention as tfa
from pipe_tpu_torch.ops import layers as tl

TOL = 1e-5
B, S, D, H, FF = 3, 16, 16, 2, 32


def _x(shape=(B, S, D), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(jlayer, tlayer, x, seed=0):
    params = jlayer.init(jax.random.key(seed), jnp.asarray(x))
    convert.load_params(tlayer, _np(params))
    want = np.asarray(jlayer.apply(params, jnp.asarray(x), ctx=JCtx()))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    return got


def test_linear():
    _run_both(jl.Linear(24), tl.Linear(D, 24, device="cpu"), _x())


def test_linear_without_bias():
    _run_both(jl.Linear(8, use_bias=False),
              tl.Linear(D, 8, use_bias=False, device="cpu"), _x())


def test_decoder():
    _run_both(jl.Decoder(50), tl.Decoder(D, 50, device="cpu"), _x())


@pytest.mark.parametrize("scale", [True, False])
def test_embedding(scale):
    tokens = np.random.default_rng(1).integers(0, 40, (B, S)).astype(np.int32)
    jlayer = jl.Embedding(40, D, scale=scale)
    params = jlayer.init(jax.random.key(0), jnp.asarray(tokens))
    tlayer = tl.Embedding(40, D, scale=scale, device="cpu")
    convert.load_params(tlayer, _np(params))
    want = np.asarray(jlayer.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_layernorm():
    # non-trivial gain/bias: perturb the converted params on both sides
    jlayer = jl.LayerNorm()
    x = _x() * 3.0 + 1.0
    params = {"g": jnp.asarray(_x((D,), 2)), "b": jnp.asarray(_x((D,), 3))}
    tlayer = tl.LayerNorm(D, device="cpu")
    convert.load_params(tlayer, _np(params))
    want = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_positional_encoding_table_and_apply():
    jlayer = jl.PositionalEncoding(D, max_len=64)
    tlayer = tl.PositionalEncoding(D, max_len=64, device="cpu")
    np.testing.assert_array_equal(tlayer.pe.numpy(), np.asarray(jlayer.pe))
    _run_both(jlayer, tlayer, _x())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_multi_head_attention(impl, causal):
    _run_both(jl.MultiHeadAttention(D, H, causal=causal, impl=impl),
              tl.MultiHeadAttention(D, H, causal=causal, impl=impl,
                                    device="cpu"), _x())


def test_mha_flash_and_xla_agree_within_the_port():
    x = torch.from_numpy(_x())
    a = tl.MultiHeadAttention(D, H, impl="flash", device="cpu")
    b = tl.MultiHeadAttention(D, H, impl="xla", device="cpu")
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(a(x).numpy(), b(x).numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_transformer_encoder_layer(activation, impl):
    _run_both(jl.TransformerEncoderLayer(D, H, FF, attn_impl=impl,
                                         activation=activation),
              tl.TransformerEncoderLayer(D, H, FF, attn_impl=impl,
                                         activation=activation,
                                         device="cpu"), _x())


def test_preln_block():
    _run_both(jl.PreLNBlock(D, H, FF, attn_impl="flash"),
              tl.PreLNBlock(D, H, FF, attn_impl="flash", device="cpu"), _x())


def test_gelu_variants_stay_distinct():
    x = torch.linspace(-3, 3, 101)
    exact = tl._ACTIVATIONS["gelu"](x)
    tanh = tl._ACTIVATIONS["gelu_tanh"](x)
    assert (exact - tanh).abs().max().item() > 1e-5
    for name in ("relu", "gelu", "gelu_tanh"):
        np.testing.assert_allclose(
            tl._ACTIVATIONS[name](x).numpy(),
            np.asarray(jl._ACTIVATIONS[name](jnp.asarray(x.numpy()))),
            rtol=0, atol=1e-6)


def test_dot_product_attention_matches():
    rng = np.random.default_rng(5)
    q, k, v = [rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
               for _ in range(3)]
    for causal in (True, False):
        want = jl.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
        got = tl.dot_product_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_auto_impl_selection():
    # auto picks the kernel only on a CUDA device, whenever it takes s;
    # the v5e crossover length of pipe_tpu does not carry over.
    assert not tl.flash_auto_ok(128, torch.device("cpu"))
    assert tl.flash_auto_ok(128, torch.device("cuda"))
    assert tl.flash_auto_ok(16, torch.device("cuda"))
    assert not tl.flash_auto_ok(100, torch.device("cuda"))
    assert not hasattr(tl, "FLASH_AUTO_MIN_SEQ")


def test_dropout_is_seeded_and_off_in_eval():
    from pipe_tpu_torch.core.partition import StageCtx
    drop = tl.Dropout(0.5)
    x = torch.ones(64, 64)
    assert drop(x, ctx=StageCtx(seed=3)) is x            # eval
    a = drop(x, ctx=StageCtx(seed=3, train=True))
    b = drop(x, ctx=StageCtx(seed=3, train=True))
    c = drop(x, ctx=StageCtx(seed=4, train=True))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (a == 0).float().mean().item() < 0.6


def test_sequential_slicing_shares_layers():
    layers = [tl.Linear(4, 4, device="cpu") for _ in range(3)]
    seq = tl.Sequential(layers)
    part = seq[1:]
    assert isinstance(part, tl.Sequential) and len(part) == 2
    assert part[0] is layers[1]
    x = torch.randn(2, 4)
    with torch.no_grad():
        torch.testing.assert_close(seq(x), part(layers[0](x)))


def test_convert_rejects_mismatched_shapes():
    jlayer = jl.Linear(8)
    params = _np(jlayer.init(jax.random.key(0), jnp.zeros((2, 6))))
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.load_params(tl.Linear(5, 8, device="cpu"), params)


@pytest.mark.parametrize("dtype,nhead,takes_kernel", [
    (torch.float16, 2, False), (torch.float64, 2, False),
    (torch.float32, 1, False),            # head dim 160
    (torch.float32, 2, True), (torch.bfloat16, 2, True)])
def test_auto_route_falls_back_where_the_kernel_cannot_go(
        monkeypatch, dtype, nhead, takes_kernel):
    """``impl="auto"`` routed as on the card: float16, float64 and head dim
    160 take plain attention without raising; float32 and bfloat16 at head
    dim 80 take the kernel. The kernel's wrapper is held to what the card's
    accepts (it raises there for anything else)."""
    route = tl._flash_route
    monkeypatch.setattr(
        tl, "_flash_route",
        lambda impl, s, device, drop, *rest: route(
            impl, s, torch.device("cuda"), drop, *rest))
    calls = []
    flash = tl.flash_attention

    def card_flash(q, k, v, **kw):
        b, s, h, d = q.shape
        tfa._check_cuda([x.transpose(1, 2).reshape(b * h, s, d).contiguous()
                         for x in (q, k, v)])
        calls.append(q.dtype)
        return flash(q, k, v, **kw)

    monkeypatch.setattr(tl, "flash_attention", card_flash)
    mha = tl.MultiHeadAttention(160, nhead, impl="auto", device="cpu").to(dtype)
    x = torch.randn(2, 16, 160, dtype=dtype)
    with torch.no_grad():
        y = mha(x)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert calls == ([dtype] if takes_kernel else [])
    assert tl.flash_auto_ok(16, torch.device("cuda"), dtype,
                            160 // nhead) == takes_kernel
