"""Numerical parity against torch itself (CPU): the strongest checkable
evidence for the tutorial-parity claim.

The reference model is ``nn.TransformerEncoderLayer`` stacked between an
embedding Encoder and a linear Decoder (``/root/reference/main.py:139-157``).
These tests load ONE set of weights into both torch's module and this
package's :class:`~pipe_tpu.ops.layers.TransformerEncoderLayer` and assert
the outputs match to float32 tolerance — layer math, LN placement/eps,
activation, causal masking, and the full Encoder->blocks->Decoder
composition all pinned against the actual reference substrate rather than
a reimplementation of it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx
from pipe_tpu.ops.layers import TransformerEncoderLayer

D_MODEL, NHEAD, D_FF, SEQ, BATCH = 16, 2, 32, 12, 3


def causal_mask(seq=SEQ):
    return torch.triu(torch.full((seq, seq), float("-inf")), diagonal=1)


def torch_sinusoid(seq, d):
    """The tutorial's PositionalEncoding table, built INDEPENDENTLY on the
    torch side (reference main.py's formula) so the composition test
    actually validates this package's table rather than injecting it."""
    import math
    position = torch.arange(seq).unsqueeze(1)
    div = torch.exp(torch.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = torch.zeros(seq, d)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def torch_layer(seed=0, activation="relu"):
    torch.manual_seed(seed)
    return torch.nn.TransformerEncoderLayer(
        d_model=D_MODEL, nhead=NHEAD, dim_feedforward=D_FF, dropout=0.0,
        activation=activation, batch_first=True)


def params_from_torch(tl) -> dict:
    """Map torch's TransformerEncoderLayer weights onto our param pytree.

    torch packs QKV as in_proj_weight [3d, d] (y = x @ W.T + b); ours are
    separate [d, d] right-multiplied (y = x @ W + b) — so each torch block
    transposes. torch Linear weight [out, in] -> ours [in, out].
    """
    sd = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
    d = D_MODEL
    wq, wk, wv = (sd["self_attn.in_proj_weight"][i * d:(i + 1) * d].T
                  for i in range(3))
    bq, bk, bv = (sd["self_attn.in_proj_bias"][i * d:(i + 1) * d]
                  for i in range(3))
    return jax.tree_util.tree_map(jnp.asarray, {
        "attn": {"wq": wq, "wk": wk, "wv": wv,
                 "wo": sd["self_attn.out_proj.weight"].T,
                 "bq": bq, "bk": bk, "bv": bv,
                 "bo": sd["self_attn.out_proj.bias"]},
        "ff1": {"w": sd["linear1.weight"].T, "b": sd["linear1.bias"]},
        "ff2": {"w": sd["linear2.weight"].T, "b": sd["linear2.bias"]},
        "ln1": {"g": sd["norm1.weight"], "b": sd["norm1.bias"]},
        "ln2": {"g": sd["norm2.weight"], "b": sd["norm2.bias"]},
    })


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("causal", [False, True])
def test_encoder_layer_matches_torch(causal, activation):
    # torch's activation="gelu" is the EXACT erf form — pinned against this
    # package's "gelu" (the BERT/ViT variant; GPT-2 uses "gelu_tanh")
    tl = torch_layer(activation=activation).eval()
    params = params_from_torch(tl)
    ours = TransformerEncoderLayer(D_MODEL, NHEAD, D_FF, dropout=0.0,
                                   causal=causal, activation=activation)

    x = np.random.default_rng(1).standard_normal(
        (BATCH, SEQ, D_MODEL)).astype(np.float32)
    with torch.no_grad():
        if causal:
            exp = tl(torch.from_numpy(x), src_mask=causal_mask())
        else:
            exp = tl(torch.from_numpy(x))
    got = ours.apply(params, jnp.asarray(x), ctx=StageCtx())
    np.testing.assert_allclose(np.asarray(got), exp.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_full_tutorial_composition_matches_torch():
    """Embedding*sqrt(d) -> posenc -> N layers (causal) -> decoder, both
    frameworks, one weight set (the main.py model shape at toy scale)."""
    import math

    from pipe_tpu.ops.layers import (Decoder, Embedding, PositionalEncoding)

    VOCAB, NLAYERS = 50, 2
    tls = [torch_layer(seed=i).eval() for i in range(NLAYERS)]
    layer_params = [params_from_torch(tl) for tl in tls]

    rng = np.random.default_rng(2)
    emb_w = rng.standard_normal((VOCAB, D_MODEL)).astype(np.float32)
    dec_w = rng.standard_normal((D_MODEL, VOCAB)).astype(np.float32) * 0.1
    dec_b = rng.standard_normal((VOCAB,)).astype(np.float32) * 0.1
    tokens = rng.integers(0, VOCAB, size=(BATCH, SEQ))

    # --- torch side (the reference composition, main.py:139-157; the
    # sinusoid table built independently — see torch_sinusoid) ---
    with torch.no_grad():
        h = torch.from_numpy(emb_w[tokens]) * math.sqrt(D_MODEL)
        h = h + torch_sinusoid(SEQ, D_MODEL)
        for tl in tls:
            h = tl(h, src_mask=causal_mask())
        exp = h @ torch.from_numpy(dec_w) + torch.from_numpy(dec_b)

    # --- pipe_tpu side (its OWN PositionalEncoding table) ---
    pe = PositionalEncoding(D_MODEL, 0.0)
    emb = Embedding(VOCAB, D_MODEL, scale=True)
    dec = Decoder(VOCAB)
    ours = TransformerEncoderLayer(D_MODEL, NHEAD, D_FF, dropout=0.0,
                                   causal=True)
    h = emb.apply({"table": jnp.asarray(emb_w)}, jnp.asarray(tokens))
    h = pe.apply({}, h, ctx=StageCtx())
    for p in layer_params:
        h = ours.apply(p, h, ctx=StageCtx())
    got = dec.apply({"w": jnp.asarray(dec_w), "b": jnp.asarray(dec_b)}, h)
    np.testing.assert_allclose(np.asarray(got), exp.numpy(),
                               rtol=3e-5, atol=3e-5)


def test_encoder_layer_grads_match_torch():
    """d(loss)/d(input) parity: the backward math (through softmax, LN,
    residuals) agrees with torch's autograd on the same weights."""
    tl = torch_layer().eval()
    params = params_from_torch(tl)
    ours = TransformerEncoderLayer(D_MODEL, NHEAD, D_FF, dropout=0.0,
                                   causal=True)
    x = np.random.default_rng(3).standard_normal(
        (BATCH, SEQ, D_MODEL)).astype(np.float32)

    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    tl(xt, src_mask=causal_mask()).pow(2).sum().backward()
    exp = xt.grad.numpy()

    got = jax.grad(lambda a: jnp.sum(
        ours.apply(params, a, ctx=StageCtx()) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), exp, rtol=3e-4, atol=3e-4)
