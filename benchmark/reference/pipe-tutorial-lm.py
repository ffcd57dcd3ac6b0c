"""Plain reference of the tutorial Transformer LM (``pipe-tutorial-lm``).

The PyTorch pipeline tutorial's model: token embedding scaled by
sqrt(emsize), sinusoidal positions, ``nlayers`` post-LN encoder layers
(``nn.TransformerEncoderLayer``'s defaults: self-attention, add & norm,
ReLU feed-forward of width ``nhid``, add & norm; causal mask), and a
linear decoder to ``ntokens`` logits. Dropout is 0, as the configuration
states. Plain float32 ``torch`` operations: no kernel, cache or pipeline.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import plain


def sizes(config: dict) -> dict:
    return {"d": config["emsize"], "ff": config["nhid"],
            "layers": config["nlayers"], "heads": config["nhead"],
            "vocab": config["ntokens"], "seq": config["bptt"]}


def leaf_specs(config: dict):
    """Every weight with its shape and initial distribution (those of the
    port's modules: projections uniform in ±1/sqrt(fan_in), attention
    biases zero, layer norms one and zero, the embedding N(0, 1))."""
    z = sizes(config)
    d, ff, V = z["d"], z["ff"], z["vocab"]
    specs = [("embed.weight", (V, d), "normal", 1.0)]
    for i in range(z["layers"]):
        p = f"blocks.{i}."
        for n in ("wq", "wk", "wv", "wo"):
            specs += [(f"{p}attn.{n}.weight", (d, d), "uniform",
                       1 / math.sqrt(d)),
                      (f"{p}attn.{n}.bias", (d,), "zeros", 0.0)]
        specs += [(f"{p}ff1.weight", (ff, d), "uniform", 1 / math.sqrt(d)),
                  (f"{p}ff1.bias", (ff,), "uniform", 1 / math.sqrt(d)),
                  (f"{p}ff2.weight", (d, ff), "uniform", 1 / math.sqrt(ff)),
                  (f"{p}ff2.bias", (d,), "uniform", 1 / math.sqrt(ff))]
        for n in ("ln1", "ln2"):
            specs += [(f"{p}{n}.weight", (d,), "ones", 0.0),
                      (f"{p}{n}.bias", (d,), "zeros", 0.0)]
    specs += [("decoder.weight", (V, d), "uniform", 1 / math.sqrt(d)),
              ("decoder.bias", (V,), "uniform", 1 / math.sqrt(d))]
    return specs


def make_weights(config: dict, seed: int, device):
    return plain.make_weights(leaf_specs(config), seed, device)


def positions(s: int, d: int, device) -> torch.Tensor:
    """The tutorial's sinusoid table ``[s, d]``."""
    pos = np.arange(s)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = np.zeros((s, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe, device=device)


def logits(w, tokens, config: dict) -> torch.Tensor:
    """``[b, s, ntokens]`` float32 logits of ``tokens [b, s]``."""
    z = sizes(config)
    d = z["d"]
    s = tokens.shape[-1]
    x = w["embed.weight"][tokens] * math.sqrt(d) + positions(s, d,
                                                             tokens.device)
    for i in range(z["layers"]):
        p = f"blocks.{i}."
        a = plain.self_attention(x, w, p + "attn.", z["heads"], causal=True)
        x = plain.layer_norm(x + a, w[p + "ln1.weight"], w[p + "ln1.bias"])
        h = torch.relu(plain.linear(x, w[p + "ff1.weight"], w[p + "ff1.bias"]))
        h = plain.linear(h, w[p + "ff2.weight"], w[p + "ff2.bias"])
        x = plain.layer_norm(x + h, w[p + "ln2.weight"], w[p + "ln2.bias"])
    return plain.linear(x, w["decoder.weight"], w["decoder.bias"])
