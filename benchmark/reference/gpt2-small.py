"""Plain reference of GPT-2 small (``gpt2-small``).

OpenAI's GPT-2: learned token and position embeddings, ``n_layer`` pre-LN
blocks (x + attn(ln_1(x)), then x + mlp(ln_2(x)) with the tanh GELU of
``gelu_new`` and a 4·n_embd inner width), a final layer norm and a
vocabulary head. As the configuration states: dropout 0 and the head
untied from ``wte`` (a weight of its own, no bias). ``embed_skip`` adds the
embedding output to the last block's output before the final norm: the
cross-stage residual of the training cell's pipeline. Plain float32
``torch`` operations: no kernel, cache or pipeline.
"""

from __future__ import annotations

import math

import torch

from harness import plain


def sizes(config: dict) -> dict:
    d = config["n_embd"]
    return {"d": d, "ff": config["n_inner"] or 4 * d,
            "layers": config["n_layer"], "heads": config["n_head"],
            "vocab": config["vocab_size"], "seq": config["n_positions"],
            "eps": config["layer_norm_epsilon"]}


def leaf_specs(config: dict):
    """Every weight with its shape and initial distribution (those of the
    port's modules: ``wte`` N(0, 0.02²), ``wpe`` N(0, 0.01²), projections
    uniform in ±1/sqrt(fan_in), attention biases zero, layer norms one and
    zero)."""
    z = sizes(config)
    d, ff, V = z["d"], z["ff"], z["vocab"]
    specs = [("wte", (V, d), "normal", 0.02),
             ("wpe", (z["seq"], d), "normal", 0.01)]
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
    specs += [("ln_f.weight", (d,), "ones", 0.0),
              ("ln_f.bias", (d,), "zeros", 0.0),
              ("head.weight", (V, d), "uniform", 1 / math.sqrt(d))]
    return specs


def make_weights(config: dict, seed: int, device):
    return plain.make_weights(leaf_specs(config), seed, device)


def logits(w, tokens, config: dict, embed_skip: bool = False
           ) -> torch.Tensor:
    """``[b, s, vocab]`` float32 logits of ``tokens [b, s]``."""
    z = sizes(config)
    s = tokens.shape[-1]
    h0 = w["wte"][tokens] + w["wpe"][:s]
    x = h0
    for i in range(z["layers"]):
        p = f"blocks.{i}."
        ln = plain.layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"],
                              z["eps"])
        x = x + plain.self_attention(ln, w, p + "attn.", z["heads"],
                                     causal=True)
        ln = plain.layer_norm(x, w[p + "ln2.weight"], w[p + "ln2.bias"],
                              z["eps"])
        h = plain.gelu_tanh(plain.linear(ln, w[p + "ff1.weight"],
                                         w[p + "ff1.bias"]))
        x = x + plain.linear(h, w[p + "ff2.weight"], w[p + "ff2.bias"])
    if embed_skip:
        x = x + h0
    x = plain.layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], z["eps"])
    return plain.linear(x, w["head.weight"])
