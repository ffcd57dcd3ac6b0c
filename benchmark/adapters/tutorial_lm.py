"""The port's tutorial LM under the reference's weight names."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def model_config(config: dict):
    """The port's ``LMConfig`` for the configuration file's sizes."""
    from pipe_tpu_torch.models.transformer_lm import LMConfig

    return LMConfig(vocab=config["ntokens"], d_model=config["emsize"],
                    nhead=config["nhead"], d_ff=config["nhid"],
                    n_layers=config["nlayers"], dropout=config["dropout"],
                    seq_len=config["bptt"])


def leaves(layers) -> List[Tuple[str, torch.nn.Parameter]]:
    """(reference name, parameter) of every weight of the LM's layers
    (embedding, positions, encoder layers, decoder) in order."""
    from pipe_tpu_torch.ops.layers import (Decoder, Embedding,
                                           TransformerEncoderLayer)

    out, block = [], 0
    for layer in layers:
        if isinstance(layer, Embedding):
            out.append(("embed.weight", layer.weight))
        elif isinstance(layer, TransformerEncoderLayer):
            out += [(f"blocks.{block}.{n}", p)
                    for n, p in layer.named_parameters()]
            block += 1
        elif isinstance(layer, Decoder):
            out += [("decoder.weight", layer.proj.weight),
                    ("decoder.bias", layer.proj.bias)]
    return out


def load(layers, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the port's parameters."""
    named = leaves(layers)
    if {n for n, _ in named} != set(weights):
        raise ValueError("the port's LM and the reference name different "
                         "weights")
    with torch.no_grad():
        for name, p in named:
            p.copy_(weights[name])
