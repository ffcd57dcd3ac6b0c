"""The port's GPT-2 under the reference's weight names."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def model_config(config: dict):
    """The port's ``GPT2Config`` for the configuration file's sizes."""
    from pipe_tpu_torch.models.gpt2 import GPT2Config

    d = config["n_embd"]
    if config["resid_pdrop"] != config["embd_pdrop"] \
            or config["resid_pdrop"] != config["attn_pdrop"]:
        raise ValueError("the port's GPT-2 takes one dropout rate")
    return GPT2Config(vocab=config["vocab_size"], d_model=d,
                      nhead=config["n_head"],
                      d_ff=config["n_inner"] or 4 * d,
                      n_layers=config["n_layer"],
                      dropout=config["resid_pdrop"],
                      seq_len=config["n_positions"])


def leaves(modules) -> List[Tuple[str, torch.nn.Parameter]]:
    """(reference name, parameter) of every weight among ``modules`` (a
    ``build_sequential`` layer list, or a ``PipelinedGPT2``'s children)."""
    from pipe_tpu_torch.models.gpt2 import GPT2Embed, GPT2Head
    from pipe_tpu_torch.ops.layers import PreLNBlock

    out, block = [], 0
    for m in modules:
        if isinstance(m, GPT2Embed):
            out += [("wte", m.wte), ("wpe", m.wpe)]
        elif isinstance(m, PreLNBlock):
            out += [(f"blocks.{block}.{n}", p) for n, p in m.named_parameters()]
            block += 1
        elif isinstance(m, GPT2Head):
            out += [("ln_f.weight", m.ln_f.weight),
                    ("ln_f.bias", m.ln_f.bias),
                    ("head.weight", m.proj.weight)]
        elif isinstance(m, torch.nn.ModuleList):
            for b in m:
                out += [(f"blocks.{block}.{n}", p)
                        for n, p in b.named_parameters()]
                block += 1
    return out


def load(modules, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the port's parameters."""
    named = leaves(modules)
    if {n for n, _ in named} != set(weights):
        raise ValueError("the port's GPT-2 and the reference name different "
                         "weights")
    with torch.no_grad():
        for name, p in named:
            p.copy_(weights[name])
