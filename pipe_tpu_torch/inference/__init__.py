"""Inference: KV-cached autoregressive generation over the pipelined LM
(``generate``) and int8 weight-only quantization (``quant``)."""

from .generate import (GenerationConfig, Generator, check_positions,
                       head_logits, keyed_uniform, sample_logits, seed_word,
                       sequence_lengths)
from .quant import (QuantLeaf, QuantLinear, dequant_tree, quantize_kv_rows,
                    quantize_params)

__all__ = ["GenerationConfig", "Generator", "check_positions", "head_logits",
           "keyed_uniform", "sample_logits", "seed_word", "sequence_lengths",
           "QuantLeaf", "QuantLinear", "quantize_params", "dequant_tree",
           "quantize_kv_rows"]
