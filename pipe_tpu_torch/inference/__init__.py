"""Inference: KV-cached autoregressive generation over the pipelined LM
(``generate``), int8 weight-only quantization (``quant``) and the draft
sources of the speculative serve lane (``draft``)."""

from .draft import (DraftSource, NgramDraft, TreeDraft, TruncatedDraft,
                    resolve_draft, tree_layout)
from .generate import (GenerationConfig, Generator, check_positions,
                       head_logits, keyed_uniform, sample_logits, seed_word,
                       sequence_lengths)
from .quant import (QuantLeaf, QuantLinear, dequant_tree, quantize_kv_rows,
                    quantize_params)

__all__ = ["GenerationConfig", "Generator", "check_positions", "head_logits",
           "keyed_uniform", "sample_logits", "seed_word", "sequence_lengths",
           "QuantLeaf", "QuantLinear", "quantize_params", "dequant_tree",
           "quantize_kv_rows", "DraftSource", "NgramDraft", "TruncatedDraft",
           "TreeDraft", "tree_layout", "resolve_draft"]
