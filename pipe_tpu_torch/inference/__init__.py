"""Inference: KV-cached autoregressive generation over the pipelined LM
(``generate``), int8 weight-only quantization (``quant``), the draft
sources of the speculative serve lane (``draft``), decoding with the prompt's KV
cache sharded over a context axis (``long_context``) and decoding over
weights sharded over a model axis (``tp``)."""

from .draft import (DraftSource, NgramDraft, TreeDraft, TruncatedDraft,
                    resolve_draft, tree_layout)
from .generate import (GenerationConfig, Generator, check_positions,
                       head_logits, keyed_uniform, sample_logits, seed_word,
                       sequence_lengths)
from .long_context import ContextShardedGenerator
from .tp import TPShardedGenerator
from .quant import (QuantLeaf, QuantLinear, dequant_tree, quantize_kv_rows,
                    quantize_params)

__all__ = ["GenerationConfig", "Generator", "check_positions", "head_logits",
           "keyed_uniform", "sample_logits", "seed_word", "sequence_lengths",
           "QuantLeaf", "QuantLinear", "quantize_params", "dequant_tree",
           "quantize_kv_rows", "DraftSource", "NgramDraft", "TruncatedDraft",
           "TreeDraft", "tree_layout", "resolve_draft",
           "ContextShardedGenerator", "TPShardedGenerator"]
