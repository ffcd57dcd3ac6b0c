"""The model zoo: the tutorial LM and the BASELINE.json config families.

* :mod:`.transformer_lm`: the tutorial LM (reference ``main.py``).
* :mod:`.gpt2`: GPT-2-small causal LM with the optional ``@skippable``
  embedding shortcut (config #3).
* :mod:`.bert`: BERT-large masked-LM pretraining, interleave-ready
  (config #4).
* :mod:`.vit`: ViT-L/16 image classification, non-LM shapes (config #5).

``pipe_tpu``'s ring-attention ``ContextParallelLM`` needs a context mesh
and is not ported yet (ROADMAP.md: A.10).
"""

from .bert import BertConfig, PipelinedBERT, mask_tokens
from .common import PipelinedTransformer, per_row_ce
from .gpt2 import GPT2Config, PipelinedGPT2
from .transformer_lm import LMConfig, PipelinedLM
from .vit import PipelinedViT, ViTConfig

__all__ = [
    "BertConfig", "PipelinedBERT", "mask_tokens",
    "GPT2Config", "PipelinedGPT2",
    "LMConfig", "PipelinedLM",
    "PipelinedTransformer", "per_row_ce",
    "PipelinedViT", "ViTConfig",
]
