"""The model zoo: the tutorial LM and the BASELINE.json config families.

* :mod:`.transformer_lm`: the tutorial LM (reference ``main.py``).
* :mod:`.gpt2`: GPT-2-small causal LM with the optional ``@skippable``
  embedding shortcut (config #3).
* :mod:`.bert`: BERT-large masked-LM pretraining, interleave-ready
  (config #4).
* :mod:`.vit`: ViT-L/16 image classification, non-LM shapes (config #5).
* :mod:`.long_context_lm`: the tutorial LM with its sequence sharded over
  a context axis (ring or Ulysses attention), ``ContextParallelLM``.
* :mod:`.tp_lm`: the tutorial LM with Megatron-split blocks whose heads
  and FFN columns shard over the mesh's model axis, ``TPPipelinedLM``.
* :mod:`.moe_lm`: the tutorial LM with Mixture-of-Experts blocks whose
  heads and experts shard over the mesh's model axis, ``MoEPipelinedLM``.
"""

from .bert import BertConfig, PipelinedBERT, mask_tokens
from .common import PipelinedTransformer, per_row_ce
from .gpt2 import GPT2Config, PipelinedGPT2
from .long_context_lm import ContextParallelLM
from .moe_lm import MoELMConfig, MoEPipelinedLM
from .tp_lm import TPPipelinedLM
from .transformer_lm import LMConfig, PipelinedLM
from .vit import PipelinedViT, ViTConfig

__all__ = [
    "BertConfig", "PipelinedBERT", "mask_tokens", "ContextParallelLM",
    "GPT2Config", "PipelinedGPT2",
    "LMConfig", "PipelinedLM",
    "PipelinedTransformer", "per_row_ce",
    "PipelinedViT", "ViTConfig", "TPPipelinedLM", "MoELMConfig",
    "MoEPipelinedLM",
]
