"""pipe_tpu_torch: the PyTorch/CUDA port of pipe_tpu.

``Pipe`` runs a ``Sequential`` as a synchronous GPipe pipeline on one CUDA
device (``device="cpu"`` runs every kernel's plain PyTorch version instead).
Attention goes through a hand-written CUDA flash-attention kernel for Hopper
(``csrc/flash_attn_fwd.cu``). It imports neither JAX nor ``pipe_tpu``.
"""

from .core.microbatch import NoChunk
from .core.partition import BalanceError, StageCtx
from .models.transformer_lm import LMConfig, build_sequential, cross_entropy
from .ops.layers import (Decoder, Dropout, Embedding, Lambda, LayerNorm,
                         Linear, MultiHeadAttention, PositionalEncoding,
                         PreLNBlock, Sequential, TransformerEncoderLayer)
from .pipe import Pipe

__all__ = [
    "Pipe", "NoChunk", "BalanceError", "StageCtx",
    "Sequential", "Lambda", "Linear", "Embedding", "LayerNorm", "Dropout",
    "MultiHeadAttention", "TransformerEncoderLayer", "PreLNBlock",
    "PositionalEncoding", "Decoder",
    "LMConfig", "build_sequential", "cross_entropy",
]
