"""pipe_tpu_torch: the PyTorch/CUDA port of pipe_tpu.

``Pipe`` runs a ``Sequential`` as a synchronous GPipe pipeline on one CUDA
device, for the eval forward and, under ``Trainer``, for training. Attention
goes through hand-written CUDA flash-attention kernels for Hopper: the
forward (``csrc/flash_attn_fwd.cu``), dQ (``csrc/flash_attn_bwd.cu``) and
dK/dV (``csrc/flash_attn_bwd_dkv.cu``), with Philox attention dropout inside
all three. ``Generator`` samples from a ``PipelinedLM`` with KV caches
(greedy, temperature/top-k, beam search, EOS, int8 weights), and
``serve.ServeEngine`` serves a request stream through decode slots with the
decode step captured in one CUDA graph. Every entry point runs on the card
unless it is given ``device="cpu"``, where each kernel's wrapper runs its
plain PyTorch version. It imports neither JAX nor ``pipe_tpu``.
"""

from .core.microbatch import NoChunk
from .core.partition import BalanceError, StageCtx
from .inference import GenerationConfig, Generator
from .models.transformer_lm import (LMConfig, PipelinedLM, build_sequential,
                                    cross_entropy)
from .ops.layers import (Decoder, Dropout, Embedding, Lambda, LayerNorm,
                         Linear, MultiHeadAttention, PositionalEncoding,
                         PreLNBlock, Sequential, TransformerEncoderLayer)
from .pipe import Pipe

__all__ = [
    "Pipe", "NoChunk", "BalanceError", "StageCtx",
    "Sequential", "Lambda", "Linear", "Embedding", "LayerNorm", "Dropout",
    "MultiHeadAttention", "TransformerEncoderLayer", "PreLNBlock",
    "PositionalEncoding", "Decoder",
    "LMConfig", "build_sequential", "cross_entropy", "PipelinedLM",
    "GenerationConfig", "Generator",
]
