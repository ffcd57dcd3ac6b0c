"""Weight-only int8 quantization for KV-cached decoding.

Counterpart of ``pipe_tpu/inference/quant.py``. Block weights become int8
codes with one float32 scale per output channel (symmetric absmax); the
embedding, the decoder, biases and LayerNorm stay float. The generators
dequantize at use time, to the compute dtype in the blocks
(:class:`QuantLinear`) and to float32 in the head
(:func:`~pipe_tpu_torch.inference.generate.head_logits`).

Layout: ``pipe_tpu`` keeps ``w [in, out]`` and takes the absmax over axis
-2; a port ``Linear`` keeps ``weight [out, in]``, so the absmax is over dim
-1 and the scale is ``[out, 1]``: the same codes and scales, transposed.
Rounding is half to even in both (``jnp.round``, ``torch.round``).

Eager PyTorch does not fuse the dequantize into the matmul as XLA does: each
use materializes the compute-dtype weight, so int8 saves memory here and
not time (measured in ``PERF.md``).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..core.partition import StageCtx
from ..ops.layers import Linear

__all__ = ["QuantLeaf", "QuantLinear", "quantize_leaf", "quantize_params",
           "dequant_tree", "quantize_kv_rows"]


@dataclasses.dataclass
class QuantLeaf:
    """int8 codes and float32 scales of one weight: ``q`` in the weight's
    shape, ``scale`` of ``[..., out, 1]``."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(dtype)


def _absmax_int8(x: torch.Tensor):
    """Symmetric absmax int8 over the last dim: ``(codes, scale)``."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_leaf(weight: torch.Tensor) -> QuantLeaf:
    """One scale per output channel of a ``[out, in]`` weight."""
    return QuantLeaf(*_absmax_int8(weight.detach()))


class QuantLinear(nn.Module):
    """A block ``Linear`` with its weight held as int8 codes and float32
    scales (buffers ``q`` and ``scale``), dequantized to the dtype of the
    activations (the compute dtype) at every call; the bias stays float and
    is cast to it too."""

    def __init__(self, linear: Linear):
        super().__init__()
        leaf = quantize_leaf(linear.weight)
        self.in_features = linear.in_features
        self.features = linear.features
        self.register_buffer("q", leaf.q)
        self.register_buffer("scale", leaf.scale)
        self.bias = linear.bias

    @property
    def leaf(self) -> QuantLeaf:
        return QuantLeaf(self.q, self.scale)

    def forward(self, x, ctx: StageCtx = StageCtx()):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.leaf.dequant(x.dtype), bias)


def _quantize_linears(module: nn.Module) -> None:
    for name, child in module.named_children():
        if isinstance(child, Linear):
            setattr(module, name, QuantLinear(child))
        else:
            _quantize_linears(child)


def quantize_params(model: nn.Module) -> nn.Module:
    """A copy of ``model`` (a ``PipelinedTransformer``) whose blocks' weight
    matrices are :class:`QuantLinear`; the original is left as it is."""
    out = copy.deepcopy(model)
    _quantize_linears(out.blocks)
    return out


def quantize_kv_rows(rows: torch.Tensor):
    """Symmetric absmax int8 over the last dim, one float32 scale per
    ``[..., head_dim]`` vector: ``(codes, scale)``. The KV-row analog of
    :func:`quantize_leaf`, for the paged KV pool of the serving slice."""
    return _absmax_int8(rows)


def dequant_tree(tree, dtype=torch.bfloat16):
    """``tree`` (nested dicts, lists and tuples) with every
    :class:`QuantLeaf` dequantized to ``dtype``; identity elsewhere."""
    if isinstance(tree, QuantLeaf):
        return tree.dequant(dtype)
    if isinstance(tree, dict):
        return {k: dequant_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequant_tree(v, dtype) for v in tree)
    return tree
