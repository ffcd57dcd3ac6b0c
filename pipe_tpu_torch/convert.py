"""Carry ``pipe_tpu`` weights into this package's modules.

``pipe_tpu``'s ``Pipe.init`` returns one param list per stage, one entry per
layer (a dict of arrays, a nested dict for a block, ``{}`` for a
parameterless layer). :func:`load_stage_params` copies such a list, as numpy
arrays (or anything ``np.asarray`` takes), into a :class:`~pipe_tpu_torch.Pipe`
layer by layer. The layouts that differ:

* ``Linear``: ``pipe_tpu`` stores ``w [in, out]``; here ``weight [out, in]``,
  so it is transposed;
* ``MultiHeadAttention``: ``wq/wk/wv/wo [d, d]`` plus ``bq/bk/bv/bo``; each
  becomes a ``Linear`` (transposed). Heads are contiguous slices of the
  output dim in both packages, so no head permutation is needed;
* ``LayerNorm``: ``g/b`` become ``weight/bias``; ``Embedding``: ``table``
  becomes ``weight``.

:func:`load_pipelined_lm_params` copies the JAX ``Trainer``'s params, the
``PipelinedLM`` triple ``(stage_params, pre_params, post_params)``, into a
``Pipe`` over the tutorial LM cut by ``pipelined_lm_balance``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from .ops.layers import (Decoder, Dropout, Embedding, LayerNorm, Lambda,
                         Linear, MultiHeadAttention, PositionalEncoding,
                         Sequential, _TransformerBlockBase)

__all__ = ["load_params", "load_stage_params", "load_pipelined_lm_params"]


def _copy(dst: torch.Tensor, src: Any, transpose: bool = False) -> None:
    arr = np.asarray(src)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: pipe_tpu array {arr.shape} -> "
                         f"parameter {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)))   # a writable copy


def _linear(lin: Linear, w, b) -> None:
    _copy(lin.weight, w, transpose=True)
    if lin.bias is not None:
        _copy(lin.bias, b)


def load_params(layer: nn.Module, params: Any) -> None:
    """Copy one layer's ``pipe_tpu`` params into ``layer`` in place."""
    if isinstance(layer, Sequential):
        if len(params) != len(layer):
            raise ValueError(f"Sequential of {len(layer)} layers got "
                             f"{len(params)} param entries")
        for sub, p in zip(layer, params):
            load_params(sub, p)
    elif isinstance(layer, Linear):
        _linear(layer, params["w"], params.get("b"))
    elif isinstance(layer, Decoder):
        _linear(layer.proj, params["w"], params.get("b"))
    elif isinstance(layer, Embedding):
        _copy(layer.weight, params["table"])
    elif isinstance(layer, LayerNorm):
        _copy(layer.weight, params["g"])
        _copy(layer.bias, params["b"])
    elif isinstance(layer, MultiHeadAttention):
        for name in ("q", "k", "v", "o"):
            _linear(getattr(layer, "w" + name), params["w" + name],
                    params["b" + name])
    elif isinstance(layer, _TransformerBlockBase):
        for name in ("attn", "ff1", "ff2", "ln1", "ln2"):
            load_params(getattr(layer, name), params[name])
    elif isinstance(layer, (PositionalEncoding, Dropout, Lambda)):
        if params:
            raise ValueError(f"{type(layer).__name__} has no parameters, got "
                             f"{sorted(params)}")
    else:
        raise TypeError(f"no pipe_tpu layout known for {type(layer).__name__}")


def load_stage_params(pipe, params_per_stage: Sequence[Any]) -> None:
    """Copy ``pipe_tpu``'s per-stage params (``Pipe.init``'s result) into
    ``pipe``, whose partitions must have the same balance."""
    if len(params_per_stage) != len(pipe.partitions):
        raise ValueError(f"{len(params_per_stage)} stages of params for a "
                         f"Pipe of {len(pipe.partitions)} stages")
    for part, params in zip(pipe.partitions, params_per_stage):
        load_params(part, params)


def load_pipelined_lm_params(pipe, params: Sequence[Any]) -> None:
    """Copy ``pipe_tpu``'s ``PipelinedLM`` params into ``pipe``, a ``Pipe``
    over ``build_sequential`` with the ``pipelined_lm_balance`` cut.

    ``params`` is ``(stage_params, pre_params, post_params)`` as numpy arrays
    (or anything ``np.asarray`` takes): ``pre_params["embed"]`` goes to the
    embedding, ``post_params["decoder"]`` to the decoder, and block ``l`` of
    stage ``s`` to that stage's ``l``-th transformer block. ``stage_params``
    is stage-stacked (a list of blocks whose leaves lead with the stage axis,
    as ``stack_stage_params`` leaves them) or a per-stage list of block lists.
    """
    stage_params, pre, post = params
    n = len(pipe.partitions)
    if len(stage_params) == n and isinstance(stage_params[0], (list, tuple)):
        per_stage = [list(blocks) for blocks in stage_params]
    else:
        per_stage = [[_take(block, j) for block in stage_params]
                     for j in range(n)]
    layers = list(pipe)
    lps = len(per_stage[0])
    if len(layers) != n * lps + 3 or any(len(b) != lps for b in per_stage):
        raise ValueError(
            f"a Pipe of {len(layers)} layers over {n} stages does not hold "
            f"{n} stages of {lps} blocks plus embedding, positions and decoder")
    load_params(layers[0], pre["embed"])
    for j, blocks in enumerate(per_stage):
        for l, block in enumerate(blocks):
            load_params(layers[2 + j * lps + l], block)
    load_params(layers[-1], post["decoder"])


def _take(tree: Any, j: int) -> Any:
    """Index ``j`` of the leading (stage) axis of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _take(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]
