"""Packed word carrier: one flat buffer of 32-bit words per message.

Counterpart of ``pipe_tpu/parallel/buffers.py``'s ``pack_words`` /
``unpack_words``: a pytree of tensors (leaves in ``jax.tree_util`` order:
dict keys sorted, lists and tuples in order) becomes one flat vector of
32-bit words, each leaf raveled, padded to whole words and bit-cast, so a
stage boundary with several leaves, dtypes or skip lanes crosses in one
message, bit for bit. The words are ``torch.int32`` here (JAX's are
``uint32``; the bytes are the same). The sentinel-slot helpers of the JAX
module serve its compiled loop and have no counterpart in a table walk.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..core.packing import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["packed_words", "pack_words", "unpack_words"]

_WORD = 4                   # bytes per packed word


def _leaf_words(shape: Sequence[int], dtype: torch.dtype) -> int:
    size = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    nbytes = size * torch.empty((), dtype=dtype).element_size()
    return -(-nbytes // _WORD)


def packed_words(spec_tree: Any) -> int:
    """Words :func:`pack_words` produces for this spec (leaves need only
    ``.shape`` and ``.dtype``)."""
    return sum(_leaf_words(tuple(l.shape), l.dtype)
               for l in tree_leaves(spec_tree))


def _pack_leaf(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        raise TypeError("pack_words: bool leaves have no defined bit "
                        "layout; cast to uint8 first")
    flat = x.detach().contiguous().reshape(-1)
    size = flat.element_size()
    if size < _WORD:
        pad = (-flat.numel()) % (_WORD // size)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(torch.uint8).view(torch.int32)


def pack_words(tree: Any) -> torch.Tensor:
    """A pytree of tensors as one flat ``int32`` word vector (bitwise)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.int32)
    return torch.cat([_pack_leaf(x) for x in leaves])


def unpack_words(vec: torch.Tensor, spec_tree: Any) -> Any:
    """Inverse of :func:`pack_words` given the spec of the packed tree:
    slices at fixed offsets, bitwise, each leaf a copy."""
    leaves, treedef = tree_flatten(spec_tree)
    out, off = [], 0
    for spec in leaves:
        shape, dtype = tuple(spec.shape), spec.dtype
        nw = _leaf_words(shape, dtype)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        raw = vec[off:off + nw].contiguous().view(torch.uint8)
        esize = torch.empty((), dtype=dtype).element_size()
        out.append(raw[:size * esize].view(dtype).reshape(shape).clone())
        off += nw
    return tree_unflatten(treedef, out)
