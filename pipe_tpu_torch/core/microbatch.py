"""Micro-batch scatter/gather: split a mini-batch into micro-batches and back.

Counterpart of ``pipe_tpu/core/microbatch.py`` (``torch.chunk`` semantics on
dim 0):

* chunk size is ``ceil(n / chunks)``, so a call may yield *fewer* than
  ``chunks`` micro-batches and the last one may be smaller;
* tensors wrapped in :class:`NoChunk` and non-tensor values are replicated
  into every micro-batch rather than split;
* ``gather`` concatenates tensors per position; replicated positions are
  taken from the first micro-batch.

Micro-batches are views of the input (``x[a:b]``), not copies.

:func:`stack_scatter` and :func:`valid_row_mask` are the stacked layout that
the table executor takes: every tensor ``[n, ...] -> [chunks, ceil(n /
chunks), ...]``, zero-padded at the tail, with the mask of the real rows.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple, Union

import torch

__all__ = ["is_array", "NoChunk", "Batch", "check", "scatter", "gather",
           "stack_scatter", "valid_row_mask"]


def is_array(value: Any) -> bool:
    """True for tensors."""
    return isinstance(value, torch.Tensor)


class NoChunk:
    """Wrap a tensor to exclude it from scatter's dim-0 split: it is
    replicated to every micro-batch whole."""

    __slots__ = ("_value",)

    def __init__(self, value):
        if not is_array(value):
            raise TypeError(f"NoChunk expects an array, got {type(value).__name__}")
        self._value = value

    @property
    def value(self):
        return self._value

    def __repr__(self) -> str:
        return f"NoChunk({self._value!r})"


class Batch:
    """One micro-batch: an immutable tuple of values with helpers.

    ``atomic`` marks the single-tensor fast path; :meth:`call` applies a
    function to the payload.
    """

    __slots__ = ("_values", "atomic", "replicated")

    def __init__(self, values: Union[Any, Tuple[Any, ...]], atomic: bool = False,
                 replicated: Tuple[int, ...] = ()):
        if atomic:
            self._values = (values,)
        else:
            self._values = tuple(values)
        self.atomic = atomic
        # Positions holding replicated (NoChunk / non-tensor) values: gather
        # takes them from one micro-batch instead of concatenating.
        self.replicated = tuple(replicated)

    @property
    def values(self) -> Tuple[Any, ...]:
        return self._values

    @property
    def tensor(self):
        """The sole tensor of an atomic batch."""
        if not self.atomic:
            raise AttributeError("not an atomic batch; use .values / .tensors")
        return self._values[0]

    @property
    def tensors(self) -> Tuple[Any, ...]:
        if self.atomic:
            raise AttributeError("atomic batch; use .tensor")
        return self._values

    def call(self, function: Callable) -> "Batch":
        """Apply ``function`` to the payload: ``function(tensor)`` for an
        atomic batch, ``function(*values)`` otherwise. A tuple/list result is
        a non-atomic batch, a single value an atomic one. Replication marks
        do not survive: a stage may permute or overwrite positions."""
        if self.atomic:
            result = function(self._values[0])
        else:
            result = function(*self._values)
        if isinstance(result, (tuple, list)):
            return Batch(tuple(result), atomic=False)
        return Batch(result, atomic=True)

    def find_tensor_idx(self) -> int:
        """Index of the first tensor value."""
        for i, v in enumerate(self._values):
            if is_array(v):
                return i
        raise ValueError("no array in batch")

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return Batch(self._values[index], atomic=False)
        return self._values[index]

    def with_value(self, index: int, value) -> "Batch":
        """A copy with position ``index`` replaced."""
        values = list(self._values)
        values[index] = value
        return Batch(tuple(values), atomic=self.atomic and len(values) == 1)

    def __repr__(self) -> str:
        return f"Batch({self._values!r}, atomic={self.atomic})"


def check(*inputs: Any) -> None:
    """Validate pipeline inputs: at least one tensor among them."""
    if not inputs:
        raise TypeError("no input provided")
    for x in inputs:
        if is_array(x) or isinstance(x, NoChunk):
            return
    raise TypeError("expected at least one array as input")


def _chunk_sizes(n: int, chunks: int) -> List[int]:
    """``torch.chunk`` split sizes: ceil-sized chunks, possibly fewer than asked."""
    if chunks <= 0:
        raise ValueError("number of chunks must be positive")
    size = math.ceil(n / chunks)
    if size == 0:
        return [n]
    sizes = []
    remaining = n
    while remaining > 0:
        take = min(size, remaining)
        sizes.append(take)
        remaining -= take
    return sizes or [0]


def scatter(inputs: Sequence[Any], chunks: int) -> List[Batch]:
    """Split each tensor input along dim 0 into micro-batches.

    ``NoChunk``-wrapped tensors and non-tensor values are replicated whole.
    All split inputs must agree on batch size. Returns a list of
    :class:`Batch`; its length may be < ``chunks``.
    """
    if isinstance(inputs, Batch):
        raise TypeError("scatter takes raw inputs, not a Batch")
    inputs = tuple(inputs)
    check(*inputs)

    batch_size = None
    for x in inputs:
        if is_array(x):
            if x.dim() == 0:
                raise ValueError("cannot scatter a 0-d array; wrap it in NoChunk")
            if batch_size is None:
                batch_size = x.shape[0]
            elif x.shape[0] != batch_size:
                raise ValueError(
                    f"inconsistent batch sizes: {batch_size} vs {x.shape[0]}")
    if batch_size is None:
        # Only NoChunk/non-tensor inputs: replicate into exactly `chunks` batches.
        sizes = [None] * chunks
    else:
        sizes = _chunk_sizes(batch_size, chunks)

    atomic = len(inputs) == 1 and is_array(inputs[0])

    per_chunk: List[List[Any]] = [[] for _ in sizes]
    replicated: List[int] = []
    for pos, x in enumerate(inputs):
        if isinstance(x, NoChunk):
            replicated.append(pos)
            for vals in per_chunk:
                vals.append(x.value)
        elif is_array(x):
            offset = 0
            for k, sz in enumerate(sizes):
                per_chunk[k].append(x[offset:offset + sz])
                offset += sz
        else:
            replicated.append(pos)
            for vals in per_chunk:
                vals.append(x)

    if atomic:
        return [Batch(vals[0], atomic=True) for vals in per_chunk]
    rep = tuple(replicated)
    return [Batch(tuple(vals), atomic=False, replicated=rep)
            for vals in per_chunk]


def gather(batches: Sequence[Batch]):
    """Concatenate micro-batches back into a mini-batch: tensor positions
    along dim 0, replicated positions from the first batch. A single value
    for atomic batches, else a tuple."""
    if not batches:
        raise ValueError("no batches to gather")
    first = batches[0]
    if first.atomic:
        return torch.cat([b.tensor for b in batches], dim=0)
    outputs = []
    for i in range(len(first)):
        if is_array(first[i]) and i not in first.replicated:
            outputs.append(torch.cat([b[i] for b in batches], dim=0))
        else:
            outputs.append(first[i])
    return tuple(outputs)


def stack_scatter(tree: Any, chunks: int) -> Tuple[Any, int]:
    """Reshape every tensor of ``tree`` (a tensor or a dict of tensors)
    ``[n, ...] -> [chunks, ceil(n / chunks), ...]``, right-padding dim 0
    with zeros where ``chunks`` does not divide ``n``; returns the stacked
    tree and ``n``. Counterpart of ``pipe_tpu``'s ``stack_scatter``."""
    if chunks <= 0:
        raise ValueError("number of chunks must be positive")
    leaves = list(tree.values()) if isinstance(tree, dict) else [tree]
    if not leaves or not all(is_array(leaf) for leaf in leaves):
        raise TypeError("stack_scatter takes a tensor or a dict of tensors")
    sizes = {leaf.shape[0] for leaf in leaves}
    if len(sizes) > 1:
        raise ValueError("inconsistent batch sizes in stack_scatter")
    batch_size = sizes.pop()
    mb = math.ceil(batch_size / chunks)

    def split(leaf):
        if mb * chunks != batch_size:
            pad = leaf.new_zeros((mb * chunks - batch_size,)
                                 + tuple(leaf.shape[1:]))
            leaf = torch.cat([leaf, pad], dim=0)
        return leaf.reshape((chunks, mb) + tuple(leaf.shape[1:]))

    if isinstance(tree, dict):
        return {k: split(v) for k, v in tree.items()}, batch_size
    return split(tree), batch_size


def valid_row_mask(stacked: Any, batch_size: int) -> torch.Tensor:
    """``[chunks, mb_rows]`` float32 mask of the real rows of a stacked
    batch: row ``(c, r)`` is real iff ``c * mb_rows + r < batch_size``
    (:func:`stack_scatter` pads at the tail)."""
    leaf = next(iter(stacked.values())) if isinstance(stacked, dict) \
        else stacked
    chunks_n, mb_rows = leaf.shape[:2]
    idx = torch.arange(chunks_n * mb_rows, device=leaf.device)
    return (idx < batch_size).float().reshape(chunks_n, mb_rows)
