"""Ulysses sequence parallelism: all-to-all head <-> sequence resharding.

Counterpart of ``pipe_tpu/ops/ulysses_attention.py``, the second
long-context strategy beside :mod:`.ring_attention`. Inputs arrive
``[rows, seq / c, heads, d]`` (the sequence sharded over the context line);
one tiled all-to-all of q, k and v stacked (``parallel.mesh.all_to_all``;
JAX runs one per operand) flips them to
``[rows, seq, heads / c, d]``, each rank then holding the whole sequence for
``heads / c`` heads; attention runs unsharded on each rank, so the flash
kernels (``ops/flash_attention.py``) take it as they are; one reverse
all-to-all restores the sequence sharding. Two all-to-alls (four
activation-sized tensors) per attention, ``heads % c == 0``, and one
full-sequence attention of ``heads / c`` heads in memory; exact, like the
ring. The all-to-all is an ``autograd.Function`` whose backward is the
reverse all-to-all, as JAX transposes it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import all_to_all

__all__ = ["ulysses_attention"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh=None, *, causal: bool = True,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``mesh``'s context line.

    ``q``/``k``/``v``: this rank's shards ``[rows, seq_local, heads,
    head_dim]`` (the global sequence is ``seq_local * n_context``);
    ``heads`` must divide by ``n_context``. ``causal`` masks global
    positions (after the reshard positions are global). ``attn_fn(q, k, v,
    causal) -> o`` over full-sequence inputs; by default the flash kernels
    where ``ops.layers.flash_auto_ok`` takes the shape (on the card at a
    length the kernels take: they run, or the call raises), else plain
    attention. Returns the output with the input's sharding.
    """
    c = 1 if mesh is None else mesh.context_size
    heads = q.shape[2]
    if heads % c:
        raise ValueError(
            f"ulysses_attention needs heads % axis_size == 0, got "
            f"heads={heads}, axis_size={c}")

    # [3, rows, s/c, h, d] -> [3, rows, s, h/c, d]: q, k and v in one
    # all-to-all (JAX reshards each operand on its own)
    qf, kf, vf = all_to_all(mesh, torch.stack((q, k, v)), 3, 2).unbind(0)
    if attn_fn is None:
        o = _default_attention(qf, kf, vf, causal)
    else:
        o = attn_fn(qf, kf, vf, causal)
    # [rows, s, h/c, d] -> [rows, s/c, h, d]
    return all_to_all(mesh, o.to(q.dtype), 1, 2)


def _default_attention(q, k, v, causal: bool):
    """Full-sequence attention under the shared auto rule
    (``layers.flash_auto_ok``): the flash kernels or plain attention."""
    from .flash_attention import flash_attention
    from .layers import dot_product_attention, flash_auto_ok

    if flash_auto_ok(q.shape[1], q.device, q.dtype, q.shape[-1]):
        return flash_attention(q, k, v, causal=causal)
    return dot_product_attention(q, k, v, causal=causal)
