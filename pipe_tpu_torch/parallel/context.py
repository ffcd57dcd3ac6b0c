"""Context (sequence) parallelism: the sequence axis sharded over the mesh.

Counterpart of ``pipe_tpu/parallel/context.py``. A ``context`` axis of the
mesh (``make_mesh(..., n_context=)``) carries ring attention
(``ops/ring_attention.py``) or Ulysses attention
(``ops/ulysses_attention.py``), so sequences longer than one card's memory
run exactly; it composes with the ``(stage, data)`` axes.

One difference from JAX's: :func:`context_parallel_attention` takes and
returns this rank's sequence shard ``[b, s_local, h, d]``, where JAX's takes
global arrays and shards them under ``shard_map``: a rank here holds only
its shard (ROADMAP.md C.24).
"""

from __future__ import annotations

import torch

from ..ops.ring_attention import ring_attention
from .mesh import CONTEXT_AXIS, make_mesh

__all__ = ["CONTEXT_AXIS", "make_context_mesh", "context_parallel_attention"]


def make_context_mesh(n_context: int):
    """A mesh of one stage and one data rank over ``n_context`` context
    ranks: the whole initialized world, which must hold ``n_context``
    ranks."""
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_initialized() else 1
    if n_context <= 0 or n_context != have:
        raise ValueError(f"need {n_context} devices, have {have}")
    return make_mesh(1, 1, n_context=n_context)


def context_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               impl: str = "ring") -> torch.Tensor:
    """Exact attention with the sequence sharded over ``mesh``'s context
    axis: ``q``/``k``/``v`` are this rank's shards ``[batch, seq_local,
    heads, head_dim]``, and so is the result.

    ``impl='ring'`` rotates K/V blocks round the context ring (block-sized
    memory, any head count); ``impl='ulysses'`` reshards to the full
    sequence over ``heads / c`` heads by all-to-all, which lets the flash
    kernels run unsharded (needs ``heads % c == 0``).
    """
    if impl == "ring":
        return ring_attention(q, k, v, mesh, causal=causal)
    if impl == "ulysses":
        from ..ops.ulysses_attention import ulysses_attention
        return ulysses_attention(q, k, v, mesh, causal=causal)
    raise ValueError(f"impl must be ring|ulysses, got {impl!r}")
