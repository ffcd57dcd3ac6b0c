"""The forward executor of ``Pipe(mesh=...)``: the GPipe wavefront over ranks.

Counterpart of ``pipe_tpu/parallel/hetero.py``'s ``HeteroSpmdPipeline``,
which runs a ``Pipe``'s heterogeneous partitions as one SPMD program: its
carriers pack every boundary into one static shape and a ``lax.switch``
picks each device's partition. Over ranks a rank holds one partition (per
interleave group) and runs it, so neither has a counterpart; boundaries
cross packed (``parallel/buffers.py``), each in its own shape. The
wavefront is the FWD rows of the gpipe table (micro-batch ``i`` at stage
``j`` in cycle ``i + j``), walked over ranks by ``parallel/scheduled.py``,
and :meth:`HeteroSpmdPipeline.loss_and_grad` is that table's training step
(torch's autograd does not cross processes, so the AD backward of JAX's
executor becomes the table's reverse wavefront, with the exact
per-micro-batch checkpoint policy).
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from ..utils.platform import DEFAULT_DEVICE
from .hetero_scheduled import HeteroScheduledPipeline

__all__ = ["HeteroSpmdPipeline"]


class HeteroSpmdPipeline(HeteroScheduledPipeline):
    """``Pipe`` partitions through the gpipe table, one partition per stage
    rank (``mesh=``) or all on one device; calling it is the forward."""

    def __init__(self, partitions: Sequence[nn.Module], skip_layout,
                 chunks: int, checkpoint: str = "except_last", *,
                 mesh=None, device=DEFAULT_DEVICE, remat_policy=None):
        super().__init__(partitions, skip_layout, chunks, checkpoint,
                         "gpipe", device=device, remat_policy=remat_policy,
                         mesh=mesh, overlap_transport=False,
                         phase_compile=False)

    def __call__(self, *inputs, seed: Optional[int] = None,
                 train: bool = False):
        return self.forward(*inputs, seed=seed, train=train)
