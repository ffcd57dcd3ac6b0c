"""Mixture-of-Experts Transformer LM: the PP x DP x EP factorization.

Counterpart of ``pipe_tpu/models/moe_lm.py``: the tutorial LM's embed |
k blocks per stage | decoder factorization (:class:`PipelinedLM`'s embed,
positions, loss and key schedule), with the hybrid block of
:mod:`~pipe_tpu_torch.ops.moe` (TP attention + MoE FFN, heads and experts
sharded over the mesh's ``model`` axis). The embed and the decoder stay
replicated over the model axis.

Aux-loss note: the load-balance auxiliary is available at the layer level
(``moe_ffn_apply`` returns it); the homogeneous stage contract is ``h ->
h``, so the pipelined model trains the router through the GATING path only
(the top-k gate values multiply the expert outputs, so router gradients
flow regardless) and drops the aux regularizer. Threading a scalar
accumulator channel through the table executor is the documented
follow-up (the hetero path's deferred-BN lanes show the mechanism).

Where JAX binds the model axis by name inside ``shard_map``, the blocks here
read the rank's ``mesh`` (as ``TPPipelinedLM``'s do): without one, or with
a model line of one, the block runs the unsharded math. ``pipe_tpu`` has no
split stage for this block, so ``ScheduledPipeline`` refuses ``split_stage``
with ``stage_param_specs`` here too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.layers import Decoder, Embedding, PositionalEncoding
from ..ops.moe import MoEBlock, moe_block_specs
from ..parallel.mesh import MODEL_AXIS
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .common import PipelinedTransformer
from .transformer_lm import LMConfig, PipelinedLM

__all__ = ["MoELMConfig", "MoEPipelinedLM"]


@dataclasses.dataclass(frozen=True)
class MoELMConfig(LMConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


class MoEPipelinedLM(PipelinedLM):
    """embed | k MoE blocks per stage | decoder, over (stage, data, model).

    The factorization, embed/posenc/loss path and key schedule of
    :class:`PipelinedLM`; only the block differs (:class:`MoEBlock`, whole
    parameters until ``parallel.mesh.shard_params`` cuts them).
    ``ep_axis=None`` runs the same math unsharded (the transparency
    yardstick). ``tp_axis`` equals ``ep_axis``: the sharded generator's
    contract (heads shard over the experts' axis). ``mesh``: the rank's
    mesh, whose model line the blocks all-reduce over (settable later:
    :attr:`mesh`). Weights are drawn from ``generator`` (seeded 0 if None)
    in module order: embedding, blocks, decoder.
    """

    def __init__(self, cfg: MoELMConfig, n_stages: int = 1,
                 ep_axis: Optional[str] = MODEL_AXIS, *, mesh=None,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        embed = Embedding(cfg.vocab, cfg.d_model, scale=True,
                          generator=generator, device=dev)
        posenc = PositionalEncoding(cfg.d_model, cfg.dropout,
                                    max_len=max(5000, cfg.seq_len),
                                    compute_dtype=cfg.compute_dtype,
                                    device=dev)
        blocks = [MoEBlock(cfg.d_model, cfg.nhead, cfg.d_ff, cfg.n_experts,
                           cfg.top_k, cfg.capacity_factor, cfg.dropout,
                           cfg.causal, ep_axis=ep_axis, mesh=mesh,
                           device=dev, generator=generator)
                  for _ in range(cfg.n_layers)]
        decoder = Decoder(cfg.d_model, cfg.vocab, generator=generator,
                          device=dev)
        PipelinedTransformer.__init__(self, cfg, n_stages, embed, blocks,
                                      decoder)
        self.posenc = posenc
        self.ep_axis = self.tp_axis = ep_axis

    @property
    def mesh(self):
        return self.blocks[0].mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        for blk in self.blocks:
            blk.mesh = mesh

    def stage_param_specs(self):
        """Specs for ONE stage's params (a list of per-layer block trees);
        the executors apply it to every stage."""
        return [moe_block_specs() for _ in range(self.layers_per_stage)]
