"""Tensor-parallel Transformer LM: the PP x TP x DP factorization.

Counterpart of ``pipe_tpu/models/tp_lm.py``: the tutorial LM's embed |
k blocks per stage | decoder factorization (:class:`PipelinedLM`'s embed,
positions, loss and key schedule), with the Megatron-split block of
:mod:`~pipe_tpu_torch.ops.tp_layers`, whose head and FFN dims shard over the
mesh's ``model`` axis. :meth:`TPPipelinedLM.stage_param_specs` gives the
executors the per-leaf ``PartitionSpec``s of one stage, so each rank holds
``1 / (n_stages * tp)`` of the block weights once they are cut. The embed
and the decoder stay replicated over the model axis.

Where JAX binds the model axis by name inside ``shard_map``, the blocks here
read the rank's ``mesh`` (as ``ContextParallelLM`` does): without one, or
with a model line of one, the block runs the unsharded math.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.partition import StageCtx
from ..ops.layers import Decoder, Embedding, PositionalEncoding
from ..ops.tp_layers import (TP_YS, TPBlock, tp_block_specs, tp_block_tapped,
                             tp_block_wgrad)
from ..parallel.mesh import MODEL_AXIS
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .common import PipelinedTransformer
from .transformer_lm import LMConfig, PipelinedLM

__all__ = ["TPPipelinedLM", "tp_split_backward_stage"]


class TPPipelinedLM(PipelinedLM):
    """embed | k TP blocks per stage | decoder, over (stage, data, model).

    The factorization, embed/posenc/loss path and key schedule of
    :class:`PipelinedLM`; only the block differs (:class:`TPBlock`, whole
    parameters until ``parallel.mesh.shard_params`` cuts them).
    ``tp_axis=None`` runs the same math unsharded (the transparency
    yardstick). ``mesh``: the rank's mesh, whose model line the blocks
    all-reduce over (settable later: :attr:`mesh`). Weights are drawn from
    ``generator`` (seeded 0 if None) in module order: embedding, blocks,
    decoder.
    """

    def __init__(self, cfg: LMConfig, n_stages: int = 1,
                 tp_axis: Optional[str] = MODEL_AXIS, *, mesh=None,
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
        blocks = [TPBlock(cfg.d_model, cfg.nhead, cfg.d_ff, cfg.dropout,
                          cfg.causal, tp_axis=tp_axis, mesh=mesh,
                          device=dev, generator=generator)
                  for _ in range(cfg.n_layers)]
        decoder = Decoder(cfg.d_model, cfg.vocab, generator=generator,
                          device=dev)
        PipelinedTransformer.__init__(self, cfg, n_stages, embed, blocks,
                                      decoder)
        self.posenc = posenc
        self.tp_axis = tp_axis

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
        return [tp_block_specs() for _ in range(self.layers_per_stage)]


def tp_split_backward_stage(model: TPPipelinedLM):
    """A :class:`~pipe_tpu_torch.parallel.scheduled.SplitBackwardStage` for
    the stages of ``model`` (unsharded math: the split refuses
    ``stage_param_specs``, as ``pipe_tpu``'s does): the tapped forward of
    each layer with its parameters detached chains, its ``ys`` and taps
    per layer, and W is the per-layer weight-gradient contractions, cast
    to the parameters' dtype. The key folding is ``stage_fn``'s
    (``ctx.fold(l)`` a layer), so dropout is the plain path's bit for bit.
    ``pipe_tpu`` takes the config and gets the params from the executor;
    here the modules hold the weights, so it takes the model."""
    from ..parallel.scheduled import SplitBackwardStage

    cfg = model.cfg
    cd = cfg.compute_dtype

    def tapped_fn(s: int, h, ctx: StageCtx = StageCtx()):
        ys_all, taps_all = [], []
        for l, blk in enumerate(model.stage_blocks(s)):
            blk.model_line()            # whole heads, no line: checked
            h, ys, taps = tp_block_tapped(blk.tree(cd, detach=True), h,
                                          ctx.fold(l), dropout=cfg.dropout,
                                          causal=cfg.causal)
            ys_all += [ys[k] for k in TP_YS]
            taps_all.append((blk, taps, [(ys[k].shape, ys[k].dtype)
                                         for k in TP_YS]))
        return h, ys_all, taps_all

    def wgrad_fn(s: int, taps, g_ys):
        pairs, k = [], 0
        for blk, t, shapes in taps:
            gzs = {}
            for name, (shape, dtype), g in zip(TP_YS, shapes,
                                               g_ys[k:k + len(TP_YS)]):
                gzs[name] = (g if g is not None else
                             torch.zeros(shape, dtype=dtype,
                                         device=t["hn"].device))
            k += len(TP_YS)
            grads = tp_block_wgrad(t, gzs)
            for name, p in blk.named_parameters():
                node = grads
                for key in name.split("."):
                    node = node[key]
                pairs.append((p, node.to(p.dtype)))
        return pairs

    return SplitBackwardStage(tapped_fn=tapped_fn, wgrad_fn=wgrad_fn)
