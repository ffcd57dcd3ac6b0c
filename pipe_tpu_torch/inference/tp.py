"""Tensor-parallel decoding: serve Megatron-sharded weights as trained.

Counterpart of ``pipe_tpu/inference/tp.py``. A model whose blocks shard over
the mesh's ``model`` axis (heads and FFN columns, ``ops/tp_layers.py``)
decodes with the same split: each rank of a model line projects q, k and v
for its heads, keeps a head-sharded KV cache (cache memory divides by tp
like the weights), attends locally, and the block's two all-reduces
(attention output projection, FFN second matmul) are the only per-layer
communication, the training forward's structure, so serving needs no weight
conversion and no resharding.

:class:`TPShardedGenerator` is the one-device
:class:`~.generate.Generator` run on every rank of the line: its prefill,
decode and beam loops run unchanged (``TPBlock.decode`` all-reduces over the
rank's model line), and only the cache size (the local head count) and the
weights (cut to the rank's shard on entry) differ. The logits come off the
replicated head after each block's all-reduce, equal on every rank of the
line, so greedy and beam search pick alike there, and sampling draws from a
``torch.Generator`` seeded alike on every rank: every rank returns the same
tokens, and a seed gives the one-device ``Generator``'s stream except where
the logits' rounding differs. The decode attention is plain: this path
launches no kernel.

The MoE family (:class:`~pipe_tpu_torch.models.moe_lm.MoEPipelinedLM`)
decodes the same way: its experts shard over the model line with the heads
(``moe_block_decode`` routes per token, so the dense dispatch works
unchanged at one token a row), its nested ``moe.*`` leaves cut by the same
specs, and each MoE layer adds two all-reduces (the router's logits, the
experts' outputs) to the attention's one.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import MODEL_AXIS, flat_specs, shard_params
from .generate import GenerationConfig, Generator

__all__ = ["TPShardedGenerator"]


class TPShardedGenerator(Generator):
    """KV-cached decoding over model-axis-sharded weights.

    ``mesh``: the rank's mesh, with a model axis; ``model``: a
    :class:`~pipe_tpu_torch.models.tp_lm.TPPipelinedLM` built with
    ``tp_axis=MODEL_AXIS`` or a
    :class:`~pipe_tpu_torch.models.moe_lm.MoEPipelinedLM` built with
    ``ep_axis=MODEL_AXIS``, holding every weight on the rank's device,
    whole or already cut to this rank's shard (its sharded leaves are cut
    here, by ``model.stage_param_specs()``). Every rank of the line calls
    :meth:`generate` with the whole prompt and returns the tokens. Beam
    search works over the sharded weights too: the log-probs are
    replicated, and the per-step cache reorder gathers on the batch axis,
    which the head-sharded caches keep whole.
    """

    def __init__(self, mesh, model,
                 gen_cfg: GenerationConfig = GenerationConfig()):
        if mesh is None or MODEL_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {MODEL_AXIS!r} axis")
        if getattr(model, "tp_axis", None) != MODEL_AXIS:
            raise ValueError(
                "TPShardedGenerator needs a model built with "
                f"tp_axis={MODEL_AXIS!r} (got "
                f"{getattr(model, 'tp_axis', None)!r})")
        self.mesh = mesh
        self.tp = mesh.n_model
        if model.cfg.nhead % self.tp:
            raise ValueError(f"nhead={model.cfg.nhead} must divide over "
                             f"tp={self.tp}")
        n_experts = getattr(model.cfg, "n_experts", None)
        if n_experts is not None and n_experts % self.tp:
            from ..ops.moe import _experts_refused
            raise _experts_refused(n_experts, self.tp)
        super().__init__(model, gen_cfg)
        model.mesh = mesh
        specs = {}
        for layer in model.stage_param_specs():
            specs.update(flat_specs(layer))
        for blk in model.blocks:
            shard_params(blk, specs, mesh)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

