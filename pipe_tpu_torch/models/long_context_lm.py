"""Long-context Transformer LM: pipeline stages x context shards.

Counterpart of ``pipe_tpu/models/long_context_lm.py``. The sequence axis is
sharded over the mesh's ``context`` axis inside every pipeline stage: the
stage boundaries move over the stage column, and each block's attention is
exact over the global sequence through the K/V ring (``sp_impl="ring"``,
``ops/ring_attention.py``) or the Ulysses all-to-all (``"ulysses"``,
``ops/ulysses_attention.py``, where the flash kernels run unsharded; needs
``nhead % n_context == 0``). Activations are ``[rows, seq_local, d_model]``.

The modules and weights are the tutorial LM's (:class:`ContextParallelLM`
is a :class:`~.transformer_lm.PipelinedLM`, as JAX's ``init`` is
``PipelinedLM.init``), so ``convert.load_pipelined_lm`` and
``convert.load_ring_stage`` carry ``pipe_tpu``'s params. Where JAX reads the
bound axis names (``axis_index``, ``pmean``), this model reads its
``mesh``: without one (or without a context axis) the shard is the whole
sequence, at offset 0, and the loss is not reduced. Dropout is omitted on
this path, as in JAX, to keep the ring exact.

Run it with ``SpmdPipeline(..., context_axis="context")`` or
``ScheduledPipeline(..., context_axis="context")`` over ``make_mesh(S, D,
n_context=C)``, so the token and target leaves arrive sequence-sharded.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.partition import StageCtx
from ..parallel.mesh import context_pmean
from ..utils.platform import DEFAULT_DEVICE
from .common import per_row_ce
from .transformer_lm import LMConfig, PipelinedLM

__all__ = ["ContextParallelLM", "block_qkv", "block_post_attention"]


def block_qkv(blk, h: torch.Tensor):
    """A ``TransformerEncoderLayer``'s q, k and v of ``h [rows, s, d]``,
    each ``[rows, s, heads, head_dim]``."""
    rows, s, d = h.shape
    nh = blk.attn.nhead
    return tuple(lin(h).view(rows, s, nh, d // nh)
                 for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv))


def block_post_attention(blk, h: torch.Tensor, a: torch.Tensor):
    """The rest of the block after its attention ``a [rows, s, heads,
    head_dim]``: the output projection, add and norm, the feed-forward,
    add and norm (no dropout)."""
    rows, s, d = h.shape
    x = blk.ln1(h + blk.attn.wo(a.reshape(rows, s, d)))
    return blk.ln2(x + blk.ff2(blk.act(blk.ff1(x))))


class ContextParallelLM(PipelinedLM):
    """Embed | k context-parallel blocks per stage | loss, all
    context-sharded (module docstring). ``mesh``: the rank's mesh (None on
    one device)."""

    def __init__(self, cfg: LMConfig, n_stages: int = 1,
                 sp_impl: str = "ring", *, mesh=None,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        _check(cfg, n_stages, sp_impl)
        super().__init__(cfg, n_stages, device=device, generator=generator)
        self.sp_impl = sp_impl
        self.mesh = mesh

    @classmethod
    def from_sequential(cls, cfg: LMConfig, seq, n_stages: int = 1,
                        sp_impl: str = "ring", *, mesh=None
                        ) -> "ContextParallelLM":
        """Wrap the modules of a ``build_sequential`` LM with no copy
        (``PipelinedLM.from_sequential``)."""
        _check(cfg, n_stages, sp_impl)
        model = super().from_sequential(cfg, seq, n_stages)
        model.sp_impl = sp_impl
        model.mesh = mesh
        return model

    def _offset(self, s_local: int) -> int:
        """The global position of this rank's first token."""
        return 0 if self.mesh is None else self.mesh.context * s_local

    def pre_fn(self, x_mb, ctx: StageCtx = StageCtx()):
        tokens = x_mb[self.input_key] if isinstance(x_mb, dict) else x_mb
        h = self.embed(tokens)
        s = tokens.shape[-1]
        off = min(self._offset(s), self.posenc.pe.shape[0] - s)
        return (h + self.posenc.pe[off:off + s]).to(self.cfg.compute_dtype)

    def _attention(self, q, k, v):
        if self.sp_impl == "ulysses":
            from ..ops.ulysses_attention import ulysses_attention
            return ulysses_attention(q, k, v, self.mesh,
                                     causal=self.cfg.causal)
        from ..ops.ring_attention import ring_attention
        return ring_attention(q, k, v, self.mesh, causal=self.cfg.causal)

    def block(self, blk, h: torch.Tensor) -> torch.Tensor:
        """``TransformerEncoderLayer``'s math with the attention swapped for
        the context-parallel one and no dropout."""
        q, k, v = block_qkv(blk, h)
        return block_post_attention(blk, h, self._attention(q, k, v))

    def stage_fn(self, s: int, h, ctx: StageCtx = StageCtx()):
        for blk in self.stage_blocks(s):
            h = self.block(blk, h)
        return h

    def loss_post_fn(self, h, x_mb, ctx: StageCtx = StageCtx()):
        """Per-row mean token cross-entropy over the global sequence: this
        shard's mean, averaged over the context line."""
        logits = self.decoder(h.to(torch.float32))
        return context_pmean(self.mesh, per_row_ce(logits, x_mb["targets"]))


def _check(cfg: LMConfig, n_stages: int, sp_impl: str) -> None:
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                         f"n_stages={n_stages}")
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"sp_impl must be ring|ulysses, got {sp_impl!r}")
