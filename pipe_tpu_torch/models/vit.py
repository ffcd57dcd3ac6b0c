"""The Vision Transformer family, pipelined.

Counterpart of ``pipe_tpu/models/vit.py`` (BASELINE.json config #5: 8-stage
ViT-L/16, chunks=8, non-LM shapes, uneven stage balance). Patchify by
reshape (``[b, H, W, C] -> [b, (H/p)(W/p), p·p·C]``) and a linear
projection, a class token and learned positions, pre-LN GELU blocks
(:class:`~pipe_tpu_torch.ops.layers.PreLNBlock`, ``causal=False``), a final
LayerNorm and a classifier over the class token.

What it brings that the LMs do not: 4-D image inputs micro-batched by
``scatter``/``stack_scatter``; integer class labels with one loss per row;
an uneven ``Pipe`` balance; and 197 tokens (196 patches + the class token at
224 / 16), which the flash kernels' tiling does not take (``supports()``),
so every block runs plain attention, as ``pipe_tpu``'s Pallas gate chooses
there.

:func:`build_sequential` is the layer list for ``Pipe``;
:class:`PipelinedViT` is embed | ``n_layers / n_stages`` blocks per stage |
head over the same modules. Every constructor takes ``device=`` (the card by
default) and a ``torch.Generator`` that draws the weights.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..core.partition import StageCtx
from ..ops.layers import (Dropout, LayerNorm, Linear, PreLNBlock, Sequential,
                          _generator)
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .common import PipelinedTransformer, per_row_ce

__all__ = ["ViTConfig", "PatchEmbed", "ViTHead", "build_sequential",
           "PipelinedViT"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT-L/16 by default (24 layers, d=1024, 16 heads, patch 16)."""

    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_classes: int = 1000
    d_model: int = 1024
    nhead: int = 16
    d_ff: int = 4096
    n_layers: int = 24
    dropout: float = 0.1
    compute_dtype: torch.dtype = torch.float32   # activations (weights: f32)
    attn_impl: str = "auto"                      # auto | xla | flash

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_tokens(self) -> int:
        return self.n_patches + 1  # + class token

    def tiny(self) -> "ViTConfig":
        return dataclasses.replace(
            self, image_size=16, patch_size=4, n_classes=11, d_model=16,
            nhead=2, d_ff=64, n_layers=4, dropout=0.0)


class PatchEmbed(nn.Module):
    """Patchify + project + class token + learned positions (``cls`` and
    ``pos`` N(0, 0.02²)) + dropout; the output is in the compute dtype."""

    def __init__(self, cfg: ViTConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            raise ValueError(f"image {cfg.image_size} not divisible by patch "
                             f"{cfg.patch_size}")
        dev = resolve_device(device)
        gen = _generator(generator, dev)
        self.cfg = cfg
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
        self.proj = Linear(patch_dim, cfg.d_model, device=dev, generator=gen)
        cls = torch.empty((1, 1, cfg.d_model), device=dev)
        pos = torch.empty((cfg.n_tokens, cfg.d_model), device=dev)
        self.cls = nn.Parameter(cls.normal_(0.0, 0.02, generator=gen))
        self.pos = nn.Parameter(pos.normal_(0.0, 0.02, generator=gen))
        self.drop = Dropout(cfg.dropout)

    def forward(self, images, ctx: StageCtx = StageCtx()):
        cfg = self.cfg
        b = images.shape[0]
        p, g = cfg.patch_size, cfg.image_size // cfg.patch_size
        x = images.reshape(b, g, p, g, p, cfg.channels)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g,
                                                p * p * cfg.channels)
        h = self.proj(x.to(self.proj.weight.dtype), ctx=ctx)
        cls = self.cls.to(h.dtype).expand(b, 1, cfg.d_model)
        h = torch.cat([cls, h], dim=1) + self.pos.to(h.dtype)
        return self.drop(h, ctx=ctx).to(cfg.compute_dtype)


class ViTHead(nn.Module):
    """Final LayerNorm + linear classifier over the class token, in the
    classifier's dtype."""

    def __init__(self, cfg: ViTConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.ln = LayerNorm(cfg.d_model, device=device)
        self.proj = Linear(cfg.d_model, cfg.n_classes, device=device,
                           generator=generator)

    def forward(self, h, ctx: StageCtx = StageCtx()):
        h = self.ln(h.to(self.proj.weight.dtype), ctx=ctx)
        return self.proj(h[..., 0, :], ctx=ctx)


def build_sequential(cfg: ViTConfig, *, device=DEFAULT_DEVICE,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequential:
    """Patch embed + ``n_layers`` pre-LN blocks + head as one ``Sequential``
    on ``device``, with float32 weights drawn from ``generator`` (a fresh one
    seeded 0 if None) in layer order."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    layers: List[nn.Module] = [PatchEmbed(cfg, device=dev, generator=gen)]
    layers += [PreLNBlock(cfg.d_model, cfg.nhead, cfg.d_ff, cfg.dropout,
                          causal=False, attn_impl=cfg.attn_impl, device=dev,
                          generator=gen) for _ in range(cfg.n_layers)]
    layers.append(ViTHead(cfg, device=dev, generator=gen))
    return Sequential(layers)


class PipelinedViT(PipelinedTransformer):
    """patch embed | ``n_layers / n_stages`` blocks per stage | head, over
    the modules :func:`build_sequential` builds, with the per-row loss
    :meth:`loss_post_fn` against integer labels."""

    input_key = "images"

    def __init__(self, cfg: ViTConfig, n_stages: int = 1, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        layers = list(build_sequential(cfg, device=device,
                                       generator=generator))
        super().__init__(cfg, n_stages, layers[0], layers[1:-1], layers[-1])

    def loss_post_fn(self, h, x_mb, ctx: StageCtx = StageCtx()):
        """Per-row softmax cross-entropy ``[mb_rows]`` of the head's logits
        against ``x_mb["labels"]``."""
        return per_row_ce(self.head(h, ctx=ctx), x_mb["labels"])
