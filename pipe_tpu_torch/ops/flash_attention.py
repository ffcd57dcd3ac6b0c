"""Flash attention forward: a hand-written CUDA kernel for Hopper, and its
plain PyTorch version.

Counterpart of ``pipe_tpu/ops/pallas_attention.py``. The kernel
(``csrc/flash_attn_fwd.cu``) replaces the Pallas forward ``_fwd_kernel``:
over ``[batch*head, seq, head_dim]`` views it streams K/V tiles through shared
memory under an online softmax and returns O and the per-row logsumexp ``L``
``[batch*head, 1, seq]``, never storing the ``seq x seq`` scores.

:func:`flash_attention_fwd` is the kernel's wrapper. For CPU tensors it runs
:func:`flash_attention_ref`, the plain version; for CUDA tensors it launches
the kernel or raises. It counts its launches in ``flash_attention_fwd.launches``.
The backward kernels and in-kernel dropout of the Pallas module arrive with the
training slice: until then a call that needs a gradient, or asks for dropout,
raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "supports", "MAX_HEAD_DIM"]

_SOURCE = "flash_attn_fwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel keeps a quarter of each output row in registers per thread; it
# is instantiated for head dims up to this (every model here has head dim 64).
MAX_HEAD_DIM = 128

_NO_GRAD = ("flash attention has no backward kernel yet: backward kernels "
            "arrive with the training slice")


def supports(seq_len: int, *, block: int = 128, min_tile: int = 8) -> bool:
    """Whether ``flash_attention`` takes this sequence length (the same rule
    as the Pallas kernel's): rows in multiples of ``min_tile`` and a block
    tiling that covers the sequence exactly (a block >= seq is one block)."""
    if seq_len < min_tile or seq_len % min_tile:
        return False
    return block >= seq_len or seq_len % block == 0


def flash_attention_ref(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: explicit scores, mask, logsumexp
    and softmax in float32. ``[bh, s, d]`` in; ``(o [bh, s, d] in q3's dtype,
    lse [bh, 1, s] float32)`` out, with the kernel's -inf handling."""
    s = q3.shape[1]
    scores = torch.matmul(q3.float() * scale, k3.float().transpose(1, 2))
    if causal:
        pos = torch.arange(s, device=q3.device)
        scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    finite_m = torch.isfinite(m)
    safe_m = torch.where(finite_m, m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(scores), torch.exp(scores - safe_m),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v3.float()) / l
    lse = safe_m + torch.log(l)
    return o.to(q3.dtype), lse.transpose(1, 2).contiguous()


def _check(q3, k3, v3):
    if q3.dim() != 3 or q3.shape != k3.shape or q3.shape != v3.shape:
        raise ValueError(
            f"flash attention takes q, k, v of one [bh, s, d] shape, got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise TypeError("q, k and v must share a dtype")
    if not (q3.device == k3.device == v3.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        *, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper on ``[bh, s, d]``: ``(o, lse [bh, 1, s])``.

    CPU tensors run :func:`flash_attention_ref`; CUDA tensors launch the
    kernel (contiguous float32 or bfloat16, head dim up to
    :data:`MAX_HEAD_DIM`) or raise.
    """
    _check(q3, k3, v3)
    if torch.is_grad_enabled() and (q3.requires_grad or k3.requires_grad
                                    or v3.requires_grad):
        raise NotImplementedError(_NO_GRAD)
    if q3.device.type == "cpu":
        return flash_attention_ref(q3, k3, v3, causal, scale)
    if q3.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q3.device.type}")
    if q3.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, "
                        f"not {q3.dtype}")
    bh, s, d = q3.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if not (q3.is_contiguous() and k3.is_contiguous() and v3.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous [bh, s, d] tensors")
    lib = _lib()
    o = torch.empty_like(q3)
    lse = torch.empty((bh, 1, s), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = lib.pipe_flash_attn_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, int(bool(causal)), float(scale),
            _DTYPE_CODES[q3.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"{lib.pipe_cuda_error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .. import _build
    lib = _build.load(_SOURCE)
    fn = lib.pipe_flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.pipe_cuda_error_string.restype = ctypes.c_char_p
    lib.pipe_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    dropout_rate: float = 0.0) -> torch.Tensor:
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs.

    Takes and refuses the shapes the Pallas ``flash_attention`` does: gate
    with :func:`supports` and use ``ops.layers.dot_product_attention``
    otherwise. ``block_q``/``block_k`` only decide which lengths are taken;
    the kernel tiles by its own sizes, and the causal mask compares absolute
    positions, so the result does not depend on them.
    """
    b, s, h, d = q.shape
    if not supports(s, block=min(block_q, block_k)):
        raise ValueError(
            f"flash_attention: seq_len {s} not divisible into blocks; "
            f"use ops.layers.dot_product_attention")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention dropout is not in the kernel yet: it arrives "
            "with the training slice; use ops.layers.dot_product_attention")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    bq = min(block_q, s)
    bk = min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(
            f"flash_attention: seq_len {s} must be divisible by block_q={bq} "
            f"and block_k={bk}; use ops.layers.dot_product_attention")

    def to3(x):  # [b, s, h, d] -> [b*h, s, d]
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    o3, _ = flash_attention_fwd(to3(q), to3(k), to3(v), causal=causal,
                                scale=scale)
    return o3.reshape(b, h, s, d).transpose(1, 2)
