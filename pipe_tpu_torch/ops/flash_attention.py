"""Flash attention: hand-written CUDA kernels for Hopper, their plain PyTorch
versions, and the autograd ``Function`` that joins them.

Counterpart of ``pipe_tpu/ops/pallas_attention.py``. Three kernels replace the
three Pallas kernels, over ``[batch*head, seq, head_dim]`` views:

* ``csrc/flash_attn_fwd.cu`` (``_fwd_kernel``): O and the per-row logsumexp
  ``L`` ``[batch*head, 1, seq]``, K/V streamed through shared memory under an
  online softmax, the ``seq x seq`` scores never stored;
* ``csrc/flash_attn_bwd.cu`` (``_bwd_dq_kernel``) and
  ``csrc/flash_attn_bwd_dkv.cu`` (``_bwd_dkv_kernel``): dQ per query tile and
  dK/dV per key tile, each rebuilding ``p = exp(s - L)``;
  ``D = rowsum(dO * O)`` is a torch op before them, as the JAX package computes
  it outside Pallas;
* attention-weight dropout inside all three (``_drop_mask``): a Philox4x32-10
  keep mask (``csrc/philox.cuh``, and :func:`philox4x32` here) that is a
  function of (seed, batch*head, query position, key position) only, so the
  backward kernels regenerate the forward's mask from the seed whatever their
  tiling. The normaliser is taken before dropout, as in Pallas.

Each kernel has a wrapper with a launch counter (``.launches``):
:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq` and
:func:`flash_attention_bwd_dkv`. For CPU tensors a wrapper runs the plain
version (:func:`flash_attention_ref`, :func:`flash_attention_bwd_dq_ref`,
:func:`flash_attention_bwd_dkv_ref`), with the mask from :func:`dropout_keep`;
for CUDA tensors it launches the kernel or raises. :func:`flash_attention`
runs them under a ``torch.autograd.Function`` when a gradient is needed.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq_ref", "flash_attention_bwd_dkv_ref",
           "flash_attention_bwd_ref", "attention_delta", "philox4x32",
           "keep_bits", "dropout_keep", "supports", "MAX_HEAD_DIM"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels keep their owned rows' accumulators in registers; they are
# instantiated for head dims up to this (every model here has head dim 64).
MAX_HEAD_DIM = 128

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def supports(seq_len: int, *, block: int = 128, min_tile: int = 8) -> bool:
    """Whether ``flash_attention`` takes this sequence length (the same rule
    as the Pallas kernel's): rows in multiples of ``min_tile`` and a block
    tiling that covers the sequence exactly (a block >= seq is one block)."""
    if seq_len < min_tile or seq_len % min_tile:
        return False
    return block >= seq_len or seq_len % block == 0


# --- Philox keep mask ----------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``a * m`` for ``a`` holding uint32 values in an
    int64 tensor. The product is taken in 16-bit halves, so that every
    intermediate stays below 2**35 and no int64 overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid1, mid2 = a_hi * m_lo, a_lo * m_hi
    t = a_lo * m_lo + ((mid1 & 0xFFFF) << 16) + ((mid2 & 0xFFFF) << 16)
    hi = (a_hi * m_hi + (mid1 >> 16) + (mid2 >> 16) + (t >> 32)) & _MASK32
    return hi, t & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter ``(c0, c1, c2, c3)`` (int64 tensors of
    uint32 values, broadcast together) under the key ``(k0, k1)`` (uint32
    ints, or int64 tensors that broadcast with the counter): the four
    output words, as ``csrc/philox.cuh`` computes them."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in (c0, c1, c2, c3)]
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def _seed_key(seed: int) -> Tuple[int, int]:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"dropout seed must be in [0, 2**64), got {seed}")
    return seed & _MASK32, seed >> 32


def keep_bits(seed: int, bh, q, k) -> torch.Tensor:
    """The random word of each (batch*head, query, key) position, broadcast
    from int64 index tensors: word ``k % 4`` of Philox4x32-10 at counter
    ``(k // 4, q, bh, 0)`` under key ``(seed low, seed high 32 bits)``."""
    k = torch.as_tensor(k, dtype=torch.int64)
    words = philox4x32(k >> 2, q, bh, torch.zeros_like(k), *_seed_key(seed))
    sel = k & 3
    out = words[3]
    for w in (2, 1, 0):
        out = torch.where(sel == w, words[w], out)
    return out


def _threshold(rate: float) -> int:
    """The Pallas keep rule: kept when bits >= this."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def dropout_keep(seed: int, rate: float, bh: int, s: int, *,
                 device=None) -> torch.Tensor:
    """Keep-scale mask ``[bh, s, s]`` float32 of attention dropout at
    ``rate``: ``1 / (1 - rate)`` where the pair is kept, 0 where dropped —
    the factor the three kernels apply for the same seed."""
    pos = torch.arange(s, dtype=torch.int64, device=device)
    bits = keep_bits(seed, torch.arange(bh, device=device)[:, None, None],
                     pos[None, :, None], pos[None, None, :])
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32,
                       device=device)
    return torch.where(bits >= _threshold(rate), scale, torch.zeros_like(scale))


def _keep(seed: int, rate: float, q3: torch.Tensor) -> Optional[torch.Tensor]:
    if rate <= 0.0:
        return None
    bh, s, _ = q3.shape
    return dropout_keep(seed, rate, bh, s, device=q3.device)


# --- plain versions ------------------------------------------------------------

def _scores(q3, k3, causal, scale):
    s = q3.shape[1]
    scores = torch.matmul(q3.float() * scale, k3.float().transpose(1, 2))
    if causal:
        pos = torch.arange(s, device=q3.device)
        scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    return scores


def flash_attention_ref(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        causal: bool, scale: float,
                        keep: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: explicit scores, mask,
    logsumexp and softmax in float32. ``[bh, s, d]`` in; ``(o [bh, s, d] in
    q3's dtype, lse [bh, 1, s] float32)`` out, with the kernel's -inf
    handling. ``keep`` (``[bh, s, s]``, or None) multiplies the probabilities
    after the normaliser has taken them, as dropout does in the kernel."""
    scores = _scores(q3, k3, causal, scale)
    m = scores.amax(dim=-1, keepdim=True)
    finite_m = torch.isfinite(m)
    safe_m = torch.where(finite_m, m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(scores), torch.exp(scores - safe_m),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if keep is not None:
        p = p * keep
    o = torch.matmul(p, v3.float()) / l
    lse = safe_m + torch.log(l)
    return o.to(q3.dtype), lse.transpose(1, 2).contiguous()


def attention_delta(o3: torch.Tensor, do3: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * O)`` in float32, ``[bh, 1, s]`` like ``L``."""
    return (do3.float() * o3.float()).sum(dim=-1)[:, None, :].contiguous()


def _bwd_terms(q3, k3, v3, do3, lse, delta, causal, scale, keep):
    """``(p * keep, ds)`` of the Pallas backward kernels, ``[bh, s, s]``."""
    scores = _scores(q3, k3, causal, scale)
    p = torch.where(torch.isfinite(scores),
                    torch.exp(scores - lse.transpose(1, 2)),
                    torch.zeros_like(scores))
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    pk = p
    if keep is not None:
        dp = dp * keep
        pk = p * keep
    return pk, p * (dp - delta.transpose(1, 2))


def flash_attention_bwd_dq_ref(q3, k3, v3, do3, lse, delta, *, causal: bool,
                               scale: float,
                               keep: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of the dQ kernel: ``scale * ds K`` in q3's dtype."""
    _, ds = _bwd_terms(q3, k3, v3, do3, lse, delta, causal, scale, keep)
    return (torch.matmul(ds, k3.float()) * scale).to(q3.dtype)


def flash_attention_bwd_dkv_ref(q3, k3, v3, do3, lse, delta, *, causal: bool,
                                scale: float,
                                keep: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: ``(ds^T (scale Q), (p keep)^T dO)``
    in k3's and v3's dtypes."""
    pk, ds = _bwd_terms(q3, k3, v3, do3, lse, delta, causal, scale, keep)
    dk = torch.matmul(ds.transpose(1, 2), q3.float() * scale)
    dv = torch.matmul(pk.transpose(1, 2), do3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_ref(q3, k3, v3, o3, lse, do3, *, causal: bool,
                            scale: float, keep: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The whole backward in the kernels' decomposition, without autograd:
    ``D`` from O and dO, then dQ and dK/dV. Returns ``(dq, dk, dv)``."""
    delta = attention_delta(o3, do3)
    kw = dict(causal=causal, scale=scale, keep=keep)
    dq = flash_attention_bwd_dq_ref(q3, k3, v3, do3, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_ref(q3, k3, v3, do3, lse, delta, **kw)
    return dq, dk, dv


# --- kernel wrappers -------------------------------------------------------------

def _check(*ts):
    """q, k, v (and dO) of one ``[bh, s, d]`` shape, dtype and device."""
    shape = ts[0].shape
    if ts[0].dim() != 3 or any(t.shape != shape for t in ts):
        raise ValueError(
            f"flash attention takes q, k, v of one [bh, s, d] shape, got "
            f"{', '.join(str(tuple(t.shape)) for t in ts)}")
    if any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError("q, k, v and dO must share a dtype")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("q, k, v and dO must be on one device")
    if ts[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{ts[0].device.type}")


def _check_cuda(ts, stats=()):
    """What the kernels take: contiguous float32/bfloat16 ``[bh, s, d]`` with
    d up to :data:`MAX_HEAD_DIM`, and contiguous float32 ``[bh, 1, s]`` row
    statistics."""
    if ts[0].dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32 or bfloat16, "
                        f"not {ts[0].dtype}")
    bh, s, d = ts[0].shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the flash kernels take contiguous [bh, s, d] tensors")
    for st in stats:
        if (st.dtype != torch.float32 or tuple(st.shape) != (bh, 1, s)
                or not st.is_contiguous() or st.device != ts[0].device):
            raise ValueError(f"row statistics must be contiguous float32 "
                             f"[{bh}, 1, {s}] on {ts[0].device}")


def _dropout_args(seed: int, rate: float):
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed), _threshold(rate), 1.0 / (1.0 - rate)


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.pipe_cuda_error_string(err).decode()}")


_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
                  ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    from .. import _build
    lib = _build.load(source)
    entry = {"flash_attn_fwd.cu": {"pipe_flash_attn_fwd": 5},
             "flash_attn_bwd.cu": {"pipe_flash_attn_bwd_dq": 7},
             "flash_attn_bwd_dkv.cu": {"pipe_flash_attn_bwd_dkv": 8}}[source]
    for name, n_ptrs in entry.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        # pointers, then bh, s, d, causal, scale, then dtype and dropout.
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
                       + [ctypes.c_float] + _DROP_ARGTYPES)
    lib.pipe_cuda_error_string.restype = ctypes.c_char_p
    lib.pipe_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(source: str, name: str, ptrs, q3, causal, scale, seed, rate):
    lib = _lib(source)
    bh, s, d = q3.shape
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = getattr(lib, name)(
            *[t.data_ptr() for t in ptrs], bh, s, d, int(bool(causal)),
            float(scale), _DTYPE_CODES[q3.dtype], *_dropout_args(seed, rate),
            stream)
    _raise_on(err, lib, name)


def flash_attention_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        *, causal: bool, scale: float, seed: int = 0,
                        rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's wrapper on ``[bh, s, d]``: ``(o, lse [bh, 1, s])``,
    with attention dropout at ``rate`` from ``seed``.

    CPU tensors run :func:`flash_attention_ref` (mask from
    :func:`dropout_keep`); CUDA tensors launch the kernel (contiguous float32
    or bfloat16, head dim up to :data:`MAX_HEAD_DIM`) or raise.
    """
    _check(q3, k3, v3)
    if q3.device.type == "cpu":
        return flash_attention_ref(q3, k3, v3, causal, scale,
                                   _keep(seed, rate, q3))
    _check_cuda((q3, k3, v3))
    bh, s, _ = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, 1, s), dtype=torch.float32, device=q3.device)
    _launch("flash_attn_fwd.cu", "pipe_flash_attn_fwd", (q3, k3, v3, o, lse),
            q3, causal, scale, seed, rate)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, *, causal: bool,
                           scale: float, seed: int = 0,
                           rate: float = 0.0) -> torch.Tensor:
    """The dQ kernel's wrapper: dQ ``[bh, s, d]`` from q, k, v, dO and the row
    statistics ``lse`` and ``delta`` (``[bh, 1, s]`` float32). The seed and
    rate must be the forward's. CPU tensors run
    :func:`flash_attention_bwd_dq_ref`; CUDA tensors launch or raise."""
    _check(q3, k3, v3, do3)
    if q3.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q3, k3, v3, do3, lse, delta,
                                          causal=causal, scale=scale,
                                          keep=_keep(seed, rate, q3))
    _check_cuda((q3, k3, v3, do3), (lse, delta))
    dq = torch.empty_like(q3)
    _launch("flash_attn_bwd.cu", "pipe_flash_attn_bwd_dq",
            (q3, k3, v3, do3, lse, delta, dq), q3, causal, scale, seed, rate)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, *, causal: bool,
                            scale: float, seed: int = 0, rate: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's wrapper: ``(dk, dv)``, arguments as for
    :func:`flash_attention_bwd_dq`. CPU tensors run
    :func:`flash_attention_bwd_dkv_ref`; CUDA tensors launch or raise."""
    _check(q3, k3, v3, do3)
    if q3.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q3, k3, v3, do3, lse, delta,
                                           causal=causal, scale=scale,
                                           keep=_keep(seed, rate, q3))
    _check_cuda((q3, k3, v3, do3), (lse, delta))
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch("flash_attn_bwd_dkv.cu", "pipe_flash_attn_bwd_dkv",
            (q3, k3, v3, do3, lse, delta, dk, dv), q3, causal, scale, seed,
            rate)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The Pallas ``custom_vjp``: the forward saves q, k, v, O, L and the
    dropout seed; the backward computes D and runs the two backward kernels,
    which regenerate the forward's mask from the seed."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale, seed, rate):
        o3, lse = flash_attention_fwd(q3, k3, v3, causal=causal, scale=scale,
                                      seed=seed, rate=rate)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.args = dict(causal=causal, scale=scale, seed=seed, rate=rate)
        return o3

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        do3 = do3.contiguous()
        delta = attention_delta(o3, do3)
        dq = flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, **ctx.args)
        dk, dv = flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                         **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs.

    Takes and refuses the shapes the Pallas ``flash_attention`` does: gate
    with :func:`supports` and use ``ops.layers.dot_product_attention``
    otherwise. ``block_q``/``block_k`` only decide which lengths are taken;
    the kernels tile by their own sizes, and the causal and dropout masks
    follow absolute positions, so the result does not depend on them.

    ``dropout_rate`` > 0 drops attention weights inside the kernels, with a
    mask that is a function of the integer ``dropout_seed`` (required then,
    as the Pallas wrapper requires ``dropout_key``). Differentiable: the
    backward runs the dQ and dK/dV kernels.
    """
    b, s, h, d = q.shape
    if not supports(s, block=min(block_q, block_k)):
        raise ValueError(
            f"flash_attention: seq_len {s} not divisible into blocks; "
            f"use ops.layers.dot_product_attention")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    seed = int(dropout_seed) if dropout_rate > 0.0 else 0
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    bq = min(block_q, s)
    bk = min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(
            f"flash_attention: seq_len {s} must be divisible by block_q={bq} "
            f"and block_k={bk}; use ops.layers.dot_product_attention")

    def to3(x):  # [b, s, h, d] -> [b*h, s, d]
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    q3, k3, v3 = to3(q), to3(k), to3(v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o3 = _FlashAttention.apply(q3, k3, v3, causal, scale, seed,
                                   float(dropout_rate))
    else:
        o3, _ = flash_attention_fwd(q3, k3, v3, causal=causal, scale=scale,
                                    seed=seed, rate=float(dropout_rate))
    return o3.reshape(b, h, s, d).transpose(1, 2)
