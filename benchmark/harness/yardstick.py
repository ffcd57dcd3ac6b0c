"""The yardstick: the card's peaks and the operations and bytes that the
mathematics of a step or a kernel call needs, counted from shapes.

Frozen here so that no later change to the program moves what its numbers
are measured against.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the full 700 W limit.
# MFU and rooflines are taken against the 16-bit tensor-core rate: the most
# any implementation that the correctness checks admit could reach. The
# float32 CUDA-core rate is printed beside it for the history in PERF.md.
PEAK_DENSE16_FLOPS = 989.4e12
PEAK_FP32_FLOPS = 66.9e12
PEAK_HBM_BYTES = 3.35e12


def train_flops_per_token(d_model: int, d_ff: int, n_layers: int, vocab: int,
                          seq_len: int, causal: bool, checkpoint: str,
                          chunks: int):
    """(required, hardware) FLOPs per trained token: a copy of the port's
    ``obs/telemetry.py`` ``train_flops_per_token`` as it stood when this
    benchmark was made.

    MACs per token: per layer the four projections 4·d², the feed-forward
    2·d·d_ff and the score and value products 2·s·d (s halved when causal);
    the decoder d·vocab. A MAC is 2 FLOPs and the backward costs twice the
    forward, so ``required`` is 6·MACs (no recomputation); ``hardware``
    adds the re-forward of the layers that ``except_last`` recomputes for
    chunks-1 of the chunks micro-batches (``always``: all of them)."""
    eff_s = seq_len / 2 if causal else seq_len
    layer_macs = n_layers * (4 * d_model * d_model + 2 * d_model * d_ff
                             + 2 * eff_s * d_model)
    macs = layer_macs + d_model * vocab
    remat = {"never": 0.0, "except_last": (chunks - 1) / chunks,
             "always": 1.0}[checkpoint]
    required = 2 * macs * 3
    return required, required + 2 * layer_macs * remat


def _pairs(s: int, causal: bool) -> int:
    """Query-key pairs a head attends: s(s+1)/2 under a causal mask."""
    return s * (s + 1) // 2 if causal else s * s


def flash_call_cost(kernel: str, bh: int, s: int, d: int, causal: bool,
                    elem_bytes: int = 4):
    """(FLOPs, bytes) that one call of a flash-attention kernel over
    ``[bh, s, d]`` needs.

    FLOPs count the products the mathematics needs, 2·d a product per
    attended pair, and no recomputation a kernel chooses: the forward
    needs S = QKᵀ and O = PV; the backward dP = dO·Vᵀ, dQ = dS·K,
    dV = Pᵀ·dO and dK = dSᵀ·Q, of which the dQ kernel is charged dP and dQ
    and the dK/dV kernel dV and dK. Bytes count each input read once and
    each output written once: the forward reads q, k, v and writes o and
    the per-row logsumexp; each backward kernel reads q, k, v, dO and the
    two per-row statistics (logsumexp and rowsum(dO·O)) and writes dQ, or
    dK and dV."""
    pairs = _pairs(s, causal) * bh
    mat = bh * s * d * elem_bytes
    row = bh * s * 4
    if kernel == "fwd":
        return 4 * d * pairs, 3 * mat + mat + row
    if kernel == "bwd_dq":
        return 4 * d * pairs, 4 * mat + 2 * row + mat
    if kernel == "bwd_dkv":
        return 4 * d * pairs, 4 * mat + 2 * row + 2 * mat
    raise ValueError(f"unknown flash kernel {kernel!r}")


def flash_call_bound_s(kernel: str, bh: int, s: int, d: int, causal: bool,
                       elem_bytes: int = 4) -> float:
    """The least time one call could take: the larger of its FLOPs at the
    dense 16-bit peak and its bytes at the HBM rate."""
    flops, nbytes = flash_call_cost(kernel, bh, s, d, causal, elem_bytes)
    return max(flops / PEAK_DENSE16_FLOPS, nbytes / PEAK_HBM_BYTES)
