"""Mixture-of-Experts FFN with its experts sharded over the model axis.

Counterpart of ``pipe_tpu/ops/moe.py`` (GShard/Switch lineage):

* **Dense dispatch, static shapes**: routing is one-hot dispatch and
  combine einsums over a fixed per-expert ``capacity`` (GShard's
  formulation), with no sorting of tokens and no data-dependent shapes.
  Tokens over capacity fall through on the residual stream.
* **Experts sharded over the ``model`` axis**: the expert-indexed leaves
  (``w1``/``b1``/``w2``/``b2`` ``[E, ...]`` and the router's expert
  COLUMNS ``wr [d, E]``, ``br [E]``) are cut on their expert dim
  (:func:`moe_ffn_specs`), so a rank of a model line holds ``E / ep``
  experts and computes only their capacity slots.
* **The tensor-parallel gradient contract** (:mod:`.tp_layers`): the region
  is bracketed by :func:`~.tp_layers.tp_enter` and
  :func:`~.tp_layers.tp_allreduce`, every sharded leaf's gradient is local
  by construction, replicated leaves' gradients are equal on a line, and
  the executors never reduce a gradient over the model axis.

Communication is TWO all-reduces over the model line per MoE layer, not an
all-to-all: the first assembles the full ``[T, E]`` router logits from each
rank's zero-padded local columns (the router is sharded by expert column
for exactly this: its gradient stays local), the second sums the ranks'
partial outputs. A MoE block (:func:`moe_block_apply`) adds attention's
one, three forward all-reduces in all.

The functional forms take ``p``, the parameters as a nested dict under
``pipe_tpu``'s leaf names (:meth:`MoEBlock.tree`), and the ``mesh`` whose
model line they all-reduce over (None: the unsharded math, ``pipe_tpu``'s
``ep_axis=None``, the transparency yardstick). The attention is einsums and
a float32 softmax, as in ``pipe_tpu``: this path launches no kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.partition import StageCtx
from ..parallel.mesh import MODEL_AXIS, PartitionSpec as P
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .tp_layers import (_CacheShim, _drop, _gelu, _layernorm, _line, _Norm,
                        _seeds, tp_allreduce, tp_attention_decode,
                        tp_attention_sublayer, tp_block_specs, tp_enter)

__all__ = ["MoEBlock", "moe_ffn_apply", "moe_ffn_specs", "moe_capacity",
           "moe_block_apply", "moe_block_decode", "moe_block_specs"]


def moe_ffn_specs() -> Dict[str, Any]:
    """Per-leaf ``PartitionSpec``s: every expert-indexed dim over the model
    axis, the router's expert columns among them."""
    m = MODEL_AXIS
    return {
        "wr": P(None, m), "br": P(m),
        "w1": P(m, None, None), "b1": P(m, None),
        "w2": P(m, None, None), "b2": P(m, None),
    }


def moe_capacity(n_tokens: int, n_experts: int, k: int,
                 capacity_factor: float) -> int:
    """GShard capacity: per-expert slot count for a ``[n_tokens]`` batch."""
    return max(1, int(capacity_factor * n_tokens * k / n_experts))


def _experts_refused(n_experts: int, ep: int) -> ValueError:
    return ValueError(
        f"n_experts={n_experts} not divisible by the expert-axis size {ep}: "
        f"orphaned experts would receive router mass but produce zero output")


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a row of
    zeros (``F.one_hot`` raises there)."""
    return (idx.unsqueeze(-1)
            == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: values and indices, the lower
    index first among equal values (a stable descending sort; ``torch.topk``
    promises no order there)."""
    idx = torch.sort(gates, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(gates, -1, idx), idx


def _route(gates: torch.Tensor, k: int, capacity: int):
    """Top-k routing of ``gates [T, E]`` (float32) with GShard's capacity,
    the same on every rank: the renormalized top-k gates and experts
    ``[T, k]``, and over the ``k * T`` slots in priority order (slot 0 of
    every token first) each slot's expert, its position in that expert
    (an integer cumsum) and whether it is within ``capacity``."""
    top_g, top_e = _top_k(gates, k)                     # [T, k]
    top_g = top_g / top_g.sum(dim=-1, keepdim=True)     # renormalize
    flat_e = top_e.T.reshape(-1)                        # [kT]
    onehot = _one_hot(flat_e, gates.shape[-1], torch.int32)   # [kT, E]
    pos = torch.cumsum(onehot, dim=0) - 1               # position in expert
    flat_pos = (pos * onehot).sum(dim=-1)               # [kT]
    return top_g, top_e, flat_e, flat_pos, flat_pos < capacity


def moe_ffn_apply(p: Dict[str, Any], h: torch.Tensor, *, n_experts: int,
                  k: int = 2, capacity_factor: float = 1.25, mesh=None):
    """Top-k token-choice MoE FFN on LOCAL expert slices.

    ``h``: ``[rows, seq, d]``, replicated over the model line. Returns
    ``(out, aux)``: ``aux`` is Switch's load-balancing auxiliary (E times
    the sum over experts of the top-1 fraction routed times the mean gate),
    a float32 scalar equal on every rank of the line."""
    line = _line(mesh)
    if line is not None:
        h = tp_enter(h, line)
        ep, shard = line.model_size, line.model
        if n_experts % ep:
            raise _experts_refused(n_experts, ep)
    else:
        ep, shard = 1, 0
    rows, seq, d = h.shape
    T, E = rows * seq, n_experts
    e_local = E // ep
    x = h.reshape(T, d)

    # --- router: local expert columns -> full logits through one sum ----
    local_logits = x @ p["wr"] + p["br"]                # [T, E/ep]
    if line is not None:
        full = F.pad(local_logits, (shard * e_local,
                                    E - (shard + 1) * e_local))
        logits_raw = tp_allreduce(full, line)
        # The GATING path's cotangents are rank-partial (each rank's
        # combine touches only its own experts' terms) and softmax couples
        # every column, so the full-logit cotangent is summed over the line
        # before the router's column slice: a second f operator. The AUX
        # path's cotangents are equal on every rank (a replicated value),
        # so it branches off BEFORE tp_enter: through the f operator it
        # would be counted ep times.
        logits = tp_enter(logits_raw, line)
    else:
        logits_raw = logits = local_logits
    gates = torch.softmax(logits.float(), dim=-1)
    gates_aux = torch.softmax(logits_raw.float(), dim=-1)
    C = moe_capacity(T, E, k, capacity_factor)
    top_g, top_e, flat_e, flat_pos, keep = _route(gates, k, C)
    flat_g = top_g.T.reshape(-1).to(h.dtype) * keep

    # --- dispatch/combine one-hots over LOCAL experts --------------------
    le = flat_e - shard * e_local                       # local expert index
    local = (flat_e >= shard * e_local) & (flat_e < (shard + 1) * e_local)
    sel = local & keep
    # [kT, E/ep, C], zero rows where a slot is not this rank's or dropped
    disp = (_one_hot(le, e_local, h.dtype)[:, :, None]
            * _one_hot(flat_pos, C, h.dtype)[:, None, :]
            * sel[:, None, None].to(h.dtype))
    tok = torch.arange(T, device=h.device).repeat(k)    # each slot's token
    x_e = torch.einsum("tec,td->ecd", disp, x[tok])     # [E/ep, C, d]

    inner = _gelu(torch.einsum("ecd,edf->ecf", x_e, p["w1"])
                  + p["b1"][:, None])
    y_e = torch.einsum("ecf,efd->ecd", inner, p["w2"]) + p["b2"][:, None]

    comb = disp * flat_g[:, None, None]                 # gate-weighted
    y_flat = torch.einsum("tec,ecd->td", comb, y_e)     # [kT, d] partial
    y_tok = y_flat.reshape(k, T, d).sum(dim=0)
    out = tp_allreduce(y_tok, line).reshape(rows, seq, d)

    # --- load-balance aux (Switch): E * sum_e f_e * m_e, from the softmax
    # before tp_enter (the router note above) ------------------------------
    frac = _one_hot(top_e[:, 0], E, torch.float32).mean(dim=0)
    mean_gate = gates_aux.mean(dim=0)
    aux = E * (frac * mean_gate).sum()
    return out, aux.float()


# ---------------------------------------------------------------------------
# MoE transformer block: TP attention + MoE FFN (heads AND experts sharded
# over the same model axis)
# ---------------------------------------------------------------------------

def moe_block_specs() -> Dict[str, Any]:
    """The block's specs: the TP attention's leaves and the MoE FFN's."""
    t = tp_block_specs()
    return {"ln1": t["ln1"], "wqkv": t["wqkv"], "bqkv": t["bqkv"],
            "wo": t["wo"], "bo": t["bo"], "ln2": t["ln2"],
            "moe": moe_ffn_specs()}


def moe_block_decode(p: Dict[str, Any], h: torch.Tensor, cache: dict,
                     pos: int, *, n_experts: int, k: int = 2,
                     capacity_factor: float = 1.25, mesh=None,
                     allowed: Optional[torch.Tensor] = None):
    """Incremental :func:`moe_block_apply` with a KV cache (inference):
    cached TP attention (heads sharded over the same axis as the experts),
    then the MoE FFN on the new positions; routing is per token, so the
    dense dispatch works unchanged at q=1, and the aux loss is discarded.
    NOTE: GShard capacity is computed from the CURRENT call's token count,
    so at tiny decode batches use a generous ``capacity_factor`` if parity
    with a full-sequence forward matters (over-capacity tokens fall through
    on the residual, in both paths). Returns ``(h, cache)``."""
    h, cache = tp_attention_decode(p, h, cache, pos, mesh=mesh,
                                   allowed=allowed)
    ff, _aux = moe_ffn_apply(p["moe"], _layernorm(h, p["ln2"]),
                             n_experts=n_experts, k=k,
                             capacity_factor=capacity_factor, mesh=mesh)
    return h + ff, cache


def moe_block_apply(p: Dict[str, Any], h: torch.Tensor,
                    ctx: StageCtx = StageCtx(), *, n_experts: int, k: int = 2,
                    capacity_factor: float = 1.25, dropout: float = 0.0,
                    causal: bool = True, mesh=None):
    """Pre-LN block: the TP attention sublayer, then the MoE FFN on the
    LayerNorm'd stream with a residual add (dropped tokens pass through on
    the residual). The two residual dropouts draw from ``fold_seed(seed,
    0)`` and ``fold_seed(seed, 1)`` (``pipe_tpu`` splits the key in two;
    the MoE FFN itself draws nothing). Returns ``(h, aux)``."""
    s1, s2 = _seeds(ctx, dropout)
    h = tp_attention_sublayer(p, h, causal=causal, dropout=dropout, seed=s1,
                              rows=ctx.rows, mesh=mesh)
    ff, aux = moe_ffn_apply(p["moe"], _layernorm(h, p["ln2"]),
                            n_experts=n_experts, k=k,
                            capacity_factor=capacity_factor, mesh=mesh)
    return h + _drop(ff, dropout, s2, ctx.rows), aux


class _Experts(nn.Module):
    """The MoE FFN's six leaves under ``pipe_tpu``'s names."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, normal,
                 zeros):
        super().__init__()
        self.wr = normal(d_model, n_experts, fan_in=d_model)
        self.br = zeros(n_experts)
        self.w1 = normal(n_experts, d_model, d_ff, fan_in=d_model)
        self.b1 = zeros(n_experts, d_ff)
        self.w2 = normal(n_experts, d_ff, d_model, fan_in=d_ff)
        self.b2 = zeros(n_experts, d_model)


class MoEBlock(nn.Module):
    """The MoE block as a module: ``pipe_tpu``'s leaves and shapes
    (``ln1.{scale,bias}``, ``wqkv [d, 3, H, hd]``, ``bqkv``, ``wo [H, hd,
    d]``, ``bo``, ``ln2.*``, and ``moe.{wr [d, E], br [E], w1 [E, d, ff],
    b1 [E, ff], w2 [E, ff, d], b2 [E, d]}``), drawn as ``pipe_tpu``'s
    ``moe_block_init`` draws them (normal, scaled by 1/sqrt(fan-in); biases
    zero; LayerNorms one and zero), whole. A rank of a model line holds its
    heads and its experts once ``parallel.mesh.shard_params`` has cut them
    (``ScheduledPipeline(stage_param_specs=)`` and ``TPShardedGenerator``
    do). ``ep_axis``: ``MODEL_AXIS``, whose line of ``mesh`` the block
    all-reduces over, or None (the unsharded yardstick). Weights are cast to
    the activation's dtype at use. The forward returns the hidden state
    only: the pipelined path drops the aux loss (``models/moe_lm.py``)."""

    def __init__(self, d_model: int, nhead: int, d_ff: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dropout: float = 0.0, causal: bool = True, *,
                 ep_axis: Optional[str] = MODEL_AXIS, mesh=None,
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hd = d_model // nhead
        if hd * nhead != d_model:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"nhead={nhead}")
        if ep_axis not in (None, MODEL_AXIS):
            raise ValueError(f"ep_axis must be {MODEL_AXIS!r} or None, got "
                             f"{ep_axis!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.d_model, self.nhead, self.d_ff = d_model, nhead, d_ff
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dropout, self.causal = dropout, causal
        # the generators' contract name: heads shard over the experts' axis
        self.ep_axis = self.tp_axis = ep_axis
        self.mesh = mesh

        def normal(*shape, fan_in):
            w = torch.randn(shape, generator=generator, dtype=dtype,
                            device=dev)
            return nn.Parameter(w / math.sqrt(fan_in))

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))

        self.ln1 = _Norm(d_model, dtype, dev)
        self.wqkv = normal(d_model, 3, nhead, hd, fan_in=d_model)
        self.bqkv = zeros(3, nhead, hd)
        self.wo = normal(nhead, hd, d_model, fan_in=d_model)
        self.bo = zeros(d_model)
        self.ln2 = _Norm(d_model, dtype, dev)
        self.moe = _Experts(d_model, d_ff, n_experts, normal, zeros)
        self.attn = _CacheShim(self)

    def tree(self, dtype=None) -> Dict[str, Any]:
        """The parameters as ``pipe_tpu``'s nested dict, cast to
        ``dtype``."""
        def leaves(mod):
            return {n: (p if dtype is None else p.to(dtype))
                    for n, p in mod.named_parameters(recurse=False)}

        return {"ln1": leaves(self.ln1), **leaves(self),
                "ln2": leaves(self.ln2), "moe": leaves(self.moe)}

    def model_line(self):
        """The mesh to all-reduce over, checked against the slices held: a
        line of ``ep`` ranks needs the experts and the heads cut ``ep``
        ways, and whole ones need no line (else the partial sums would be
        wrong)."""
        line = _line(self.mesh) if self.ep_axis is not None else None
        ep = 1 if line is None else line.model_size
        if self.n_experts % ep:
            raise _experts_refused(self.n_experts, ep)
        for what, held, whole in (
                ("experts", int(self.moe.w1.shape[0]), self.n_experts),
                ("heads", int(self.wqkv.shape[2]), self.nhead)):
            if held * ep != whole:
                raise ValueError(
                    f"the block holds {held} of {whole} {what} over a model "
                    f"line of {ep}: cut its sharded leaves with "
                    f"parallel.mesh.shard_params (stage_param_specs) first")
        return line

    @torch.no_grad()
    def dropped_slots(self, h: torch.Tensor) -> int:
        """The token-slots that this block's routing of ``h`` (its input,
        ``[rows, seq, d]``) sends over capacity, where they fall through on
        the residual: a diagnostic of the whole (uncut, lineless) block, in
        eval (no dropout)."""
        if self.model_line() is not None:
            raise ValueError("dropped_slots reads a whole block, not a "
                             "rank's cut of one")
        p = self.tree(h.dtype)
        h = tp_attention_sublayer(p, h, causal=self.causal, dropout=0.0,
                                  seed=None)
        x = _layernorm(h, p["ln2"]).reshape(-1, self.d_model)
        gates = torch.softmax((x @ p["moe"]["wr"] + p["moe"]["br"]).float(),
                              dim=-1)
        C = moe_capacity(x.shape[0], self.n_experts, self.top_k,
                         self.capacity_factor)
        return int((~_route(gates, self.top_k, C)[-1]).sum())

    def _kw(self) -> dict:
        return dict(n_experts=self.n_experts, k=self.top_k,
                    capacity_factor=self.capacity_factor,
                    mesh=self.model_line())

    def forward(self, h, ctx: StageCtx = StageCtx()):
        out, _aux = moe_block_apply(self.tree(h.dtype), h, ctx,
                                    dropout=self.dropout, causal=self.causal,
                                    **self._kw())
        return out

    def decode(self, h, cache: dict, pos, tree=None, *,
               allowed: Optional[torch.Tensor] = None):
        """Incremental apply with a KV cache of this rank's heads
        (inference; the aux loss discarded): ``(h, cache)``."""
        if not self.causal:
            raise ValueError("KV-cache decode requires causal attention")
        if tree is not None or isinstance(pos, torch.Tensor):
            raise NotImplementedError(
                "the MoE block decodes at a host-integer position without a "
                "draft tree, as pipe_tpu's")
        return moe_block_decode(self.tree(h.dtype), h, cache, pos,
                                allowed=allowed, **self._kw())
