"""Draft sources for the speculative decode lane.

Counterpart of ``pipe_tpu/inference/draft.py``. A speculative round drafts
``K - 1`` tokens per slot, verifies them with the current token in one
``K``-row teacher-forced decode, and keeps the longest prefix that the
model itself would have picked, plus one correction token
(``serve/engine.py``). Three drafters, behind one interface:

* :class:`NgramDraft` -- the tokens that followed the most recent earlier
  occurrence of the current token in the slot's device-side history. No
  model work.
* :class:`TruncatedDraft` -- ``K - 1`` greedy steps through the FIRST
  ``draft_layers`` blocks of the model itself and a tied-embedding head.
  The draft is a strict prefix of the model, so its K/V rows land in the
  real caches, at rows the verify then overwrites (the rollback-overwrite
  law: no extra storage).
* :class:`TreeDraft` -- the top ``branches`` first tokens of one shared
  truncated root step, each rolled out greedily on a private copy of the
  draft-layer caches; the engine verifies every branch in ONE chunk under
  the tree mask (:func:`tree_layout`) and accepts the longest matching
  root-to-leaf path.

Every ``propose`` is device tensor work that reads nothing back to the
host: it runs inside the engine's captured resident graph. Positions are
per-slot int64 tensors, and each step is the model's own ``block.decode``
on the caches the verify uses (the slab, or the paged views), so a draft
row is what the verify would write for the same token and position.

:func:`tree_layout` and :func:`resolve_draft` are numpy and plain Python,
copied here so that the port needs nothing of ``pipe_tpu``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["DraftSource", "NgramDraft", "TruncatedDraft", "TreeDraft",
           "tree_layout", "resolve_draft"]


def tree_layout(K: int, branches: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static layout of the flattened draft tree for ``branches`` chains
    of depth ``K-1`` sharing one root.

    Returns ``(depths [Q], anc [Q, Q])`` with ``Q = 1 + branches*(K-1)``:
    row 0 is the root (the slot's current token, depth 0); branch ``b``
    level ``i`` sits at row ``1 + b*(K-1) + i`` with depth ``i+1``.
    ``anc[j, r]`` is True when chunk row ``r`` is an ancestor-or-self of
    chunk row ``j`` -- the within-chunk attention mask."""
    Q = 1 + branches * (K - 1)
    depths = np.zeros((Q,), np.int32)
    anc = np.zeros((Q, Q), bool)
    anc[0, 0] = True
    for b in range(branches):
        base = 1 + b * (K - 1)
        for i in range(K - 1):
            r = base + i
            depths[r] = i + 1
            anc[r, 0] = True
            anc[r, base:base + i + 1] = True
    return depths, anc


class DraftSource:
    """One speculative draft proposal per resident round.

    ``propose(model, caches, table, tok, pos, hist, K, buffers)`` returns
    the drafts ``[S, branches, K-1]`` (int64): for each slot, ``branches``
    candidate continuations of its current token ``tok [S]`` at ``pos
    [S]``. ``caches`` are the per-layer ``{"k", "v"}`` caches ``[S, rows,
    heads, head_dim]`` the verify runs on, ``table`` their
    :func:`~..ops.layers.causal_table`, ``hist [S, H]`` the token history,
    ``buffers`` the drafter's own scratch (:meth:`make_buffers`, or None).
    A model drafter writes real K/V rows at positions ``>= pos`` in place;
    the verify chunk rewrites every one of them before any unmasked read."""

    name = "?"
    branches = 1

    def propose(self, model, caches: List[dict], table: torch.Tensor,
                tok: torch.Tensor, pos: torch.Tensor, hist: torch.Tensor,
                K: int, buffers: Optional[List[dict]] = None
                ) -> torch.Tensor:
        raise NotImplementedError

    def make_buffers(self, caches: List[dict]) -> Optional[List[dict]]:
        """Device scratch that ``propose`` rewrites every round, allocated
        once by the caller (the engine keeps it as a static buffer of its
        captured program); None when the drafter needs none."""
        return None

    def draft_cost_frac(self, K: int, n_layers: int) -> float:
        """Predicted draft device-time over total round device-time,
        counting (rows x layers) work units."""
        raise NotImplementedError


class NgramDraft(DraftSource):
    """Tokens following the most recent earlier occurrence of the current
    token in the slot's history, ``hist[s, :pos]``; where nothing matches,
    the history from its start. The window start is clamped to ``H -
    (K-1)``, as ``pipe_tpu``'s ``dynamic_slice`` clamps it."""

    name = "ngram"

    def propose(self, model, caches, table, tok, pos, hist, K,
                buffers=None):
        H = hist.shape[1]
        idx = torch.arange(H, device=hist.device)
        mask = (hist == tok[:, None]) & (idx < pos[:, None])
        j = torch.where(mask, idx, -1).amax(dim=1)            # [S]
        start = (j + 1).clamp(0, H - (K - 1))
        window = start[:, None] + torch.arange(K - 1, device=hist.device)
        return hist.gather(1, window)[:, None, :]             # [S, 1, K-1]

    def draft_cost_frac(self, K, n_layers):
        return 0.0


def _tied_logits(model, h: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head: hidden states ``[S, d]`` scored against the
    embedding table in float32. The ``sqrt(d)`` embed scale is uniform
    over the vocabulary, so the argmax and top-k are scale-invariant."""
    return h.to(torch.float32) @ model.embed.weight.to(torch.float32).T


def _draft_step(model, blocks, caches, table, tok, pos) -> torch.Tensor:
    """One ``q = 1`` step through the draft blocks: ``tok [S]`` embedded
    at ``pos [S]``, K/V row ``pos`` written in each draft layer's cache,
    the hidden state ``[S, d]`` returned. The mask row is the table's at
    the position clamped to the cache, as ``block.decode`` clamps the
    write."""
    h = model.embed_at(tok[:, None], pos)                  # [S, 1, d]
    allowed = table[pos.clamp(0, table.shape[0] - 1)][:, None]
    for blk, cache in zip(blocks, caches):
        h, _ = blk.decode(h, cache, pos, allowed=allowed)
    return h[:, 0]


class TruncatedDraft(DraftSource):
    """Greedy ``K-1`` step rollout through the first ``draft_layers``
    blocks of the model plus a tied-embedding head."""

    name = "truncated"

    def __init__(self, draft_layers: int):
        if draft_layers < 1:
            raise ValueError(
                f"truncated draft needs >= 1 draft layer, got "
                f"{draft_layers}")
        self.draft_layers = draft_layers

    def propose(self, model, caches, table, tok, pos, hist, K,
                buffers=None):
        Ld = self.draft_layers
        blocks, dcaches = model.blocks[:Ld], caches[:Ld]
        cur, p = tok, pos
        outs = []
        for _ in range(K - 1):
            h = _draft_step(model, blocks, dcaches, table, cur, p)
            cur = torch.argmax(_tied_logits(model, h), dim=-1)
            outs.append(cur)
            p = p + 1
        return torch.stack(outs, dim=1)[:, None, :]         # [S, 1, K-1]

    def draft_cost_frac(self, K, n_layers):
        d = (K - 1) * self.draft_layers
        return d / (d + K * n_layers)


class TreeDraft(DraftSource):
    """Top-``branches`` first tokens from one shared truncated root step,
    each continued greedily on a private copy of the draft-layer caches
    (``S * branches`` pseudo-slots). Only the shared root row persists in
    the real caches; the verify rewrites it.

    The private copies are the ``buffers``: per draft layer ``{"k", "v"}``
    of ``[S * branches, rows, heads, head_dim]``, overwritten every round
    (allocated here when the caller passes none)."""

    name = "tree"

    def __init__(self, branches: int, draft_layers: int):
        if branches < 2:
            raise ValueError(
                f"tree draft needs >= 2 branches (1 branch IS the "
                f"truncated drafter), got {branches}")
        if draft_layers < 1:
            raise ValueError(
                f"tree draft needs >= 1 draft layer, got {draft_layers}")
        self.branches = branches
        self.draft_layers = draft_layers

    def make_buffers(self, caches):
        """The branch caches for the draft layers of ``caches``."""
        B = self.branches
        return [{name: torch.empty((c.shape[0] * B,) + tuple(c.shape[1:]),
                                   dtype=c.dtype, device=c.device)
                 for name, c in cache.items()}
                for cache in caches[:self.draft_layers]]

    def propose(self, model, caches, table, tok, pos, hist, K,
                buffers: Optional[List[dict]] = None):
        Ld, B = self.draft_layers, self.branches
        S = tok.shape[0]
        blocks, dcaches = model.blocks[:Ld], caches[:Ld]
        # the shared root step writes row `pos` in the real draft caches
        h = _draft_step(model, blocks, dcaches, table, tok, pos)
        first = torch.topk(_tied_logits(model, h), B, dim=-1).indices
        if K == 2:
            return first[:, :, None]                          # [S, B, 1]
        if buffers is None:
            buffers = self.make_buffers(caches)
        for cache, buf in zip(dcaches, buffers):
            for name, c in cache.items():
                buf[name].view((S, B) + tuple(c.shape[1:])).copy_(
                    c[:, None].expand((S, B) + tuple(c.shape[1:])))
        cur = first.reshape(-1)
        p = (pos + 1)[:, None].expand(S, B).reshape(-1)
        outs = [cur]
        for _ in range(K - 2):
            h = _draft_step(model, blocks, buffers, table, cur, p)
            cur = torch.argmax(_tied_logits(model, h), dim=-1)
            outs.append(cur)
            p = p + 1
        return torch.stack(outs, dim=1).reshape(S, B, K - 1)

    def draft_cost_frac(self, K, n_layers):
        steps = 1 + self.branches * max(K - 2, 0)
        d = steps * self.draft_layers
        Q = 1 + self.branches * (K - 1)
        return d / (d + Q * n_layers)


def resolve_draft(name: str, *, n_stages: int, layers_per_stage: int,
                  draft_stages: int = 1,
                  spec_branches: Optional[int] = None) -> DraftSource:
    """Build a drafter from flag-level options, rejecting impossible
    combinations loudly (never a silent fallback)."""
    if name == "ngram":
        return NgramDraft()
    if draft_stages < 1 or draft_stages >= n_stages:
        raise ValueError(
            f"draft_stages={draft_stages} must be in [1, "
            f"{n_stages - 1}] — the draft is a STRICT prefix of the "
            f"{n_stages}-stage model (a full-depth draft is just the "
            f"model)")
    Ld = draft_stages * layers_per_stage
    if name == "truncated":
        return TruncatedDraft(Ld)
    if name == "tree":
        if spec_branches is None or spec_branches < 2:
            raise ValueError(
                f"tree draft needs spec_branches >= 2, got "
                f"{spec_branches}")
        return TreeDraft(spec_branches, Ld)
    raise ValueError(
        f"unknown draft source {name!r}: pick ngram | truncated | tree")
