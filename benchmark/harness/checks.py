"""The comparisons that decide ``correct``, each a number held to a limit.

Training (the program's first three steps against the plain reference's,
from the same weights and batches):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_norm_gap``: the relative gap of step 1's global gradient norm
  before the clip;
* ``grad_leaf_gap``: the worst leaf's gap between the program's and the
  reference's norm of step 1's gradient as the optimizer got it (after the
  clip), over the larger of the reference leaf's norm and the median
  leaf's;
* ``grad_diff_gap``: the worst leaf's norm of the difference between the
  two step-1 gradients, over the same denominator. Norms of whole leaves
  average random per-element rounding away, so only this number tells
  TF32 products from float32 ones where attention is a large share;
* ``change_leaf_gap``: the same for each leaf's distance from its start
  after step 3, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a key projection's bias has a gradient
  of nought under softmax, and Adam moves it by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

SILENT_LEAF = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) of per-leaf norms: |prog - ref| over
    max(ref, median ref) across ``names`` (default every leaf)."""
    names = list(ref if names is None else names)
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not gap <= worst:            # NaN counts as worst
            worst, at = gap, n
    return worst, at


def moving_leaves(ref_grad: Dict[str, float]):
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= SILENT_LEAF * med]


def training_gaps(prog: dict, ref: dict,
                  diff: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
    """The training numbers of ``prog`` against ``ref`` (each a dict of
    ``losses``, ``grad_norm``, ``leaf_grad``, ``leaf_change``), and, given
    ``diff`` (each leaf's norm of the difference of the two step-1
    gradients), ``grad_diff_gap``."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    out = {
        "loss_gap": loss,
        "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"])
        / ref["grad_norm"],
        "grad_leaf_gap": leaf_gap(prog["leaf_grad"], ref["leaf_grad"])[0],
        "change_leaf_gap": leaf_gap(prog["leaf_change"], ref["leaf_change"],
                                    moving_leaves(ref["leaf_grad"]))[0],
    }
    if diff is not None:
        med = statistics.median(ref["leaf_grad"].values())
        out["grad_diff_gap"] = max(d / max(ref["leaf_grad"][n], med)
                                   for n, d in diff.items())
    return out


def served_gap(ref_logits, positions, tokens) -> float:
    """Widest ``max(logits[p]) - logits[p, token]`` over the served tokens
    (one ``[L, V]`` reference row per position)."""
    import torch

    rows = ref_logits[positions]
    best = rows.max(dim=-1).values
    got = rows.gather(-1, torch.as_tensor(tokens, device=rows.device)[:, None]
                      )[:, 0]
    return float((best - got).max())


def held(values: Dict[str, float], limits: Dict[str, float]
         ) -> Dict[str, tuple]:
    """Each number beside its limit, for the numbers the cell limits."""
    return {k: (values[k], limits[k]) for k in limits}


def passed(checks: Dict[str, tuple]) -> bool:
    return all(v <= lim for v, lim in checks.values())
