"""The one traffic generator: inputs of every cell from its file and the
run's ``--seed``.

Training cells draw uniform token ids. Serving cells draw an open-loop
arrival schedule: the arrival times and the (prompt, output) lengths in
their order come from the traffic's fixed ``arrivals_seed``, and the run
seed draws only the prompts' tokens. So every seed offers the same work:
the tail of time to first token follows which long prompts arrive
together, and an order drawn from the run seed moved the 95th percentile
by a third between seeds. A Poisson process conditioned on its count is
that many uniform points, so the times are sorted uniform draws over the
window.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def lm_source(seed: int, rows: int, batch: int, vocab: int) -> np.ndarray:
    """A ``[rows, batch]`` id matrix in the layout of the port's
    ``data/lm_text.batchify``: column j is lane j of the token stream."""
    rng = np.random.default_rng([seed, 1])
    return rng.integers(0, vocab, size=(rows, batch), dtype=np.int64)


def lm_batch(source: np.ndarray, step: int, bptt: int):
    """Batch ``step`` of ``source``: ``[batch, bptt]`` inputs and their
    next-token targets (``lm_text.get_batch``'s semantics)."""
    i = step * bptt
    data = source[i:i + bptt].T
    target = source[i + 1:i + 1 + bptt].T
    return np.ascontiguousarray(data), np.ascontiguousarray(target)


def token_batches(seed: int, steps: int, batch: int, seq: int, vocab: int,
                  device):
    """``[steps, batch, seq + 1]`` uniform ids in ``[2, vocab)``, drawn on
    ``device`` in one call; step b trains on ``[:, :-1]`` against
    ``[:, 1:]``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(2, vocab, (steps, batch, seq + 1), generator=gen,
                         device=device)


@dataclasses.dataclass
class Arrival:
    due_s: float              # seconds after the window opens
    prompt: List[int]
    max_new: int


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    x = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], size=n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def serve_lengths(cell: dict, n: int):
    """The ``n`` (prompt, output) lengths of the cell, in arrival order."""
    rng = np.random.default_rng([cell["arrivals_seed"], n])
    return _lognormal(rng, cell["prompt"], n), _lognormal(rng, cell["output"],
                                                           n)


def serve_schedule(cell: dict, seed: int, seconds: float, vocab: int,
                   rate: float = None) -> List[Arrival]:
    """The open-loop schedule of one run: ``rate`` (default the cell's
    ``rate_per_s``) times ``seconds`` arrivals, sorted by due time."""
    rate = cell["rate_per_s"] if rate is None else rate
    n = max(1, int(round(rate * seconds)))
    base = np.random.default_rng([cell["arrivals_seed"], n, 1])
    due = np.sort(base.uniform(0.0, seconds, size=n))
    plen, new = serve_lengths(cell, n)
    rng = np.random.default_rng([seed, 2])
    prompts = rng.integers(2, vocab, size=int(plen.sum()), dtype=np.int64)
    out, at = [], 0
    for i in range(n):
        p = int(plen[i])
        out.append(Arrival(float(due[i]), prompts[at:at + p].tolist(),
                           int(new[i])))
        at += p
    return out
