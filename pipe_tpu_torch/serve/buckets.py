"""Prompt-length bucketing: a small, closed set of prefill shapes.

Counterpart of ``pipe_tpu/serve/buckets.py``, copied (standard library
only). A serving workload feeds arbitrary prompt lengths; the engine rounds
every prompt length up to the nearest member of a fixed bucket set and
right-pads, so prefill runs at most ``len(lengths)`` shapes, ever (in
``pipe_tpu`` each shape is a compiled program; here each is a shape the
per-bucket counters count, and what a captured prefill per bucket would
capture).

Right-padding is safe by the causal mask: ``MultiHeadAttention.decode``
masks ``kpos > qpos`` at -1e30, so pad rows past the true length never
influence real positions, and decode overwrites each padded cache row
before the first step that could attend to it. ``tests/test_torch_serve.py``
holds bucketed-prefill output against the unpadded one-shot ``Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

__all__ = ["BucketSpec"]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Sorted, fixed set of prompt lengths the engine prefills at.

    ``bucket_for(p)`` returns the smallest bucket >= p and raises when
    the prompt exceeds the largest bucket — admission control rejects
    what it cannot serve instead of growing the set of shapes.
    """

    lengths: Tuple[int, ...]

    def __post_init__(self):
        if not self.lengths:
            raise ValueError("BucketSpec needs at least one length")
        lens = tuple(sorted(set(int(x) for x in self.lengths)))
        if lens[0] < 1:
            raise ValueError(f"bucket lengths must be >= 1, got {lens}")
        object.__setattr__(self, "lengths", lens)

    @classmethod
    def of(cls, *lengths: int) -> "BucketSpec":
        return cls(tuple(lengths))

    @classmethod
    def pow2(cls, min_len: int = 8, max_len: int = 512) -> "BucketSpec":
        """Powers of two in [min_len, max_len] — at most 2x padding waste
        per prompt, log2(max/min)+1 prefill shapes."""
        if min_len < 1 or max_len < min_len:
            raise ValueError(
                f"need 1 <= min_len <= max_len, got {min_len}, {max_len}")
        out, b = [], 1
        while b < min_len:
            b *= 2
        while b <= max_len:
            out.append(b)
            b *= 2
        if not out or out[-1] < max_len:
            out.append(max_len)
        return cls(tuple(out))

    @property
    def max_len(self) -> int:
        return self.lengths[-1]

    def bucket_for(self, prompt_len: int) -> int:
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        for b in self.lengths:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt_len {prompt_len} exceeds the largest bucket "
            f"{self.lengths[-1]}; admit shorter prompts or widen the spec")

    def pad(self, prompt: Sequence[int],
            pad_token_id: int = 0) -> Tuple[list, int]:
        """``(padded ids of bucket length, true length)``."""
        p = len(prompt)
        b = self.bucket_for(p)
        return list(prompt) + [int(pad_token_id)] * (b - p), p
