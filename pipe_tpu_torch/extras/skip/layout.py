"""Static skip layout: which (source stage -> destination stage) carries
exist.

Copy of ``pipe_tpu/extras/skip/layout.py`` (``SkipLayout``,
``inspect_skip_layout``). It is pure metadata: the emulator uses it to know
which skips cross a stage boundary (and so the checkpoint boundary of a
task), and the table executors to lay out one lane per cross-stage skip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

__all__ = ["SkipLayout", "inspect_skip_layout"]


@dataclasses.dataclass(frozen=True)
class SkipLayout:
    """Stash/pop wiring resolved to stage indices.

    ``by_src_dst`` maps ``(src_stage, dst_stage) -> [(ns, name), ...]``.
    """

    n_stages: int
    by_src_dst: Tuple[Tuple[Tuple[int, int], Tuple[Tuple[object, str], ...]], ...]

    def requires_copy(self, src: int, dst: int) -> bool:
        return any(k == (src, dst) for k, _ in self.by_src_dst)

    def copy_policy(self, dst: int) -> Iterator[Tuple[int, object, str]]:
        """(src_stage, ns, name) for every skip arriving at stage ``dst``."""
        for (src, d), names in self.by_src_dst:
            if d == dst:
                for ns, name in names:
                    yield src, ns, name

    @property
    def num_skips(self) -> int:
        return sum(len(names) for _, names in self.by_src_dst)

    def max_hop(self) -> int:
        """Longest stage distance a skip travels."""
        return max((d - s for (s, d), _ in self.by_src_dst), default=0)

    def stashes_of(self, stage: int) -> Tuple[Tuple[object, str], ...]:
        """Skips produced at ``stage`` that leave it (cross-stage sources).

        Executors use this to export stash values across checkpoint
        boundaries; same-stage stash->pop pairs stay inside the stage body.
        """
        out: List[Tuple[object, str]] = []
        for (src, dst), names in self.by_src_dst:
            if src == stage and dst != stage:
                out.extend(names)
        return tuple(out)

    def pops_of(self, stage: int) -> Tuple[Tuple[object, str], ...]:
        """Skips consumed at ``stage`` that arrive from an earlier stage."""
        out: List[Tuple[object, str]] = []
        for (src, dst), names in self.by_src_dst:
            if dst == stage and src != stage:
                out.extend(names)
        return tuple(out)


def inspect_skip_layout(partitions) -> SkipLayout:
    """Compute the stash->pop stage wiring from partitioned stages.

    ``partitions`` is a sequence of ``Sequential``s (one per stage) whose
    layers may be :class:`~pipe_tpu_torch.extras.skip.skippable.Skippable`.
    """
    stashed_at: Dict[Tuple[object, str], int] = {}
    pairs: Dict[Tuple[int, int], List[Tuple[object, str]]] = {}

    for j, partition in enumerate(partitions):
        for layer in partition:
            stashes = getattr(layer, "stashes", ())
            pops = getattr(layer, "pops", ())
            for key in stashes:
                stashed_at[key] = j
            for key in pops:
                if key in stashed_at:
                    src = stashed_at[key]
                    pairs.setdefault((src, j), []).append(key)

    frozen = tuple(sorted(
        ((sd, tuple(names)) for sd, names in pairs.items()),
        key=lambda kv: kv[0]))
    return SkipLayout(n_stages=len(list(partitions)), by_src_dst=frozen)
