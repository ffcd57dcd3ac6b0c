"""Skip namespaces: isolate same-named skips from different module instances.

Copy of ``pipe_tpu/extras/skip/namespace.py``: a ``Namespace`` is an opaque
unique token; ``(namespace, name)`` pairs key every stash/pop, so two
instances of the same skippable module can coexist in one pipeline via
``module.isolate(ns)``.
"""

from __future__ import annotations

import itertools

__all__ = ["Namespace"]

_counter = itertools.count()


class Namespace:
    """An opaque, hashable, totally-ordered identity token."""

    __slots__ = ("_id",)

    def __init__(self):
        self._id = next(_counter)

    def __repr__(self) -> str:
        return f"<Namespace {self._id}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, Namespace) and self._id == other._id

    def __lt__(self, other) -> bool:
        if not isinstance(other, Namespace):
            return NotImplemented
        return self._id < other._id

    def __hash__(self) -> int:
        return hash(("pipe_tpu_torch.skip.Namespace", self._id))
