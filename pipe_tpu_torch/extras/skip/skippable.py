"""``@skippable`` modules and the ``stash``/``pop`` verbs.

Counterpart of ``pipe_tpu/extras/skip/skippable.py``. Modules run under an
active :class:`SkipTracker` scope, so ``stash``/``pop`` are direct calls:

    @skippable(stash=["1to3"])
    class Stash13(nn.Module):
        def forward(self, x, ctx=StageCtx()):
            stash("1to3", x)
            return x

    @skippable(pop=["1to3"])
    class Pop13(nn.Module):
        def forward(self, x, ctx=StageCtx()):
            return x + pop("1to3")

Bare ``stash("name", v)`` / ``pop("name")`` resolve through the *calling
module instance* (the decorator binds it around ``forward``, where
``pipe_tpu`` binds it around ``apply``), so two instances of one skippable
class are isolated with ``module.isolate(Namespace())``, and
``isolate(ns, only=[...])`` moves only the listed names into ``ns``.
"""

from __future__ import annotations

import contextvars
import copy
from typing import Dict, Iterable, Optional, Sequence, Set, Tuple

from torch import nn

from .namespace import Namespace
from .tracker import current_skip_tracker

__all__ = ["Skippable", "skippable", "stash", "pop", "verify_skippables"]

_GLOBAL_NS = Namespace()  # default namespace for un-isolated skips

# The skippable instance whose forward() is executing: lets bare
# stash()/pop() resolve names through that instance's namespace map.
_active: contextvars.ContextVar[Optional["Skippable"]] = \
    contextvars.ContextVar("pipe_tpu_torch_active_skippable", default=None)


class Skippable:
    """Mixin marking a module as stashing/popping named skips.

    Applied by :func:`skippable`; carries ``stashes``/``pops`` as sets of
    ``(namespace, name)`` resolved through the instance's per-name namespace
    map (``isolate`` rewrites entries of that map).
    """

    _stash_names: Tuple[str, ...] = ()
    _pop_names: Tuple[str, ...] = ()

    @property
    def namespace_map(self) -> Dict[str, Namespace]:
        return getattr(self, "_skip_ns_map", {})

    def ns_of(self, name: str) -> Namespace:
        return self.namespace_map.get(name, _GLOBAL_NS)

    def isolate(self, ns: Namespace, *, only: Optional[Iterable[str]] = None):
        """Copy with the given (or all) skip names moved into ``ns``;
        unselected names keep their current namespace. The copy shares the
        module's parameters."""
        clone = copy.copy(self)
        mapping = dict(self.namespace_map)
        names = tuple(only) if only is not None else (
            self._stash_names + self._pop_names)
        for n in names:
            mapping[n] = ns
        clone._skip_ns_map = mapping
        return clone

    @property
    def stashes(self) -> Set[Tuple[object, str]]:
        return {(self.ns_of(n), n) for n in self._stash_names}

    @property
    def pops(self) -> Set[Tuple[object, str]]:
        return {(self.ns_of(n), n) for n in self._pop_names}


def skippable(stash: Sequence[str] = (), pop: Sequence[str] = ()):
    """Class decorator declaring which skip names a module stashes/pops."""
    stash_names = tuple(stash)
    pop_names = tuple(pop)

    def decorate(cls):
        if not issubclass(cls, nn.Module):
            raise TypeError("@skippable expects an nn.Module subclass")

        inner_forward = cls.forward

        def forward(self, *inputs, **kwargs):
            token = _active.set(self)
            try:
                return inner_forward(self, *inputs, **kwargs)
            finally:
                _active.reset(token)

        return type(cls.__name__, (Skippable, cls), {
            "_stash_names": stash_names,
            "_pop_names": pop_names,
            "forward": forward,
            "__module__": cls.__module__,
            "__qualname__": cls.__qualname__,
        })

    return decorate


def _resolve_ns(name: str, ns: Optional[Namespace]) -> Namespace:
    if ns is not None:
        return ns
    inst = _active.get()
    if inst is not None:
        return inst.ns_of(name)
    return _GLOBAL_NS


def stash(name: str, value, ns: Optional[Namespace] = None) -> None:
    """Record ``value`` under ``name`` for a later stage's :func:`pop`."""
    scope = current_skip_tracker()
    scope.tracker.save(scope.microbatch, _resolve_ns(name, ns), name, value)


def pop(name: str, ns: Optional[Namespace] = None):
    """Retrieve (and consume) the value stashed under ``name``."""
    scope = current_skip_tracker()
    return scope.tracker.load(scope.microbatch, _resolve_ns(name, ns), name)


def verify_skippables(module) -> None:
    """Fail-fast static check of stash/pop pairing over a ``Sequential``.

    Every pop must have exactly one earlier stash of the same ``(ns, name)``;
    a name must not be stashed twice; every stash must be popped.
    """
    stashed: Set[Tuple[object, str]] = set()
    popped: Set[Tuple[object, str]] = set()
    msgs = []

    for i, layer in enumerate(module):
        for key in sorted(getattr(layer, "stashes", ()),
                          key=lambda k: (id(k[0]), k[1])):
            if key in stashed:
                msgs.append(f"layer {i}: '{key[1]}' is stashed twice")
            stashed.add(key)
        for key in sorted(getattr(layer, "pops", ()),
                          key=lambda k: (id(k[0]), k[1])):
            if key not in stashed:
                msgs.append(
                    f"layer {i}: '{key[1]}' is popped before it is stashed")
            elif key in popped:
                msgs.append(f"layer {i}: '{key[1]}' is popped twice")
            popped.add(key)

    for key in stashed - popped:
        msgs.append(f"'{key[1]}' is stashed but never popped")

    if msgs:
        raise TypeError("skip connections are miswired:\n  " +
                        "\n  ".join(msgs))
