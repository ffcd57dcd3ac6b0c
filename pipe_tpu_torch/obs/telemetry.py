"""Process-local metrics registry: counters, gauges, EWMA timers and
log-scale histograms.

Counterpart of the registry part of ``pipe_tpu/obs/telemetry.py``, copied:
it imports only the standard library. :class:`MetricsRegistry` is
process-local, dependency-free, and a cheap no-op when disabled: a disabled
registry hands out shared null instruments whose methods do nothing (no
allocation, no clock reads), so hot paths can instrument unconditionally.
The serve engine and the generator record into the default registry
(:func:`get_registry`).

Not ported yet (ROADMAP.md A.7): ``StepReport``, the FLOPs model and the
per-device peak and memory readers, which are to be rewritten on
``torch.cuda`` with the card's own numbers.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time
from typing import Any, Dict, Optional

__all__ = [
    "Counter", "Gauge", "EwmaTimer", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "null_registry", "labelled",
    "percentile_exact", "host_overhead_per_token", "NULL_INSTRUMENT",
]


def _escape_label(value) -> str:
    """Escape the characters that carry structure in a labelled name
    (``\\ . { } , =``) so replica ids like ``host.1`` or ``a,b=c``
    cannot collide with a differently-labelled instrument or with the
    ``.``-suffixed export keys ``scalars()`` derives."""
    s = str(value)
    for ch in ("\\", ".", "{", "}", ",", "="):
        s = s.replace(ch, "\\" + ch)
    return s


def labelled(name: str, **labels) -> str:
    """Canonical labelled-instrument name: ``name{k=v,k2=v2}`` with keys
    sorted, so every call site derives the same registry key. The
    registry itself stays flat (one instrument per string) — labels are
    a *naming convention*, which keeps the null-registry fast path and
    the ``scalars()`` dump untouched while letting fleet consumers
    filter per-replica series by prefix (e.g.
    ``serve.fleet.replica.queue_depth{replica=2}``). Label *values* are
    escaped (:func:`_escape_label`) so structured replica ids stay
    collision-safe; plain ints and simple strings pass through
    unchanged."""
    if not labels:
        return name
    body = ",".join(f"{k}={_escape_label(labels[k])}" for k in sorted(labels))
    return f"{name}{{{body}}}"


# --------------------------------------------------------------------------
# Instruments
# --------------------------------------------------------------------------

class Counter:
    """Monotonic count (dispatches, cache hits, tokens, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar (tokens/sec, uniform_fastpath 0/1, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class EwmaTimer:
    """Duration tracker: count/total plus an exponential moving average.

    The EWMA (default alpha 0.1 ≈ a ~10-observation horizon) is the
    steady-state per-step number; ``total/count`` includes warmup/compile.
    """

    __slots__ = ("alpha", "count", "total", "ewma", "last")

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.count = 0
        self.total = 0.0
        self.ewma = 0.0
        self.last = 0.0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.last = seconds
        self.ewma = seconds if self.count == 1 else (
            self.alpha * seconds + (1.0 - self.alpha) * self.ewma)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)


class Histogram:
    """Log-scale latency histogram (powers of 2 from ~1 µs to ~1 h).

    Fixed 42-bucket layout keeps ``observe`` a bisect + increment; the
    percentile estimate returns the upper edge of the covering bucket
    (≤ 2x the true value — plenty for latency-distribution shape).
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    _EDGES = [2.0 ** e for e in range(-20, 12)]   # 0.95 µs .. 2048 s

    def __init__(self):
        self.counts = [0] * (len(self._EDGES) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(self._EDGES, seconds)] += 1
        self.count += 1
        self.sum += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the q-quantile (q in [0, 1])."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self._EDGES[i] if i < len(self._EDGES) else self.max
        return self.max

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min, "max": self.max,
                "p50": self.percentile(0.50), "p90": self.percentile(0.90),
                "p99": self.percentile(0.99)}


class _NullInstrument:
    """Shared do-nothing stand-in for every instrument type. ``time()``
    reads no clock, so a disabled registry costs one attribute call per
    instrumentation site and nothing else."""

    __slots__ = ()
    value = 0
    count = 0
    total = 0.0
    ewma = 0.0
    last = 0.0
    sum = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, seconds: float) -> None:
        pass

    def time(self):
        return _NULL_CONTEXT

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": 0}


_NULL_CONTEXT = contextlib.nullcontext()
NULL_INSTRUMENT = _NullInstrument()


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

class MetricsRegistry:
    """Named-instrument store. ``counter/gauge/timer/histogram`` create on
    first use and return the same object thereafter; a disabled registry
    returns the shared :data:`NULL_INSTRUMENT` and records nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        if not self.enabled:
            return NULL_INSTRUMENT
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(name, factory())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name: str, alpha: float = 0.1) -> EwmaTimer:
        return self._get(name, lambda: EwmaTimer(alpha))

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, *, mergeable: bool = False,
                 base: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """All instruments as plain data.

        Default form (``mergeable=False``): histograms/timers as summary
        dicts, counters/gauges as raw values — the human-readable shape
        the event log and bench artifacts record.

        ``mergeable=True`` emits the *wire* form the fleet obs plane
        ships between processes: typed records that another registry can
        fold in with :meth:`merge_snapshot` — counters as **deltas**
        (``{"k": "c", "d": n}``), gauges as last-value
        (``{"k": "g", "v": x}``), timers as count/total deltas plus
        last-value ewma (``{"k": "t", ...}``), histograms as sparse
        per-bucket **count deltas** over the shared log2 edges
        (``{"k": "h", "b": [[bucket, d], ...], ...}``) so percentile
        shape survives merging. ``base`` is the caller's delta ledger (a
        mutable dict, updated in place): pass the same dict every call
        and each snapshot carries only what changed since the last one.
        Zero-delta instruments are omitted, which bounds frame size on
        quiet replicas.
        """
        if mergeable:
            return self._mergeable_snapshot(base if base is not None else {})
        out: Dict[str, Any] = {}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, (Counter, Gauge)):
                out[name] = inst.value
            elif isinstance(inst, EwmaTimer):
                out[name] = {"count": inst.count, "total": inst.total,
                             "ewma": inst.ewma, "last": inst.last}
            else:
                out[name] = inst.summary()
        return out

    def _mergeable_snapshot(self, base: Dict[str, Any]) -> Dict[str, Any]:
        # shipped from a telemetry thread while the tick thread creates
        # instruments: copy the name->instrument map under the lock
        with self._lock:
            items = sorted(self._instruments.items())
        out: Dict[str, Any] = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                prev = base.get(name, 0)
                if inst.value != prev:
                    out[name] = {"k": "c", "d": inst.value - prev}
                    base[name] = inst.value
            elif isinstance(inst, Gauge):
                if base.get(name) != inst.value:
                    out[name] = {"k": "g", "v": inst.value}
                    base[name] = inst.value
            elif isinstance(inst, EwmaTimer):
                pc, pt = base.get(name, (0, 0.0))
                if inst.count != pc:
                    out[name] = {"k": "t", "dc": inst.count - pc,
                                 "dt": inst.total - pt, "ewma": inst.ewma,
                                 "last": inst.last, "alpha": inst.alpha}
                    base[name] = (inst.count, inst.total)
            elif isinstance(inst, Histogram):
                prev_counts = base.get(name)
                if prev_counts is None:
                    prev_counts = [0] * len(inst.counts)
                buckets = [[i, c - prev_counts[i]]
                           for i, c in enumerate(inst.counts)
                           if c != prev_counts[i]]
                if buckets:
                    dn = sum(d for _, d in buckets)
                    ds = inst.sum - base.get(name + "\0sum", 0.0)
                    out[name] = {"k": "h", "b": buckets, "dn": dn, "ds": ds,
                                 "min": (None if inst.min is math.inf
                                         else inst.min),
                                 "max": inst.max}
                    base[name] = list(inst.counts)
                    base[name + "\0sum"] = inst.sum
        return out

    def merge_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fold a ``snapshot(mergeable=True)`` dict from another registry
        (typically another process's) into this one: counter deltas add,
        gauges last-write-win, timer count/total add (ewma/last taken
        from the source — the shipper's steady-state view), histogram
        bucket deltas add bucket-wise so merged percentiles stay exact
        at bucket resolution. Instruments are created on first sight;
        merging into a disabled registry is a no-op."""
        if not self.enabled:
            return
        for name, rec in snap.items():
            kind = rec.get("k") if isinstance(rec, dict) else None
            if kind == "c":
                self.counter(name).inc(rec["d"])
            elif kind == "g":
                self.gauge(name).set(rec["v"])
            elif kind == "t":
                t = self.timer(name, rec.get("alpha", 0.1))
                t.count += rec["dc"]
                t.total += rec["dt"]
                t.ewma = rec["ewma"]
                t.last = rec["last"]
            elif kind == "h":
                h = self.histogram(name)
                for i, d in rec["b"]:
                    h.counts[i] += d
                h.count += rec["dn"]
                h.sum += rec["ds"]
                if rec.get("min") is not None:
                    h.min = min(h.min, rec["min"])
                h.max = max(h.max, rec["max"])

    def scalars(self) -> Dict[str, float]:
        """Flat name → float view for ``ScalarWriter`` export (timer →
        ``name.ewma``, histogram → ``name.p50``/``name.p99``)."""
        out: Dict[str, float] = {}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, (Counter, Gauge)):
                out[name] = float(inst.value)
            elif isinstance(inst, EwmaTimer):
                if inst.count:
                    out[f"{name}.ewma"] = inst.ewma
            elif inst.count:
                out[f"{name}.p50"] = inst.percentile(0.50)
                out[f"{name}.p99"] = inst.percentile(0.99)
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_default_registry = MetricsRegistry(enabled=True)
_NULL_REGISTRY = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    """The process-local default registry (enabled unless replaced)."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests, or ``null_registry()`` to disable
    all default-registry instrumentation). Returns the previous one."""
    global _default_registry
    prev, _default_registry = _default_registry, registry
    return prev


def null_registry() -> MetricsRegistry:
    """The shared disabled registry — every instrument is a no-op."""
    return _NULL_REGISTRY


def percentile_exact(values, q: float) -> float:
    """Exact q-quantile (nearest-rank, q in [0, 1]) of raw samples.

    :class:`Histogram` trades precision for O(1) memory — its percentile
    is a power-of-2 upper edge, up to 2x above the true value. Reported
    latencies (TTFT p50/p99) keep the raw samples and use this instead, so
    the numbers are exact."""
    vals = sorted(values)
    if not vals:
        return 0.0
    rank = min(len(vals), max(1, math.ceil(q * len(vals))))
    return float(vals[rank - 1])


def host_overhead_per_token(registry: Optional[MetricsRegistry] = None
                            ) -> float:
    """Cumulative host-side serve overhead per emitted token, in seconds.

    ``ServeEngine.tick`` accumulates every second of a tick NOT spent
    inside the backend decode launch into the
    ``serve.engine.host_sec`` timer (reap + admission checks + token
    readout + gauge upkeep), and counts emitted tokens in
    ``serve.engine.tokens``; their ratio is the per-token tax the host
    charges no matter how fast the device program is. 0.0 until the
    engine has served anything."""
    reg = registry if registry is not None else get_registry()
    toks = reg.counter("serve.engine.tokens").value
    if not toks:
        return 0.0
    return reg.timer("serve.engine.host_sec").total / toks
