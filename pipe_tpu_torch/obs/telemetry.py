"""Process-local metrics registry and per-step reporting.

Counterpart of ``pipe_tpu/obs/telemetry.py``:

* :class:`MetricsRegistry` -- counters, gauges, EWMA timers, log-scale
  histograms, copied: it imports only the standard library. It is
  process-local, dependency-free, and a cheap no-op when disabled: a disabled
  registry hands out shared null instruments whose methods do nothing (no
  allocation, no clock reads), so hot paths can instrument unconditionally.
  The serve engine, the generator and the trainer record into the default
  registry (:func:`get_registry`).
* :class:`StepReport` -- one training step folded into throughput, MFU/HFU,
  the analytic and measured bubble and the device memory peaks, with
  ``pipe_tpu``'s fields, ``to_json`` and ``scalar_items``.
* the FLOPs model (:func:`train_flops_per_token`, copied) and the card's
  own peak rates (:func:`peak_flops_per_chip`) and memory readers
  (:func:`device_memory_peaks`), on ``torch.cuda``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import math
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "EwmaTimer", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "null_registry", "labelled",
    "percentile_exact", "host_overhead_per_token", "NULL_INSTRUMENT",
    "StepReport", "train_flops_per_token", "peak_flops_per_chip",
    "device_memory_peaks", "card_name_and_power_limit",
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


# --------------------------------------------------------------------------
# FLOPs model (pipe_tpu/obs/telemetry.py, copied)
# --------------------------------------------------------------------------

def train_flops_per_token(cfg, checkpoint: str, chunks: int):
    """(required, hardware) FLOPs per trained token.

    MAC counting: per layer, QKV+out projections 4*d^2 and FFN 2*d*d_ff; the
    attention score/value matmuls add seq*d per token (causal halves the
    window); the decoder projection d*vocab. One MAC = 2 FLOPs; backward
    costs 2x forward. ``required`` is the standard MFU numerator (3x forward,
    no recompute); ``hardware`` adds the remat re-forward the executor
    actually runs: except_last remats chunks-1 of chunks micro-batches. Only
    the per-layer term remats: the policy wraps the stage body, not
    embed/decoder.

    ``cfg`` is duck-typed (``d_model``/``d_ff``/``n_layers``/``vocab``/
    ``seq_len``/``causal``) so obs does not import the model zoo.
    """
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    eff_s = cfg.seq_len / 2 if cfg.causal else cfg.seq_len
    layer_macs = L * (4 * d * d + 2 * d * ff + 2 * eff_s * d)
    macs = layer_macs + d * V
    remat = {"never": 0.0, "except_last": (chunks - 1) / chunks,
             "always": 1.0}[checkpoint]
    required = 2 * macs * 3
    hardware = required + 2 * layer_macs * remat
    return required, hardware


# Dense peak FLOP/s of the cards the port knows, by the math its matrix
# products run: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, without
# sparsity (FP32 66.9 TFLOP/s on the CUDA cores, TF32 494.7 and BF16/FP16
# 989.4 on the tensor cores), at the card's full 700 W power limit.
_PEAKS = (
    ("H100 80GB HBM3", {"fp32": 66.9e12, "tf32": 494.7e12,
                        "bf16": 989.4e12}),
)


def peak_flops_per_chip(compute_dtype=None, device=None) -> Optional[float]:
    """The card's dense peak FLOP/s for the math the port's matrix products
    run: bf16 under a 16-bit ``compute_dtype``, TF32 when
    ``torch.backends.cuda.matmul.allow_tf32`` is set, fp32 on the CUDA cores
    otherwise (the port's default). None for a CPU device (no peak is
    claimed there, so no MFU); an unknown card raises."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    if compute_dtype in (torch.bfloat16, torch.float16):
        math_kind = "bf16"
    elif torch.backends.cuda.matmul.allow_tf32:
        math_kind = "tf32"
    else:
        math_kind = "fp32"
    for tag, peaks in _PEAKS:
        if tag in name:
            return peaks[math_kind]
    raise ValueError(
        f"no peak FLOP/s known for {name!r}: add the card's data-sheet rates "
        f"to pipe_tpu_torch/obs/telemetry.py _PEAKS")


def card_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, as it
    prints it (the limit a peak rate assumes is 700 W), or None where there
    is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_memory_peaks(devices=None) -> Dict[str, Dict[str, int]]:
    """Per-device allocator figures under ``pipe_tpu``'s keys:
    ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit``
    (the card's total, ``mem_get_info``). ``devices`` defaults to every
    visible card; a CPU device gives ``{}``, as ``pipe_tpu``'s does on its
    CPU platform."""
    import torch

    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    elif not isinstance(devices, (list, tuple)):
        devices = [devices]
    out: Dict[str, Dict[str, int]] = {}
    for dev in map(torch.device, devices):
        if dev.type != "cuda":
            out[str(dev)] = {}
            continue
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out[str(dev)] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
        }
    return out


# --------------------------------------------------------------------------
# StepReport
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StepReport:
    """One step's telemetry, with ``pipe_tpu``'s fields.

    ``compute`` derives throughput and MFU/HFU from raw timings;
    ``to_json`` emits the artifact-schema dict (``metric``/``value``/
    ``unit`` head keys, then the context fields).
    """

    step: int
    wall_sec: float
    tokens: int
    n_stages: int = 1
    chunks: int = 1
    checkpoint: str = "never"
    schedule: Optional[str] = None
    loss: Optional[float] = None
    tokens_per_sec: float = 0.0
    tokens_per_sec_per_chip: float = 0.0
    mfu: Optional[float] = None
    hfu: Optional[float] = None
    analytic_bubble: Optional[float] = None
    measured_bubble: Optional[float] = None
    measured_bubble_method: Optional[str] = None
    memory: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    compile_inclusive: bool = False
    platform: Optional[str] = None
    device_kind: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def compute(cls, *, step: int, wall_sec: float, tokens: int,
                n_stages: int = 1, chunks: int = 1,
                checkpoint: str = "never", schedule: Optional[str] = None,
                loss: Optional[float] = None, model_cfg=None,
                analytic_bubble: Optional[float] = None,
                measured_bubble: Optional[float] = None,
                measured_bubble_method: Optional[str] = None,
                memory: Optional[Dict[str, Dict[str, int]]] = None,
                compile_inclusive: bool = False,
                peak_flops: Optional[float] = None,
                platform: Optional[str] = None,
                device_kind: Optional[str] = None,
                n_devices: Optional[int] = None,
                **extra: Any) -> "StepReport":
        """Fold raw timings into derived rates. ``model_cfg`` (an LMConfig-
        shaped object) enables MFU/HFU via :func:`train_flops_per_token`;
        ``peak_flops`` overrides :func:`peak_flops_per_chip` (no MFU where
        there is no peak: the CPU).

        ``n_devices`` is the number of devices the step ran on, which the
        per-chip rate divides by. It defaults to ``n_stages``, ``pipe_tpu``'s
        reading (a stage a chip), so a call with ``pipe_tpu``'s arguments
        gives its numbers; the port's ``Trainer`` runs every stage on one
        card and passes 1 (recorded in ``extra``)."""
        per_dev = max(n_stages if n_devices is None else n_devices, 1)
        if n_devices is not None:
            extra["n_devices"] = n_devices
        tps = tokens / wall_sec if wall_sec > 0 else 0.0
        mfu = hfu = None
        if model_cfg is not None and wall_sec > 0:
            req_tok, hw_tok = train_flops_per_token(model_cfg, checkpoint,
                                                    chunks)
            peak = peak_flops if peak_flops is not None \
                else peak_flops_per_chip()
            if peak:
                per_chip = tps / per_dev
                mfu = (req_tok * per_chip) / peak
                hfu = (hw_tok * per_chip) / peak
        return cls(step=step, wall_sec=wall_sec, tokens=tokens,
                   n_stages=n_stages, chunks=chunks, checkpoint=checkpoint,
                   schedule=schedule, loss=loss, tokens_per_sec=tps,
                   tokens_per_sec_per_chip=tps / per_dev,
                   mfu=mfu, hfu=hfu, analytic_bubble=analytic_bubble,
                   measured_bubble=measured_bubble,
                   measured_bubble_method=measured_bubble_method,
                   memory=memory or {}, compile_inclusive=compile_inclusive,
                   platform=platform, device_kind=device_kind, extra=extra)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "metric": "train_tokens_per_sec_per_chip",
            "value": round(self.tokens_per_sec_per_chip, 2),
            "unit": "tokens/s/chip",
            "step": self.step,
            "wall_sec": round(self.wall_sec, 6),
            "tokens": self.tokens,
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "n_stages": self.n_stages,
            "chunks": self.chunks,
            "checkpoint": self.checkpoint,
            "schedule": self.schedule,
            "mfu": round(self.mfu, 4) if self.mfu is not None else None,
            "hfu": round(self.hfu, 4) if self.hfu is not None else None,
            "analytic_bubble": (round(self.analytic_bubble, 4)
                                if self.analytic_bubble is not None else None),
            "measured_bubble": (round(self.measured_bubble, 4)
                                if self.measured_bubble is not None else None),
            "measured_bubble_method": self.measured_bubble_method,
            "final_loss": (round(self.loss, 4)
                           if self.loss is not None else None),
            "memory": self.memory,
            "compile_inclusive": self.compile_inclusive,
            "platform": self.platform,
            "device_kind": self.device_kind,
        }
        out.update(self.extra)
        return out

    def scalar_items(self) -> List[Tuple[str, float]]:
        """(tag, value) pairs for a ``ScalarWriter`` sink."""
        items: List[Tuple[str, float]] = [
            ("telemetry/tokens_per_sec", self.tokens_per_sec),
            ("telemetry/ms_step", self.wall_sec * 1e3),
        ]
        if self.loss is not None:
            items.append(("telemetry/loss", self.loss))
        if self.mfu is not None:
            items.append(("telemetry/mfu", self.mfu))
        if self.hfu is not None:
            items.append(("telemetry/hfu", self.hfu))
        if self.analytic_bubble is not None:
            items.append(("telemetry/analytic_bubble", self.analytic_bubble))
        if self.measured_bubble is not None:
            items.append(("telemetry/measured_bubble", self.measured_bubble))
        for dev, stats in self.memory.items():
            if "peak_bytes_in_use" in stats:
                items.append((f"telemetry/peak_gib/{dev}",
                              stats["peak_bytes_in_use"] / 2 ** 30))
        return items
