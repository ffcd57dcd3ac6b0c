"""Profiling and observability utilities.

Counterpart of ``pipe_tpu/obs/meters.py`` on ``torch.profiler``:

* :func:`stage_scope` -- ``torch.profiler.record_function("chunk{i}-stage{j}")``,
  the label the emulator puts around every task's forward
  (``parallel/emulator.py``); while a profiler runs, :func:`mark_backward`
  opens the same label over the task's backward, so a stage's device time
  covers both passes;
* :func:`profile_trace` -- ``torch.profiler.profile`` over the CPU and, on a
  card, CUDA, synchronized before it stops and exported as a Chrome trace
  into ``logdir``;
* :func:`device_memory_report` -- the caching allocator's
  ``torch.cuda.memory_stats``;
* :class:`BubbleMeter`, :func:`measured_bubble_slope` and
  :func:`measured_bubble_two_point`, copied;
* :func:`stage_busy_from_trace` and :func:`stage_timeline_from_trace` read
  the exported Chrome trace (``pipe_tpu`` reads XLA's xplane protobufs,
  which torch does not write). Device busy time is the union of the
  kernel, memcpy and memset events of each device; per stage, device time
  is attributed through the ``gpu_user_annotation`` events Kineto puts on
  the GPU timeline for each ``record_function`` range. Without them (the
  CPU has no device events) the host ranges are used, and the result says
  which source it read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import threading
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

import torch

from ..core.schedule import Schedule, bubble_fraction

__all__ = ["stage_scope", "mark_backward", "profile_trace",
           "TRACE_FILE", "device_memory_report", "BubbleMeter",
           "stage_busy_from_trace", "stage_timeline_from_trace",
           "measured_bubble_slope", "measured_bubble_two_point"]

TRACE_FILE = "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the emulator's task ranges, and the table executor's op ranges
# (parallel/scheduled.py: table:F{i}-stage{s}, B and W alike)
_SCOPE_RE = re.compile(r"(?:chunk|table:[FBW])(\d+)-stage(\d+)")


def stage_label(microbatch: int, stage: int) -> str:
    return f"chunk{microbatch}-stage{stage}"


def stage_scope(microbatch: int, stage: int):
    """Profiler range attributing ops to (micro-batch, stage) in traces."""
    return torch.profiler.record_function(stage_label(microbatch, stage))


# --- backward ranges -------------------------------------------------------
#
# A task's backward has no call to wrap: autograd runs it later, node by node.
# While a profiler runs, the emulator threads each task's outputs through
# _BackwardRange, whose backward opens the task's label when the task's
# output gradients arrive and closes the label opened before it; a callback
# queued on the autograd engine closes the last one when the pass ends. The
# serial emulator's backward runs one task's nodes after another, so the
# ranges tile the pass.

_open_lock = threading.Lock()
_open: List = []          # [the RecordFunction handle of the open range]


def _close_open() -> None:
    with _open_lock:
        handle = _open.pop() if _open else None
    if handle is not None:
        torch.ops.profiler._record_function_exit(handle)


class _BackwardRange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, label, *xs):
        ctx.label = label
        outs = tuple(x.view_as(x) for x in xs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        _close_open()
        handle = torch.ops.profiler._record_function_enter_new(ctx.label,
                                                               None)
        with _open_lock:
            first = not _open
            _open.append(handle)
        if first:
            torch.autograd.Variable._execution_engine.queue_callback(
                _close_open)
        return (None, *grads)


def mark_backward(values: Tuple, microbatch: int, stage: int) -> Tuple:
    """``values`` with the tensors that need a gradient threaded through a
    backward range of the task's label; the same values when no profiler
    runs or nothing needs a gradient (no graph node is added then)."""
    if not (torch.autograd._profiler_enabled() and torch.is_grad_enabled()):
        return values
    idx = [k for k, v in enumerate(values)
           if isinstance(v, torch.Tensor) and v.requires_grad]
    if not idx:
        return values
    marked = _BackwardRange.apply(stage_label(microbatch, stage),
                                  *(values[k] for k in idx))
    if len(idx) == 1:
        marked = (marked,)
    out = list(values)
    for k, v in zip(idx, marked):
        out[k] = v
    return tuple(out)


# --- capture ---------------------------------------------------------------

@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed code into
    ``logdir/trace.json`` (Chrome trace format: Perfetto, chrome://tracing,
    TensorBoard's profile plugin). The CPU is traced always, CUDA where a
    card is present; the card is synchronized before the profiler stops, so
    the kernels the enclosed code queued are in the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def device_memory_report(device=None) -> str:
    """Human-readable summary of the caching allocator
    (``torch.cuda.memory_stats``) of ``device`` (default: the current card)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    lines = [f"device memory profile ({dev}):"]
    if dev.type != "cuda":
        lines.append("  no allocator statistics for a CPU device")
        return "\n".join(lines)
    stats = torch.cuda.memory_stats(dev)
    for key in ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                "reserved_bytes.all.current", "reserved_bytes.all.peak"):
        lines.append(f"  {key}: {stats.get(key, 0) / 2**30:.3f} GiB")
    lines.append(f"  num_alloc_retries: {stats.get('num_alloc_retries', 0)}")
    lines.append(f"  bytes_limit: "
                 f"{torch.cuda.mem_get_info(dev)[1] / 2**30:.3f} GiB")
    return "\n".join(lines)


# --- bubble accounting (copied) --------------------------------------------

@dataclasses.dataclass
class BubbleMeter:
    """Pipeline-bubble accounting for a (chunks m, stages n) configuration.

    ``analytic`` is the fill-drain model (n-1)/(m+n-1) (reference
    ``_clock_cycles`` cost model, ``pipeline.py:63-79``); ``measured`` can be
    filled from per-stage busy times (e.g. extracted from a profiler trace)
    to report the honest number next to the model.
    """

    chunks: int
    n_stages: int
    schedule: Optional[Schedule] = None

    @property
    def analytic(self) -> float:
        if self.schedule is not None:
            return self.schedule.bubble(self.chunks, self.n_stages)
        return bubble_fraction(self.chunks, self.n_stages)

    def measured(self, stage_busy_sec, wall_sec: float) -> float:
        """1 - busy/total from per-stage busy seconds and the step wall time."""
        total = self.n_stages * wall_sec
        busy = float(sum(stage_busy_sec))
        return max(0.0, 1.0 - busy / total) if total > 0 else 0.0

    def report(self) -> str:
        return (f"bubble[m={self.chunks}, n={self.n_stages}] "
                f"analytic={self.analytic:.2%}")


def _merge_intervals(events: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals (events overlap across lines)."""
    events = sorted(events)
    merged: List[Tuple[float, float]] = []
    for s, e in events:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _merge_busy_ns(events: List[Tuple[float, float]]) -> float:
    """Union length of [start, end) intervals."""
    return sum(e - s for s, e in _merge_intervals(events))


def measured_bubble_slope(t_m: float, t_2m: float, m: int) -> float:
    """Measured bubble from two step timings at ``m`` and ``2m``
    micro-batches: with per-micro-batch work held constant, a clock-cycle
    pipeline costs ``t(m) = c + a*(m + n - 1)``; the slope
    ``a = (t(2m) - t(m)) / m`` is the real per-cycle cost, and the bubble is
    the step-time fraction not spent on the ``m`` useful cycles,
    ``1 - m*a / t(m)``."""
    return measured_bubble_two_point(t_m, m, t_2m, 2 * m)


def measured_bubble_two_point(t_ref: float, m_ref: int,
                              t_other: float, m_other: int) -> float:
    """:func:`measured_bubble_slope` at any two micro-batch counts: the
    bubble is reported at the reference point ``(t_ref, m_ref)``; the other
    point only fixes the slope. The premise is a step time affine in the
    micro-batch count; fixed per-step costs (the optimizer update, launch
    latency) bias the slope low and the bubble high, so prefer the
    trace-based busy fraction where a device trace is available."""
    if t_ref <= 0 or m_other == m_ref:
        return 0.0
    a = max((t_other - t_ref) / (m_other - m_ref), 0.0)
    return max(0.0, 1.0 - (m_ref * a) / t_ref)


# --- trace readers -----------------------------------------------------------

def _load_events(logdir: str) -> List[dict]:
    """The complete (``ph == "X"``) events of every Chrome trace in
    ``logdir``, times in nanoseconds (``ts_ns``/``te_ns``)."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.json")))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) in {logdir}")
    out = []
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", doc if isinstance(doc, list) else []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            ts = float(ev["ts"]) * 1e3
            ev = dict(ev, ts_ns=ts, te_ns=ts + float(ev["dur"]) * 1e3)
            out.append(ev)
    return out


def _device_ops(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in _DEVICE_CATS]


def stage_busy_from_trace(logdir: str) -> Dict[str, float]:
    """Per-device busy seconds from a :func:`profile_trace` capture: the
    union of each device's kernel, memcpy and memset intervals over all its
    streams, keyed ``cuda:{device}``, plus a ``"_span"`` key holding the
    wall span of those events in seconds. A CPU capture has no device
    events and gives only ``{"_span": 0.0}``."""
    busy: Dict[str, List[Tuple[float, float]]] = {}
    lo, hi = float("inf"), 0.0
    for ev in _device_ops(_load_events(logdir)):
        busy.setdefault(f"cuda:{ev['pid']}", []).append(
            (ev["ts_ns"], ev["te_ns"]))
        lo, hi = min(lo, ev["ts_ns"]), max(hi, ev["te_ns"])
    out = {dev: _merge_busy_ns(iv) / 1e9 for dev, iv in sorted(busy.items())}
    out["_span"] = (hi - lo) / 1e9 if hi > lo else 0.0
    return out


def _scope(ev: dict) -> Optional[Tuple[int, int]]:
    m = _SCOPE_RE.fullmatch(ev.get("name", ""))
    return (int(m.group(1)), int(m.group(2))) if m else None


def _by_annotation(events: List[dict]):
    """(chunk, stage, start, end) of the device time inside each tagged
    ``gpu_user_annotation`` range, per stream; None if there are none."""
    ranges = [e for e in events if e.get("cat") == "gpu_user_annotation"
              and _scope(e)]
    if not ranges:
        return None
    ops: Dict[tuple, List[Tuple[float, float]]] = {}
    for e in _device_ops(events):
        ops.setdefault((e["pid"], e["tid"]), []).append(
            (e["ts_ns"], e["te_ns"]))
    for v in ops.values():
        v.sort()
    out = []
    for r in ranges:
        chunk, stage = _scope(r)
        lane = ops.get((r["pid"], r["tid"]), [])
        k = max(bisect_right(lane, (r["ts_ns"], float("inf"))) - 1, 0)
        while k < len(lane) and lane[k][0] < r["te_ns"]:
            s, e = max(lane[k][0], r["ts_ns"]), min(lane[k][1], r["te_ns"])
            if e > s:
                out.append((chunk, stage, s, e))
            k += 1
    return out


def stage_timeline_from_trace(logdir: str) -> Dict[str, object]:
    """Per-stage busy attribution bucketed by the ``chunk{i}-stage{j}``
    ranges (:func:`stage_scope`, :func:`mark_backward`) and the table
    executor's ``table:{F,B,W}{i}-stage{j}`` op ranges.

    Device source (``"cuda"``): each kernel, memcpy and memset is credited
    to the tagged ``gpu_user_annotation`` range it ran in; intervals are
    unioned per stage. Without such ranges (no device events) it falls back
    to the tagged host ranges (``"host"``), and reports which source it
    used.

    Returns ``pipe_tpu``'s shape::

        {"source": "cuda" | "host" | None,        # None: no tagged events
         "span": (lo_ns, hi_ns),                   # over tagged events
         "stages": {j: {"busy_sec": float,
                        "intervals": [(s_ns, e_ns), ...],   # merged
                        "chunks": {i: busy_sec}}}}
    """
    events = _load_events(logdir)
    tagged, source = None, None
    if _device_ops(events):
        tagged, source = _by_annotation(events), "cuda"
    if not tagged:
        tagged = [(*_scope(e), e["ts_ns"], e["te_ns"]) for e in events
                  if e.get("cat") == "user_annotation" and _scope(e)]
        source = "host"
    if not tagged:
        return {"source": None, "span": (0.0, 0.0), "stages": {}}
    raw: Dict[int, List[Tuple[float, float]]] = {}
    per_chunk: Dict[int, Dict[int, float]] = {}
    for chunk, stage, s, e in tagged:
        raw.setdefault(stage, []).append((s, e))
        ch = per_chunk.setdefault(stage, {})
        ch[chunk] = ch.get(chunk, 0.0) + (e - s) / 1e9
    lo = min(s for _, _, s, _ in tagged)
    hi = max(e for _, _, _, e in tagged)
    stages = {}
    for stage, intervals in sorted(raw.items()):
        merged = _merge_intervals(intervals)
        stages[stage] = {
            "busy_sec": sum(e - s for s, e in merged) / 1e9,
            "intervals": merged,
            "chunks": dict(sorted(per_chunk[stage].items())),
        }
    return {"source": source, "span": (lo, hi), "stages": stages}
