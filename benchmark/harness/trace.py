"""A short profiled stretch, reduced to what the per-layer readers read.

``torch.profiler`` over CPU and CUDA (the method of the port's
``tools/torch_slice_profile.py``): the device's busy time is the union of
its kernel and copy intervals (``obs/meters.py`` ``_merge_busy_ns``,
copied), kernels are summed by name, the device time launched inside a
named host range is the self device time of every host op that starts in
it, and each idle gap is named by the innermost host op running on the
window's thread at its middle.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, Iterable, List, Tuple

WINDOW = "bench:window"


def merge_intervals(events: Iterable[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(events):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its one-time start-up
    (CUPTI's) falls in set-up and not inside a window it would stall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Stretch:
    """Profile the enclosed code (``with Stretch() as st: ...``), then
    reduce it with :meth:`summary`."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self, range_prefixes: Tuple[str, ...] = ()) -> dict:
        """Kernels (name, start, end in seconds), the window, busy seconds,
        device seconds launched inside each named host range, and the idle
        gaps named by host op."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        window = [e for e in events if e.name == WINDOW
                  and e.device_type != cuda]
        w0, w1 = window[0].time_range.start, window[0].time_range.end
        kernels = [(e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("bench:", "table:", "chunk",
                                              "Optimizer."))]
        merged = merge_intervals((s, e) for _, s, e in kernels)
        busy_us = sum(e - s for s, e in merged)
        host = [e for e in events if e.device_type != cuda]
        launched = sorted((e.time_range.start,
                           getattr(e, "self_device_time_total", 0.0))
                          for e in host
                          if not e.name.startswith(range_prefixes + (WINDOW,)))
        starts = [t for t, _ in launched]
        ranges: Dict[str, float] = {}
        for e in host:
            for prefix in range_prefixes:
                if e.name.startswith(prefix):
                    lo = bisect.bisect_left(starts, e.time_range.start)
                    hi = bisect.bisect_left(starts, e.time_range.end)
                    ranges[prefix] = ranges.get(prefix, 0.0) + sum(
                        d for _, d in launched[lo:hi])
        thread = window[0].thread
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.thread == thread
                     and e.name != WINDOW)
        edges = [(w0, w0)] + merged + [(w1, w1)]
        spans = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
        gaps: Dict[str, float] = {}
        for (a, b), name in zip(spans, _innermost(ops, [(a + b) / 2
                                                         for a, b in spans])):
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
        return {
            "kernels": [(n, s / 1e6, e / 1e6) for n, s, e in kernels],
            "window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6,
            "range_device_s": {k: v / 1e6 for k, v in ranges.items()},
            "idle_gaps": gaps,
        }


def _innermost(ops: List[Tuple[float, float, str]], times: List[float]
               ) -> List[str]:
    """For each of the ascending ``times``, the innermost host op of one
    thread that covers it (ops of a thread nest, so a stack sweep finds
    it), or ``(no host op)``."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host op)")
    return out


def kernel_seconds(summary: dict, keys: Tuple[str, ...],
                   exclude: Tuple[str, ...] = ()) -> float:
    """Device seconds of the kernels whose lower-cased name holds one of
    ``keys`` and none of ``exclude``."""
    total = 0.0
    for name, s, e in summary["kernels"]:
        low = name.lower()
        if any(k in low for k in keys) and not any(x in low for x in exclude):
            total += e - s
    return total


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device ops that took the most time and the host ops under which
    the device sat idle longest, each as ``[name, seconds]``."""
    by_name: Dict[str, float] = {}
    for name, s, e in summary["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}

