"""Structured JSONL event log with nested spans.

Counterpart of ``pipe_tpu/obs/events.py``, copied: it imports only the
standard library. :class:`EventLog` records *host* structure — steps,
evaluation, serving calls, per-request spans — as one JSON object per
line, cheap enough to leave on in production loops.

Record schema (one dict per line)::

    {"kind": <str>, "id": <int>, "parent": <int|null>,
     "t": <sec since log open>, "dur": <sec, spans only>, ...attrs}

plus a ``log_open`` header carrying the wall-clock epoch so host events
can be correlated with profiler traces. Span kinds used by the built-in
wiring: ``step``, ``stage``, ``microbatch``, ``comm``,
``checkpoint-recompute``, ``request`` (:data:`SPAN_KINDS`);
``step_report`` records carry a step report's ``to_json`` payload (or a
plain dict).

Spans nest through a per-thread stack: ``parent`` is the id of the
innermost open span on the same thread. Records are written at span
*exit*, so children precede parents in the file; :meth:`EventLog.read`
returns them in file order and tests reconstruct the tree from
``id``/``parent``.

``NULL_EVENT_LOG`` is the disabled sink — same API, no file, no clock
reads beyond the context-manager protocol — so call sites never branch.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, IO, List, Optional

__all__ = ["EventLog", "NullEventLog", "NULL_EVENT_LOG", "SPAN_KINDS",
           "STEP", "STAGE", "MICROBATCH", "COMM", "RECOMPUTE", "REQUEST",
           "RECOVERY"]

STEP = "step"
STAGE = "stage"
MICROBATCH = "microbatch"
COMM = "comm"
RECOMPUTE = "checkpoint-recompute"
# serving: one record per retired request, written by the serve engine at
# retirement (``serve/engine.py``), and one per admission
REQUEST = "request"
# resilience: instantaneous records (not spans) written at every rung of
# the recovery ladder — skip/rewind (action=...) and the elastic path
# (stage_lost, replan, buddy_restore) — so a post-mortem can replay the
# escalation from the event log alone
RECOVERY = "recovery"
SPAN_KINDS = (STEP, STAGE, MICROBATCH, COMM, RECOMPUTE, REQUEST)


class EventLog:
    """Append-only JSONL event sink with nested span support.

    ``max_bytes`` arms size-bounded rotation: once the live file would
    exceed it, the file is renamed to ``<path>.1`` (replacing any
    previous rollover — at most two files ever exist) and a fresh file
    opens with a ``log_open`` header carrying ``rotated=True``. Long
    fleet drills keep at most ``2 * max_bytes`` on disk. A reader that
    races a writer (or a crash mid-line) can leave a torn final line;
    :meth:`read` tolerates exactly that — a final line that does not
    parse is dropped, a torn line anywhere else still raises."""

    def __init__(self, path: str, *, autoflush: bool = True,
                 max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes < 1024:
            raise ValueError(f"max_bytes must be >= 1024, got {max_bytes}")
        self.path = path
        self._autoflush = autoflush
        self._max_bytes = max_bytes
        self._file: Optional[IO[str]] = open(path, "a")
        self._written = self._file.tell()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self._t0 = time.perf_counter()
        self._write({"kind": "log_open", "wall_time": time.time(),
                     "id": self._alloc_id(), "parent": None, "t": 0.0})

    # -- plumbing ----------------------------------------------------------

    def _alloc_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record)
        with self._lock:
            if self._file is None:
                return
            if self._max_bytes is not None \
                    and self._written + len(line) + 1 > self._max_bytes \
                    and self._written > 0:
                self._rotate_locked()
            self._file.write(line + "\n")
            self._written += len(line) + 1
            if self._autoflush:
                self._file.flush()

    def _rotate_locked(self) -> None:
        """Roll the live file to ``<path>.1`` (caller holds the lock)."""
        self._file.close()
        os.replace(self.path, self.path + ".1")
        self._file = open(self.path, "a")
        self._written = 0
        header = json.dumps({"kind": "log_open", "wall_time": time.time(),
                             "id": self._alloc_id(), "parent": None,
                             "t": time.perf_counter() - self._t0,
                             "rotated": True})
        self._file.write(header + "\n")
        self._written += len(header) + 1

    # -- recording ---------------------------------------------------------

    def event(self, kind: str, **attrs: Any) -> None:
        """Instantaneous event under the current span (if any)."""
        stack = self._stack()
        rec = {"kind": kind, "id": self._alloc_id(),
               "parent": stack[-1] if stack else None,
               "t": time.perf_counter() - self._t0}
        rec.update(attrs)
        self._write(rec)

    @contextlib.contextmanager
    def span(self, kind: str, **attrs: Any):
        """Timed span; nests under the innermost open span on this thread."""
        stack = self._stack()
        span_id = self._alloc_id()
        parent = stack[-1] if stack else None
        stack.append(span_id)
        t0 = time.perf_counter()
        try:
            yield span_id
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            rec = {"kind": kind, "id": span_id, "parent": parent,
                   "t": t0 - self._t0, "dur": dur}
            rec.update(attrs)
            self._write(rec)

    def step_report(self, report) -> None:
        """Record a step report (anything with ``to_json``, or a plain
        dict)."""
        payload = report.to_json() if hasattr(report, "to_json") else report
        self.event("step_report", **payload)

    def metrics_snapshot(self, registry) -> None:
        """Record a registry snapshot (counters/gauges/timers/histograms)."""
        self.event("metrics", metrics=registry.snapshot())

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- readback ----------------------------------------------------------

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """All records in file order (children precede their parent span).

        A torn FINAL line — the one artifact a crash or a reader racing
        the writer can legitimately produce on an append-only file — is
        dropped silently; corruption anywhere else still raises."""
        with open(path) as f:
            lines = [ln.strip() for ln in f]
        while lines and not lines[-1]:
            lines.pop()
        out: List[Dict[str, Any]] = []
        for i, line in enumerate(lines):
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break
                raise
        return out


class NullEventLog:
    """Disabled sink: same surface as :class:`EventLog`, writes nothing."""

    path = None

    def event(self, kind: str, **attrs: Any) -> None:
        pass

    def span(self, kind: str, **attrs: Any):
        return contextlib.nullcontext(0)

    def step_report(self, report) -> None:
        pass

    def metrics_snapshot(self, registry) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullEventLog":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_EVENT_LOG = NullEventLog()
