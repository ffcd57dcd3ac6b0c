"""The fleet observability plane: cross-process metrics, distributed
request traces, and the SLO monitor.

Counterpart of ``pipe_tpu/obs/fleet_obs.py``, copied (standard library
only).

Process replicas (:mod:`..fleet.proc`) keep every child's
``serve.*`` metrics and request events inside its own interpreter.
This module is the parent-side half of the plane that brings them back:

* **Metrics shipping.** Children snapshot their
  :class:`~.telemetry.MetricsRegistry` as mergeable deltas (counters as
  deltas, gauges last-value, histograms as sparse log2-bucket deltas —
  ``MetricsRegistry.snapshot(mergeable=True)``) and piggyback them on
  the heartbeat cadence as bounded, droppable ``obs`` frames
  (:mod:`..fleet.proc`). :class:`FleetObserver` folds the per-replica
  merged views into labelled per-replica dicts plus one fleet rollup
  registry, with a staleness age per replica. In-process and threaded
  fleets have no wire — the observer reads the shared process registry
  and the engines directly, so one test matrix covers all three
  ``--fleet`` modes.

* **Distributed tracing.** A ``trace_id`` minted at
  ``RequestQueue.submit`` rides the request through placement, retry
  park, KV handoff and failover (including across the process wire).
  The controller and the engines emit ``request``-kind events tagged
  ``trace``/``stage``/``attempts``; child events ship home on obs
  frames; :meth:`FleetObserver.stitch` merges parent + child streams
  into one causally-ordered timeline per request. The order key is
  ``(attempts, stage rank, t)`` — placement attempt number first, so a
  SIGKILL failover reads as ONE trace with TWO placement spans, in
  order, even though the two replicas' clocks are unrelated.

* **SLO monitoring.** :class:`SloMonitor` computes TTFT / end-to-end
  latency percentiles from the merged histograms plus goodput,
  deadline-miss and shed rates, and scores them against declared
  :class:`SloTargets` into a machine-readable verdict dict — the
  planner-feedback hook. :func:`prometheus_text`
  renders any registry in the Prometheus text exposition format for
  ``apps/serve.py --metrics-port``.

Nothing here imports serve/fleet modules — the observer takes the
controller duck-typed — so the child worker can import
:class:`TraceBuffer` without dragging the control plane into every
replica process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .events import EventLog
from .telemetry import Counter, EwmaTimer, Gauge, Histogram, \
    MetricsRegistry, get_registry, labelled

__all__ = ["TraceBuffer", "FleetObserver", "SloTargets", "SloMonitor",
           "prometheus_text", "STAGE_RANK"]


# ---------------------------------------------------------------------------
# child-side trace capture


class TraceBuffer:
    """Bounded in-memory :class:`~.events.EventLog` stand-in for replica
    child processes: same recording surface, but records land in a
    deque (oldest dropped at capacity, counted in ``dropped``) that the
    obs shipper drains onto the wire. No file, no fsync — a replica's
    trace events are telemetry, and telemetry is droppable."""

    path = None

    def __init__(self, maxlen: int = 4096):
        self._dq: "deque[Dict[str, Any]]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self._t0 = time.perf_counter()
        self.dropped = 0

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._dq) == self._dq.maxlen:
                self.dropped += 1
            self._dq.append(rec)

    def _alloc_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def event(self, kind: str, **attrs: Any) -> None:
        stack = self._stack()
        rec = {"kind": kind, "id": self._alloc_id(),
               "parent": stack[-1] if stack else None,
               "t": time.perf_counter() - self._t0}
        rec.update(attrs)
        self._push(rec)

    @contextlib.contextmanager
    def span(self, kind: str, **attrs: Any):
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
            self._push(rec)

    def step_report(self, report) -> None:
        payload = report.to_json() if hasattr(report, "to_json") else report
        self.event("step_report", **payload)

    def metrics_snapshot(self, registry) -> None:
        self.event("metrics", metrics=registry.snapshot())

    def drain(self) -> List[Dict[str, Any]]:
        """Remove and return everything buffered (oldest first)."""
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
        return out

    def peek(self) -> List[Dict[str, Any]]:
        """Everything buffered (oldest first) WITHOUT draining — what
        an observer holding a live buffer as ``parent_events`` reads,
        so stitching never steals records from the shipper."""
        with self._lock:
            return list(self._dq)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "TraceBuffer":
        return self

    def __exit__(self, *exc) -> None:
        pass


# ---------------------------------------------------------------------------
# trace stitching


# Causal order of one placement cycle. The sort key is
# (attempts, STAGE_RANK, t): the attempt number dominates — stage "t"
# fields come from UNRELATED clocks (parent vs each child) and are only
# comparable within one source — so a failed-over request reads
# queued -> placed(1) -> prefill(1) -> ... -> retry_parked(1) ->
# handoff(1) -> placed(2) -> ... -> delivered, two placement spans in
# one trace.
STAGE_RANK = {"queued": 0, "placed": 1, "prefill": 2, "decode": 3,
              "terminal": 4, "retry_parked": 5, "handoff": 6,
              "delivered": 7}


def _trace_sort_key(rec: Dict[str, Any]) -> Tuple:
    return (int(rec.get("attempts") or 0),
            STAGE_RANK.get(rec.get("stage"), 3),
            float(rec.get("t") or 0.0))


# ---------------------------------------------------------------------------
# the observer


class FleetObserver:
    """Parent-side merge point of the fleet observability plane.

    ``controller`` is a :class:`~..fleet.control.FleetController` (or
    :class:`~..serve.router.Router`), duck-typed: the observer walks
    ``controller.replicas`` and asks each transport for its
    ``obs_view()`` — process transports return the shipped
    ``(registry, age_s, seq, events)`` view; in-process transports
    return None and the observer reads the shared process registry and
    the engine directly (no wire, staleness 0). ``parent_events`` is
    the controller's event-log path (defaults to
    ``controller.events.path`` when that log writes to a file) or an
    already-read list of records — the parent half of every trace.
    """

    def __init__(self, controller, parent_events=None):
        self.controller = controller
        if parent_events is None:
            parent_events = getattr(getattr(controller, "events", None),
                                    "path", None)
        self.parent_events = parent_events

    # -- per-replica views -------------------------------------------------

    def per_replica(self) -> Dict[int, Dict[str, Any]]:
        """One labelled view per replica: health state, load, the
        delivery-synchronized ``tokens_out``/``responses_out`` counters,
        and — for shipped transports — the merged metrics snapshot with
        its staleness age (seconds since the newest obs frame; None
        before the first). In-process replicas read fresh
        (``staleness_s`` 0.0) straight off the engine."""
        out: Dict[int, Dict[str, Any]] = {}
        for rep in self.controller.replicas:
            tr = rep.transport
            view: Dict[str, Any] = {
                "state": rep.state,
                "role": getattr(rep, "role", "mixed"),
                "queue_depth": self._safe(lambda t=tr: t.queue_depth, 0),
                "live_slots": self._safe(lambda t=tr: t.live_slots, 0),
                "tokens_out": int(getattr(tr, "obs_tokens_out", 0)),
                "responses_out": int(getattr(tr, "obs_responses_out", 0)),
            }
            shipped = tr.obs_view()
            if shipped is not None:
                reg, age, seq, _events = shipped
                view.update(shipped=True, staleness_s=age, obs_seq=seq,
                            metrics=reg.snapshot())
            else:
                eng = getattr(tr, "engine", None)
                view.update(shipped=False, staleness_s=0.0, obs_seq=None,
                            metrics=self._inproc_metrics(rep.index))
                if eng is not None:
                    view["queue_depth"] = eng.queue.depth
                    view["live_slots"] = eng.live_slots
            # KV gen-2 directory view: digest count + block occupancy as
            # the controller's placement sees them (heartbeat-stale for
            # shipped transports, fresh in-process); absent for slab
            # replicas and unarmed process fleets
            d = self._safe(lambda t=tr: t.prefix_directory(), None)
            if d:
                view["kv"] = {
                    "digests": len(d.get("digests", ())),
                    "occupancy": d.get("occupancy"),
                    "blocks_free": d.get("blocks_free"),
                    "blocks_total": d.get("blocks_total"),
                }
            # durable-journal lag: seconds since the controller's last
            # fsync'd lifecycle record (None for journal-less fleets) —
            # fleet-wide, repeated per row so fleet_top can render it
            jr = getattr(self.controller, "journal", None)
            if jr is not None:
                view["journal_lag_s"] = self._safe(
                    lambda j=jr: j.fsync_age_s, None)
            out[rep.index] = view
        return out

    @staticmethod
    def _safe(fn, default):
        try:
            return fn()
        except Exception:
            return default

    @staticmethod
    def _inproc_metrics(index: int) -> Dict[str, Any]:
        """The shared process registry's per-replica series for one
        in-process replica: every labelled instrument carrying
        ``replica=<index>``."""
        needle_mid = f"replica={index},"
        needle_end = f"replica={index}}}"
        snap = get_registry().snapshot()
        return {name: val for name, val in snap.items()
                if "{" in name and (needle_mid in name.split("{", 1)[1]
                                    or needle_end in name.split("{", 1)[1])}

    # -- fleet rollup ------------------------------------------------------

    def rollup(self) -> MetricsRegistry:
        """One merged registry for the whole fleet: the parent process
        registry (fleet counters; for in-process fleets also every
        replica's engine counters — they share it) folded together with
        each shipped replica registry. Histograms merge bucket-wise, so
        fleet percentiles are computed over every replica's
        observations."""
        out = MetricsRegistry()
        out.merge_snapshot(get_registry().snapshot(mergeable=True, base={}))
        for rep in self.controller.replicas:
            shipped = rep.transport.obs_view()
            if shipped is not None:
                out.merge_snapshot(
                    shipped[0].snapshot(mergeable=True, base={}))
        return out

    def role_rollup(self) -> Dict[str, Dict[str, Any]]:
        """Per-role aggregation of the per-replica views — the number
        disaggregation is judged by: the prefill pool's TTFT and the
        decode pool's token output split out instead of averaged into
        one fleet-wide blur. Per role: replica/HEALTHY counts, summed
        load and output counters, bucket-merged ``ttft_sec`` /
        ``token_sec`` means where a replica's metrics view carries them
        (shipped replicas always do; in-process replicas share one
        unlabelled registry, so their phase histograms can't be split
        and read as None), plus the parent-side
        ``serve.fleet.handoff_requests{role=...}`` counter."""
        per = self.per_replica()
        out: Dict[str, Dict[str, Any]] = {}
        for rep in self.controller.replicas:
            view = per[rep.index]
            agg = out.setdefault(view["role"], {
                "replicas": 0, "healthy": 0, "tokens_out": 0,
                "responses_out": 0, "queue_depth": 0, "live_slots": 0,
                "_ttft": None, "_token_sec": None})
            agg["replicas"] += 1
            if view["state"] == "healthy":
                agg["healthy"] += 1
            for k in ("tokens_out", "responses_out", "queue_depth",
                      "live_slots"):
                agg[k] += int(view[k] or 0)
            m = view.get("metrics") or {}
            for key, slot in (("serve.engine.ttft_sec", "_ttft"),
                              ("serve.engine.token_sec", "_token_sec")):
                s = m.get(key)
                if isinstance(s, dict) and s.get("count"):
                    cur = agg[slot]
                    if cur is None:
                        agg[slot] = {"count": int(s["count"]),
                                     "sum": float(s.get("sum", 0.0))}
                    else:
                        cur["count"] += int(s["count"])
                        cur["sum"] += float(s.get("sum", 0.0))
        snap = get_registry().snapshot()
        for role, agg in out.items():
            for slot, name in (("_ttft", "ttft_mean_s"),
                               ("_token_sec", "token_mean_s")):
                s = agg.pop(slot)
                agg[name] = (s["sum"] / s["count"]) if s else None
            agg["handoff_requests"] = int(snap.get(
                labelled("serve.fleet.handoff_requests", role=role), 0))
        return out

    def reconcile(self) -> Dict[str, Any]:
        """The delivered-token reconciliation the drill asserts: the
        per-replica ``tokens_out`` counters (bumped at the instant each
        terminal response crossed into the control plane) must sum to
        the parent-observed delivered total — exactly-once made
        visible in telemetry. A disaggregated controller additionally
        reports the shadow tokens it consumed (each prefill phase's
        one-token terminal, counted by the prefill replica's transport
        but never client-delivered); they sit on the delivered side of
        the balance."""
        per = {rep.index: int(getattr(rep.transport, "obs_tokens_out", 0))
               for rep in self.controller.replicas}
        delivered = sum(len(r.tokens)
                        for r in self.controller._responses.values())
        shadow = int(getattr(self.controller, "obs_shadow_tokens", 0))
        total = sum(per.values())
        return {"per_replica_tokens_out": per, "tokens_out_sum": total,
                "delivered_tokens": delivered, "shadow_tokens": shadow,
                "reconciled": total == delivered + shadow}

    # -- trace stitching ---------------------------------------------------

    def _parent_records(self) -> List[Dict[str, Any]]:
        src = self.parent_events
        if src is None:
            return []
        if isinstance(src, str):
            return EventLog.read(src)
        if hasattr(src, "peek"):       # a live TraceBuffer: non-mutating
            return src.peek()
        return list(src)

    def stitch(self) -> Dict[str, List[Dict[str, Any]]]:
        """Merge the parent event log with every replica's shipped
        trace events into one causally-ordered timeline per request,
        keyed by ``trace_id`` (requests predating a trace id group
        under ``req:<id>``). Each record gains ``src`` ("parent" or
        "replica<i>"); ordering is ``(attempts, stage rank, t)`` — see
        :data:`STAGE_RANK` for why wall-clock alone cannot order a
        cross-process trace."""
        streams: List[Tuple[str, List[Dict[str, Any]]]] = [
            ("parent", self._parent_records())]
        for rep in self.controller.replicas:
            shipped = rep.transport.obs_view()
            if shipped is not None:
                streams.append((f"replica{rep.index}", shipped[3]))
        traces: Dict[str, List[Dict[str, Any]]] = {}
        for src, records in streams:
            for rec in records:
                trace = rec.get("trace")
                if trace is None:
                    if rec.get("kind") != "request" \
                            or rec.get("request") is None:
                        continue
                    trace = f"req:{rec['request']}"
                tagged = dict(rec, src=src, trace=trace)
                traces.setdefault(trace, []).append(tagged)
        for recs in traces.values():
            recs.sort(key=_trace_sort_key)
        return traces

    def stitch_by_request(self) -> Dict[int, List[Dict[str, Any]]]:
        """:meth:`stitch` re-keyed by request id (the bench/test
        handle). A request id maps to exactly ONE trace — trace ids are
        minted once and survive failover — so this is a bijection over
        delivered requests; the quick-drill assertion in ``bench.py``
        leans on that."""
        out: Dict[int, List[Dict[str, Any]]] = {}
        for recs in self.stitch().values():
            rids = {r.get("request") for r in recs
                    if r.get("request") is not None}
            for rid in rids:
                out.setdefault(int(rid), []).extend(
                    [r for r in recs if r.get("request") == rid])
        for recs in out.values():
            recs.sort(key=_trace_sort_key)
        return out

    def write_stitched(self, path: str) -> int:
        """Write the stitched timelines as JSONL — records grouped by
        trace, causally ordered within each — and return the record
        count."""
        traces = self.stitch()
        n = 0
        with open(path, "w") as f:
            for trace in sorted(traces):
                for rec in traces[trace]:
                    f.write(json.dumps(rec) + "\n")
                    n += 1
        return n


# ---------------------------------------------------------------------------
# SLO monitor


@dataclasses.dataclass
class SloTargets:
    """Declared service-level objectives. None disables a check.
    Latency targets are seconds; rate targets are fractions of
    delivered requests (goodput = ok / delivered, so 0.95 means at
    most 5% of terminals may be non-ok)."""

    ttft_p50_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    e2e_p99_s: Optional[float] = None
    goodput_min: Optional[float] = None
    deadline_miss_max: Optional[float] = None
    shed_max: Optional[float] = None


class SloMonitor:
    """Scores a merged fleet registry against :class:`SloTargets`.

    The verdict dict is the machine-readable planner hook::

        {"ok": bool, "violations": [{"slo", "target", "observed"}, ...],
         "targets": {...}, "observed": {"ttft_p50_s", "ttft_p99_s",
         "e2e_p99_s", "goodput", "deadline_miss_rate", "shed_rate",
         "delivered", "ok_count"}}

    Percentiles come from the merged log2 histograms, so they are
    upper-edge estimates (≤ 2x true) over EVERY replica's
    observations, not one process's view.
    """

    def __init__(self, targets: Optional[SloTargets] = None):
        self.targets = targets or SloTargets()

    def observe(self, registry: MetricsRegistry) -> Dict[str, Any]:
        ttft = registry.histogram("serve.engine.ttft_sec")
        e2e = registry.histogram("serve.engine.e2e_sec")
        delivered = registry.counter("serve.fleet.delivered").value
        ok = registry.counter("serve.fleet.ok").value
        timed_out = registry.counter("serve.engine.timed_out").value
        shed = registry.counter("serve.engine.shed").value
        denom = max(delivered, 1)
        return {
            "ttft_p50_s": ttft.percentile(0.50),
            "ttft_p99_s": ttft.percentile(0.99),
            "e2e_p99_s": e2e.percentile(0.99),
            "goodput": ok / denom,
            "deadline_miss_rate": timed_out / denom,
            "shed_rate": shed / denom,
            "delivered": delivered,
            "ok_count": ok,
        }

    def verdict(self, registry: MetricsRegistry) -> Dict[str, Any]:
        obs = self.observe(registry)
        t = self.targets
        checks = [
            ("ttft_p50_s", t.ttft_p50_s, obs["ttft_p50_s"], "max"),
            ("ttft_p99_s", t.ttft_p99_s, obs["ttft_p99_s"], "max"),
            ("e2e_p99_s", t.e2e_p99_s, obs["e2e_p99_s"], "max"),
            ("goodput_min", t.goodput_min, obs["goodput"], "min"),
            ("deadline_miss_max", t.deadline_miss_max,
             obs["deadline_miss_rate"], "max"),
            ("shed_max", t.shed_max, obs["shed_rate"], "max"),
        ]
        violations = []
        for slo, target, observed, sense in checks:
            if target is None:
                continue
            bad = observed > target if sense == "max" else observed < target
            if bad:
                violations.append({"slo": slo, "target": target,
                                   "observed": observed})
        return {"ok": not violations, "violations": violations,
                "targets": {k: v for k, v in
                            dataclasses.asdict(t).items() if v is not None},
                "observed": obs}


# ---------------------------------------------------------------------------
# Prometheus text exposition


def _prom_name(name: str) -> Tuple[str, str]:
    """Split a registry name into a Prometheus metric name + label
    block. ``serve.fleet.replica.state{replica=0}`` →
    (``serve_fleet_replica_state``, ``{replica="0"}``); label values
    un-escape the :func:`~.telemetry.labelled` escaping and re-quote."""
    labels = ""
    if "{" in name and name.endswith("}"):
        name, body = name.split("{", 1)
        body = body[:-1]
        parts, cur, esc = [], "", False
        for ch in body:
            if esc:
                cur += ch
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == ",":
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        if cur:
            parts.append(cur)
        rendered = []
        for part in parts:
            k, _, v = part.partition("=")
            v = v.replace("\\", "\\\\").replace('"', '\\"')
            rendered.append(f'{k}="{v}"')
        labels = "{" + ",".join(rendered) + "}"
    base = "".join(ch if ch.isalnum() or ch == "_" else "_"
                   for ch in name)
    return base, labels


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render a registry in the Prometheus text exposition format
    (v0.0.4): counters/gauges as samples, timers as ``_count``/``_sum``
    plus an ``_ewma`` gauge, histograms as cumulative ``_bucket{le=}``
    series over the shared log2 edges plus ``_count``/``_sum``."""
    lines: List[str] = []
    with registry._lock:
        items = sorted(registry._instruments.items())
    for name, inst in items:
        base, labels = _prom_name(name)
        if isinstance(inst, Counter):
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base}{labels} {inst.value}")
        elif isinstance(inst, Gauge):
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base}{labels} {inst.value}")
        elif isinstance(inst, EwmaTimer):
            lines.append(f"# TYPE {base} summary")
            lines.append(f"{base}_count{labels} {inst.count}")
            lines.append(f"{base}_sum{labels} {inst.total}")
            lines.append(f"{base}_ewma{labels} {inst.ewma}")
        elif isinstance(inst, Histogram):
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for i, edge in enumerate(Histogram._EDGES):
                cum += inst.counts[i]
                le = labels[:-1] + "," if labels else "{"
                lines.append(f'{base}_bucket{le}le="{edge:g}"}} {cum}')
            le = labels[:-1] + "," if labels else "{"
            lines.append(f'{base}_bucket{le}le="+Inf"}} {inst.count}')
            lines.append(f"{base}_count{labels} {inst.count}")
            lines.append(f"{base}_sum{labels} {inst.sum}")
    return "\n".join(lines) + ("\n" if lines else "")
