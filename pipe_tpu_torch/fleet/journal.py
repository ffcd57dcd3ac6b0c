"""Durable request journal: the control plane's lifecycle ledger as a
replayable on-disk artifact.

Counterpart of ``pipe_tpu/fleet/journal.py``, copied (standard library
only): the records have its kinds and fields.

The fleet survives any *replica* dying (the SIGKILL drills), but the
controller's exactly-once ledger, retry parks and disagg phase tags live
in parent memory — kill the parent and
every in-flight id is stranded. :class:`RequestJournal` fixes that the
same way ``train/state.py`` makes training restartable: every
lifecycle transition (submit, place, shadow-consume, park, deliver) is
appended to an fsync'd JSONL write-ahead log *before* the controller
acts on it, and :meth:`RequestJournal.recover` replays the log into a
:class:`JournalState` a fresh controller can rebuild itself from
(``FleetController.from_journal``).

Durability discipline, borrowed from ``train/state.py``:

* every appended record is flushed AND ``os.fsync``'d before the
  controller takes the journaled action — a SIGKILL between journal
  and action replays the action; a SIGKILL between action and the
  *next* journal record is reconciled against the live replicas
  (the rejoin handshake in ``fleet/proc.py`` asks each surviving
  child what it still holds);
* the ``fleet.json`` rejoin snapshot (replica wire coordinates) is
  written through the tmp + rename + dir-fsync sequence, so readers
  never observe a half-written file;
* :meth:`recover` tolerates a torn FINAL line — the one a crash
  mid-append can legally produce — and refuses a torn *middle* line
  loudly, mirroring :meth:`pipe_tpu_torch.obs.events.EventLog.read` exactly.

Record kinds (one JSON object per line, ``kind`` keyed):

==================  =====================================================
``open``            a journal writer attached (restart appends, so a log
                    may hold several)
``replica``         wire coordinates of one child replica — port, token,
                    pid, role, spec — everything the parent-side rejoin
                    handshake needs to re-dial a *running* child
``submit``          request accepted at the front door (full budget,
                    pre-clamp for disagg)
``place``           about to place on replica N (attempts = replay count)
``shadow``          disagg shadow-consume: prefill terminal swallowed,
                    request re-entering as its decode phase
``park``            about to park for backoff retry
``deliver``         about to record a terminal response (the
                    exactly-once hinge)
``clean_shutdown``  drain completed and the journal closed clean —
                    restart can skip reconciliation entirely
==================  =====================================================
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["RequestJournal", "JournalState", "JOURNAL_FILENAME",
           "META_FILENAME"]

JOURNAL_FILENAME = "journal.jsonl"
META_FILENAME = "fleet.json"

RECORD_KINDS = ("open", "replica", "submit", "place", "shadow", "park",
                "deliver", "clean_shutdown")


def _atomic_write_json(target: str, doc: dict) -> None:
    """tmp + rename + fsync (file AND directory), the ``train/state.py``
    discipline: a reader never sees a partial document and the rename
    survives power loss once the directory entry is synced."""
    d = os.path.dirname(target) or "."
    tmp = os.path.join(d, f".{os.path.basename(target)}.tmp")
    data = json.dumps(doc, indent=2, sort_keys=True).encode("utf-8")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, target)
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class JournalState:
    """The replayed journal: everything a fresh controller needs to
    rebuild its exactly-once ledger, retry parks and phase tags.

    ``requests``   id -> the ``submit`` record (full pre-clamp budget)
    ``terminal``   id -> the ``deliver`` record (already answered —
                   recovery instates a ledger stub so a duplicate
                   delivery still raises)
    ``placed_on``  id -> replica index of the LAST un-consumed
                   placement (reconciled against the live child)
    ``attempts``   id -> number of journaled placements (the retry
                   budget already spent)
    ``shadow``     id -> the ``shadow`` record for requests that
                   crossed the disagg prefill->decode hinge
    ``replicas``   index -> the latest ``replica`` wire record
    ``clean``      True iff the log ENDS with ``clean_shutdown``
    """

    def __init__(self) -> None:
        self.requests: Dict[int, dict] = {}
        self.terminal: Dict[int, dict] = {}
        self.placed_on: Dict[int, int] = {}
        self.attempts: Dict[int, int] = {}
        self.shadow: Dict[int, dict] = {}
        self.replicas: Dict[int, dict] = {}
        self.clean = False
        self.records = 0

    @property
    def orphans(self) -> List[int]:
        """Submitted ids with no terminal record — the in-flight set
        the crash stranded, in id order."""
        return sorted(i for i in self.requests if i not in self.terminal)

    @property
    def max_request_id(self) -> int:
        return max(self.requests, default=-1)

    def apply(self, rec: dict) -> None:
        kind = rec.get("kind")
        self.records += 1
        self.clean = kind == "clean_shutdown"
        if kind == "replica":
            self.replicas[int(rec["replica"])] = rec
        elif kind == "submit":
            self.requests[int(rec["request"])] = rec
        elif kind == "place":
            rid = int(rec["request"])
            self.placed_on[rid] = int(rec["replica"])
            self.attempts[rid] = self.attempts.get(rid, 0) + 1
        elif kind == "shadow":
            rid = int(rec["request"])
            self.shadow[rid] = rec
            # the shadow-consume pops the placement: the prefill slot
            # retired and the decode phase has not been placed yet
            self.placed_on.pop(rid, None)
        elif kind == "park":
            self.placed_on.pop(int(rec["request"]), None)
        elif kind == "deliver":
            rid = int(rec["request"])
            self.terminal[rid] = rec
            self.placed_on.pop(rid, None)


class RequestJournal:
    """Append-only, fsync'd JSONL write-ahead log of request lifecycle
    transitions. ``path`` is a directory (the journal lives at
    ``<path>/journal.jsonl`` with the ``fleet.json`` rejoin snapshot
    beside it) or an explicit ``*.jsonl`` file path. Opening an
    existing journal appends — restart continues the same history.

    ``fsync=False`` drops the per-record fsync (tests on tmpfs); the
    default matches the WAL contract.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        if path.endswith(".jsonl"):
            self.dir = os.path.dirname(path) or "."
            self.path = path
        else:
            self.dir = path
            self.path = os.path.join(path, JOURNAL_FILENAME)
        os.makedirs(self.dir, exist_ok=True)
        self._fsync = fsync
        self._lock = threading.Lock()
        self._fh = open(self.path, "ab")
        self.records_written = 0
        self.bytes_written = 0
        self.last_fsync_at: Optional[float] = None
        self._closed = False
        self.append("open", wall_time=time.time())

    # -- writing -----------------------------------------------------------

    def append(self, kind: str, **fields: Any) -> None:
        """Journal one transition: serialize, append, flush, fsync —
        durable before the caller acts on it."""
        if kind not in RECORD_KINDS:
            raise ValueError(
                f"unknown journal record kind {kind!r}; one of "
                f"{RECORD_KINDS}")
        rec = {"kind": kind}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=True).encode("utf-8") + b"\n"
        with self._lock:
            if self._closed:
                return
            self._fh.write(line)
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
            self.records_written += 1
            self.bytes_written += len(line)
            self.last_fsync_at = time.monotonic()

    def record_replica(self, index: int, **info: Any) -> None:
        """Journal one replica's wire coordinates (port, token, pid,
        role, spec, ...) and refresh the ``fleet.json`` rejoin snapshot
        through the tmp+rename discipline."""
        self.append("replica", replica=int(index), **info)
        try:
            state = self.recover(self.path)
        except Exception:
            return
        _atomic_write_json(
            os.path.join(self.dir, META_FILENAME),
            {"journal": self.path,
             "replicas": {str(i): r for i, r in state.replicas.items()}})

    def close(self, clean: bool = False) -> None:
        """Close the journal; ``clean=True`` stamps a final
        ``clean_shutdown`` record so restart skips reconciliation."""
        if clean:
            self.append("clean_shutdown", wall_time=time.time())
        with self._lock:
            if not self._closed:
                self._closed = True
                self._fh.close()

    # -- gauges ------------------------------------------------------------

    @property
    def fsync_age_s(self) -> Optional[float]:
        """Seconds since the last durable record (None before the
        first) — the journal-lag gauge ``fleet_top`` renders."""
        if self.last_fsync_at is None:
            return None
        return max(time.monotonic() - self.last_fsync_at, 0.0)

    # -- replay ------------------------------------------------------------

    @staticmethod
    def recover(path: str) -> JournalState:
        """Replay a journal into a :class:`JournalState`. Tolerates a
        torn FINAL line (a crash mid-append) by stopping in front of
        it; a torn line anywhere ELSE raises ``json.JSONDecodeError``
        loudly — that is corruption, not a crash artifact. Mirrors
        :meth:`pipe_tpu_torch.obs.events.EventLog.read`."""
        if not path.endswith(".jsonl"):
            path = os.path.join(path, JOURNAL_FILENAME)
        state = JournalState()
        if not os.path.exists(path):
            return state
        with open(path, "r", encoding="utf-8") as fh:
            lines = [ln.strip() for ln in fh.read().splitlines()]
        while lines and not lines[-1]:
            lines.pop()
        for i, ln in enumerate(lines):
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break           # torn final line: crash mid-append
                raise               # torn middle line: refuse loudly
            state.apply(rec)
        return state
