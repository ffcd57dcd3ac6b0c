"""Bounded admission queue: the serve engine's request front door.

Counterpart of ``pipe_tpu/serve/queue.py``, copied (standard library only).
Design choices, in order of importance:

* **Backpressure over buffering.** ``submit`` raises :class:`QueueFull`
  at capacity instead of growing without bound — under overload the
  caller (a load balancer, a client with retry budget) learns *now*,
  while the requests already admitted keep their latency.
* **Deadlines are absolute and enforced at both ends.** A request can
  expire while queued (reaped before ever touching the model) or while
  running (the engine retires its slot mid-generation and returns the
  partial tokens with ``status="timeout"``).
* **Cancellation is a flag, not a removal.** ``cancel`` marks the entry;
  the queue/engine collapse it at the next tick. O(1), race-free with
  the engine's single-threaded tick loop.
* **FIFO or priority.** ``policy="priority"`` pops the highest
  ``priority`` first (ties FIFO by arrival sequence). FIFO is the
  default — predictable TTFT under load.

The queue is host-side bookkeeping only; nothing here touches the
device. The clock is injectable (``clock=``) so deadline/cancellation tests run
deterministically without sleeping.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import uuid
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["QueueFull", "Request", "Response", "RequestQueue"]


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission queue is at capacity —
    the backpressure signal. Retry later or shed the request. Carries
    ``depth``/``capacity``/``oldest_age_s`` so callers can tune their
    backoff (a deep queue whose head is old means the service is
    wedged, not merely busy)."""

    def __init__(self, message: str, *, depth: int = 0, capacity: int = 0,
                 oldest_age_s: Optional[float] = None):
        super().__init__(message)
        self.depth = depth
        self.capacity = capacity
        self.oldest_age_s = oldest_age_s


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is a list of int token ids;
    ``max_new_tokens`` caps this request below the engine-wide limit;
    ``seed`` drives the per-request sampling key chain; ``deadline`` is
    absolute in the queue's clock domain (set from ``timeout_s`` at
    submit). ``attempts`` counts placements onto an engine replica —
    the router's retry budget; a request served directly by one engine
    keeps it at 0. ``submitted_at`` and ``deadline`` are set exactly
    once, at the original submit: a failed-over request keeps them
    through every re-queue, so it never regains deadline credit.
    ``trace_id`` is the distributed-tracing correlation key, minted
    exactly once at the original :meth:`RequestQueue.submit` and carried
    verbatim through placement, retry park, KV handoff and failover —
    including across the process-replica wire — so every span a request
    touches, in any process, lands in one stitched timeline."""

    id: int
    prompt: List[int]
    max_new_tokens: int
    seed: int = 0
    priority: int = 0
    deadline: Optional[float] = None
    submitted_at: float = 0.0
    cancelled: bool = False
    attempts: int = 0
    trace_id: Optional[str] = None
    # Disaggregated serving (fleet/disagg.py): which phase this request
    # currently wants — "prefill" (clamped to one token, routed to the
    # prefill pool), "decode" (full generation resuming from shipped KV,
    # routed to the decode pool), or None (whole request on a mixed
    # replica — every pre-disaggregation deployment).
    phase: Optional[str] = None


@dataclasses.dataclass
class Response:
    """Terminal record for one request. ``status``: ``ok`` | ``timeout``
    | ``cancelled`` | ``error`` (backend failure or stuck slot) |
    ``shed`` (pushed back unserved — degraded mode or drain).
    ``finish_reason``: ``eos`` | ``length`` | ``deadline`` |
    ``cancelled`` | ``backend_error`` | ``stuck`` | ``shed`` | ``drain``
    | ``retries_exhausted`` (router: retry budget spent on retryable
    backend failures) | ``no_replicas`` (router: no replica can ever
    serve again). ``tokens`` holds whatever was generated
    before the request finished (possibly empty when it never reached a
    slot). ``ttft`` is first-token latency (None when no token was
    produced); ``latency`` is submit-to-retire."""

    request_id: int
    tokens: List[int]
    status: str
    finish_reason: str
    prompt_len: int
    ttft: Optional[float]
    latency: float


class RequestQueue:
    """Bounded FIFO/priority queue with deadlines and cancellation."""

    def __init__(self, capacity: int = 64, *, policy: str = "fifo",
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in ("fifo", "priority"):
            raise ValueError(f"policy must be fifo|priority, got {policy!r}")
        self.capacity = capacity
        self.policy = policy
        self.clock = clock
        self._seq = itertools.count()
        self._waiting: List[Request] = []
        self._by_id = {}

    def __len__(self) -> int:
        return len(self._waiting)

    @property
    def depth(self) -> int:
        return len(self._waiting)

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int,
               seed: int = 0, priority: int = 0,
               timeout_s: Optional[float] = None) -> Request:
        """Enqueue or raise :class:`QueueFull`. Returns the live
        :class:`Request` (its ``id`` is the handle for ``cancel``)."""
        if len(self._waiting) >= self.capacity:
            age = self.oldest_age()
            raise QueueFull(
                f"admission queue at capacity (depth "
                f"{len(self._waiting)}/{self.capacity}; oldest queued "
                f"request has waited "
                f"{'n/a' if age is None else f'{age:.3f}s'}); retry "
                f"with backoff or raise capacity",
                depth=len(self._waiting), capacity=self.capacity,
                oldest_age_s=age)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        now = self.clock()
        req = Request(id=next(self._seq), prompt=prompt,
                      max_new_tokens=int(max_new_tokens), seed=int(seed),
                      priority=int(priority),
                      deadline=None if timeout_s is None else now + timeout_s,
                      submitted_at=now, trace_id=uuid.uuid4().hex[:16])
        self._waiting.append(req)
        self._by_id[req.id] = req
        return req

    def requeue(self, req: Request) -> Request:
        """Re-enqueue an EXISTING request (router placement/failover),
        preserving its identity: id, ``submitted_at`` and ``deadline``
        are untouched, so a failed-over request keeps its original
        arrival and never regains deadline credit. Raises
        :class:`QueueFull` at capacity, exactly like ``submit``."""
        if len(self._waiting) >= self.capacity:
            age = self.oldest_age()
            raise QueueFull(
                f"admission queue at capacity (depth "
                f"{len(self._waiting)}/{self.capacity}) re-queueing "
                f"request {req.id}",
                depth=len(self._waiting), capacity=self.capacity,
                oldest_age_s=age)
        self._waiting.append(req)
        self._by_id[req.id] = req
        return req

    def evict_all(self) -> List[Request]:
        """Remove and return every queued request INTACT — no terminal
        record, no status change. The router uses this to reclaim a
        wedged replica's backlog for re-placement; contrast
        ``shed_lowest``/``reap``, which end the requests they remove."""
        evicted, self._waiting = self._waiting, []
        for req in evicted:
            self._by_id.pop(req.id, None)
        return evicted

    def cancel(self, request_id: int) -> bool:
        """Mark a queued or running request cancelled. Returns False for
        unknown/already-retired ids."""
        req = self._by_id.get(request_id)
        if req is None:
            return False
        req.cancelled = True
        return True

    def forget(self, request_id: int) -> None:
        """Engine hook: the request reached a terminal state."""
        self._by_id.pop(request_id, None)

    def reap(self, now: Optional[float] = None) -> List[Tuple[Request, str]]:
        """Remove and return queued entries that died while waiting:
        ``(request, "deadline"|"cancelled")`` pairs."""
        if now is None:
            now = self.clock()
        dead, alive = [], []
        for req in self._waiting:
            if req.cancelled:
                dead.append((req, "cancelled"))
            elif req.deadline is not None and now >= req.deadline:
                dead.append((req, "deadline"))
            else:
                alive.append(req)
        self._waiting = alive
        return dead

    def oldest_age(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds the longest-waiting queued request has waited (None
        when empty)."""
        if not self._waiting:
            return None
        if now is None:
            now = self.clock()
        return now - min(r.submitted_at for r in self._waiting)

    def earliest_deadline(self) -> Optional[float]:
        """Soonest deadline among queued (uncancelled) requests, or None
        when nothing queued carries one. The resident serve loop clamps
        its on-device horizon to this: the device may run chunks
        back-to-back only up to the moment host attention (a reap, an
        admission) could actually change the slot set."""
        dls = [r.deadline for r in self._waiting
               if r.deadline is not None and not r.cancelled]
        return min(dls) if dls else None

    def shed_lowest(self, n: int) -> List[Request]:
        """Degraded-mode load shedding: remove and return up to ``n``
        queued requests, lowest ``priority`` first (ties: youngest
        arrival first — the oldest of a priority level has waited
        longest and keeps its place; exact-arrival ties fall to the
        highest ``id``). The key is ``(priority, arrival, id)`` — pure
        request identity, never list position — so the shed set is
        deterministic even after router re-queues reorder the backing
        list. Used by the engine when the deadline-miss EWMA crosses
        its threshold and during drain."""
        if n < 1 or not self._waiting:
            return []
        order = sorted(range(len(self._waiting)),
                       key=lambda i: (self._waiting[i].priority,
                                      -self._waiting[i].submitted_at,
                                      -self._waiting[i].id))
        drop = set(order[:n])
        shed = [self._waiting[i] for i in sorted(drop)]
        self._waiting = [r for i, r in enumerate(self._waiting)
                         if i not in drop]
        return shed

    def peek(self) -> Optional[Request]:
        """The request ``pop`` would return, without removing it — the
        engine's block-availability admission gate looks before it
        leaps (head-of-line parking keeps FIFO/priority order honest;
        popping then re-queueing would rotate the request to the
        tail)."""
        if not self._waiting:
            return None
        if self.policy == "fifo":
            return self._waiting[0]
        best = max(range(len(self._waiting)),
                   key=lambda i: (self._waiting[i].priority, -i))
        return self._waiting[best]

    def pop(self) -> Optional[Request]:
        """Next request to admit (None when empty). Priority policy pops
        the highest ``priority``, FIFO within a priority level. Call
        ``reap`` first; ``pop`` assumes the head entries are live."""
        if not self._waiting:
            return None
        if self.policy == "fifo":
            return self._waiting.pop(0)
        best = max(range(len(self._waiting)),
                   key=lambda i: (self._waiting[i].priority, -i))
        return self._waiting.pop(best)

    def admission_order(self) -> List[Request]:
        """Every queued request in the exact order repeated ``pop``
        calls would return them, WITHOUT removing anything — the
        engine's head-of-line-skip admission scan: when the head can't
        seat (block demand too big for the pool right now), the next
        admissible request in this order may go first."""
        if self.policy == "fifo":
            return list(self._waiting)
        order = sorted(range(len(self._waiting)),
                       key=lambda i: (-self._waiting[i].priority, i))
        return [self._waiting[i] for i in order]

    def take(self, request_id: int) -> Optional[Request]:
        """Remove and return a SPECIFIC queued request by id (None when
        it isn't queued) — the companion to :meth:`admission_order`:
        after the scan picks a non-head request, ``take`` pulls exactly
        that one, leaving the blocked head parked in place."""
        for i, req in enumerate(self._waiting):
            if req.id == request_id:
                return self._waiting.pop(i)
        return None
