"""Fleet control plane: placement, health, exactly-once — transport-split.

Counterpart of ``pipe_tpu/fleet/control.py``, copied: it imports no
device code (the engines are reached through their transports).

The fleet state machine, independent of its transport: the same
implementation coordinates in-process engines (the serial router's
behavior, held to ``pipe_tpu``'s by ``tests/test_torch_fleet_control.py``)
and real OS processes (:mod:`.proc`):

* :class:`ReplicaTransport` — everything the control plane needs from a
  replica: place/poll/evict/drain/cancel, a queue-pressure surface for
  placement, a :class:`ReplicaHealth` snapshot (the watchdog signals,
  shipped as heartbeat payload when an IPC boundary intervenes), and
  the KV-handoff hooks (export/import/invalidate prefix blocks).
* :class:`InProcessTransport` — wraps one :class:`~..serve.engine
  .ServeEngine`. Serial mode (default): ``poll()`` *is* ``engine.tick()``
  — the control loop drives the replica, exactly the serial round-robin.
  Async mode (``async_tick=True``): a daemon thread ticks the engine
  continuously under a per-replica lock and ``poll()`` merely drains
  finished responses, so one slow replica no longer stalls its siblings
  (a process replica ticks *itself* — same contract, different
  mechanism).
* :class:`FleetController` — the state machine itself. Health states::

      HEALTHY --(slow streak / decode error / retryable failure)--> SUSPECT
      SUSPECT --(recover_healthy_ticks clean ticks)--> HEALTHY
      HEALTHY|SUSPECT --(wedge thresholds / heartbeat loss)--> WEDGED
      WEDGED --(queued work evicted, drain() issued)--> DRAINING
      DRAINING --(transport.drained)--> RETIRED

  plus the retry-parking/backoff machinery and the exactly-once
  delivery ledger. **The ledger lives here**, never in a transport: a
  transport may die mid-flight (socket drop, child crash) and the
  controller reclaims the in-flight requests it placed there
  (``_placed_on`` is the authoritative in-flight map), re-places them
  under ``Request.attempts``, and still delivers every id exactly once
  — a duplicate terminal response raises.

KV handoff is real here, not just counters: when a session remaps off
its home replica, the controller asks the old home's transport to
export the session's cached shared-prefix blocks (serialized through
the int8 path when they cross a process boundary — see
``serve/engine.py:export_prefix_payload``) and seats them into the
destination pool before the request is placed, so the destination
prefill resumes from the shipped blocks instead of recomputing them.
The warm/cold classification still probes the destination *before* the
import — it records what the handoff cost (shipping vs. nothing), and
keeps the ``serve.fleet.kv_handoff_*`` counter semantics.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..obs.events import NULL_EVENT_LOG, REQUEST
from ..obs.telemetry import get_registry, labelled

if False:  # type-hint names only — the runtime imports are lazy because
    # serve/__init__ imports router which imports THIS module: a
    # top-level serve import here deadlocks whichever package the user
    # imports first (fleet-first and serve-first must both work)
    from ..serve.engine import ServeEngine  # noqa: F401
    from ..serve.queue import Request, RequestQueue, Response  # noqa: F401

__all__ = ["FleetController", "ReplicaTransport", "InProcessTransport",
           "Replica", "ReplicaHealth", "RouterPolicy", "TransportError",
           "HEALTHY", "SUSPECT", "WEDGED", "DRAINING", "RETIRED",
           "RETRYABLE_REASONS"]

HEALTHY = "healthy"
SUSPECT = "suspect"
WEDGED = "wedged"
DRAINING = "draining"
RETIRED = "retired"
STATES = (HEALTHY, SUSPECT, WEDGED, DRAINING, RETIRED)
_STATE_CODE = {s: i for i, s in enumerate(STATES)}

# Engine finish_reasons the controller may retry on another replica;
# every other terminal outcome is delivered as-is.
RETRYABLE_REASONS = ("backend_error", "stuck")


class TransportError(RuntimeError):
    """The transport to a replica died (socket drop, child crash,
    heartbeat loss). Raised by transport methods; the controller
    responds by reclaiming every request in flight on that replica and
    retiring it — the replica itself may be perfectly healthy, but
    unreachable is indistinguishable from dead."""


@dataclasses.dataclass
class ReplicaHealth:
    """One replica's health signals, as the control plane sees them.
    For an in-process replica these are live reads of the engine's
    watchdog surface; for a process replica they are the most recent
    heartbeat payload — the same fields, surviving the IPC boundary.
    ``heartbeat_age_s`` is 0.0 in-process (every read is fresh)."""

    slow_streak: int = 0
    miss_ewma: float = 0.0
    stuck_slots: int = 0
    consecutive_decode_errors: int = 0
    heartbeat_age_s: float = 0.0
    alive: bool = True


@dataclasses.dataclass
class RouterPolicy:
    """Fleet policy knobs. Defaults are deliberately conservative —
    quick to stop placing on a sick replica (SUSPECT is cheap: work
    just goes elsewhere), slow to wedge (WEDGED is one-way).

    ``placement`` — ``least_loaded`` picks the replica with the fewest
    queued+live requests (ties: lowest index); ``session`` pins each
    ``session`` key to its first replica while that replica is HEALTHY
    (KV-cache/prefix locality for multi-turn traffic) and falls back to
    least-loaded — remapping the session — when it isn't.

    ``retry_budget`` — max *placements* per request (``Request.attempts``
    is the ledger); a retryable failure at ``attempts >= retry_budget``
    is terminal. ``backoff_base_s``/``backoff_max_s`` shape the parked
    delay ``min(base * 2^(attempts-1), max)``; base 0 retries on the
    next tick (what deterministic fake-clock tests want — a parked
    request is only eligible once the queue clock passes its delay).

    SUSPECT triggers: ``suspect_slow_streak`` consecutive over-budget
    ticks (watchdog), any decode error, any retryable failure this
    tick, or ``suspect_miss_ewma`` (None disables the EWMA trigger).
    ``recover_healthy_ticks`` clean ticks clear SUSPECT. WEDGE
    triggers: ``wedge_slow_streak`` consecutive slow ticks,
    ``wedge_decode_errors`` consecutive decode errors (keep it below
    the engine's ``decode_error_limit``, which resets the streak), or
    ``wedge_error_ticks`` *cumulative* ticks that produced retryable
    failures (catches prefill-side death, where no decode streak ever
    forms). ``heartbeat_timeout_s`` (None disables) wedges a replica
    whose health snapshot is older than this — the IPC analog of a
    slow streak: an unreachable replica must not hold its queue.

    Lifecycle: ``spawn_depth``/``spawn_sustain_ticks``/``max_replicas``
    gate the spawn hook; ``retire_idle_ticks``/``min_replicas`` gate
    idle retirement (None disables).
    """

    placement: str = "least_loaded"
    # prefix placement + hot replication (paged pools only).
    # ``placement="prefix"`` scores candidates by matched-prefix depth x
    # occupancy headroom from each replica's advertised prefix
    # directory, falling back to session pin / least-loaded when nothing
    # matches. ``kv_hot_refs`` (None disables) proactively replicates
    # prefix chains shared by that many live slots to the
    # least-occupied sibling lacking them, via the same
    # export/import path a session remap uses; at most
    # ``kv_replicate_max_per_tick`` ships per tick.
    kv_hot_refs: Optional[int] = None
    kv_replicate_max_per_tick: int = 1
    retry_budget: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    suspect_slow_streak: int = 2
    suspect_miss_ewma: Optional[float] = None
    recover_healthy_ticks: int = 3
    wedge_slow_streak: int = 6
    wedge_decode_errors: int = 2
    wedge_error_ticks: int = 3
    heartbeat_timeout_s: Optional[float] = None
    spawn_depth: Optional[int] = None
    spawn_sustain_ticks: int = 10
    max_replicas: int = 8
    retire_idle_ticks: Optional[int] = None
    min_replicas: int = 1

    def __post_init__(self):
        if self.placement not in ("least_loaded", "session", "prefix"):
            raise ValueError(
                f"placement must be least_loaded|session|prefix, got "
                f"{self.placement!r}")
        if self.kv_hot_refs is not None and self.kv_hot_refs < 2:
            raise ValueError(
                f"kv_hot_refs must be >= 2 (a block one slot holds is "
                f"not hot) or None, got {self.kv_hot_refs}")
        if self.kv_replicate_max_per_tick < 1:
            raise ValueError(
                f"kv_replicate_max_per_tick must be >= 1, got "
                f"{self.kv_replicate_max_per_tick}")
        if self.retry_budget < 1:
            raise ValueError(
                f"retry_budget must be >= 1, got {self.retry_budget}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.heartbeat_timeout_s is not None \
                and self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0 or None")
        for fld in ("suspect_slow_streak", "recover_healthy_ticks",
                    "wedge_slow_streak", "wedge_decode_errors",
                    "wedge_error_ticks", "spawn_sustain_ticks",
                    "max_replicas", "min_replicas"):
            if getattr(self, fld) < 1:
                raise ValueError(f"{fld} must be >= 1")


# ---------------------------------------------------------------------------
# the transport interface


class ReplicaTransport:
    """What the control plane needs from one replica — nothing more.

    Implementations: :class:`InProcessTransport` (an engine in this
    process), :class:`~.proc.ProcessReplicaTransport` (a real OS
    process on the wire). Any method may raise :class:`TransportError`
    when the replica becomes unreachable; the controller reclaims and
    retires.

    ``rpc_inflight``/``rpc_retries`` are wire-level telemetry
    (0 in-process); they surface through the per-replica labelled
    gauges the controller exports every tick.

    ``obs_tokens_out``/``obs_responses_out`` are the
    delivery-synchronized per-replica counters the fleet observer sums:
    every transport bumps them at the exact moment a terminal response
    crosses into the control plane (``poll`` in-process, response-frame
    accept on the wire), so the per-replica sums reconcile with the
    parent-observed delivered totals even when a replica is SIGKILLed
    between two telemetry ships. ``obs_view()`` returns the shipped
    telemetry view ``(registry, age_s, seq, events)`` for transports
    that receive obs frames, None for transports the observer reads
    directly (in-process).
    """

    rpc_inflight: int = 0
    rpc_retries: int = 0
    obs_tokens_out: int = 0
    obs_responses_out: int = 0

    def obs_view(self):
        """Shipped-telemetry view ``(registry, age_s, seq, events)`` or
        None when this transport's replica is readable in-process."""
        return None

    # -- work ------------------------------------------------------------
    def place(self, req: Request) -> None:
        """Admit an existing request (increments ``req.attempts``).
        Raises like ``ServeEngine.place``: ``EngineDraining``,
        ``ValueError``, ``QueueFull`` — or :class:`TransportError`."""
        raise NotImplementedError

    def poll(self) -> List[Response]:
        """Advance the replica if this transport drives it (serial
        in-process mode) and return the terminal responses that
        finished since the last poll."""
        raise NotImplementedError

    def evict_queued(self) -> List[Union[Request, int]]:
        """Remove and return the replica's queued (not live) requests —
        as :class:`Request` objects when the transport holds them, or
        as request ids the controller resolves against its ledger."""
        raise NotImplementedError

    def cancel(self, request_id: int) -> bool:
        raise NotImplementedError

    def salvage(self) -> List[Response]:
        """Terminal responses already accepted on this side of the wire
        but never drained by a ``poll`` — returned WITHOUT a liveness
        check, so the drop path can read them after the wire is dead.
        Transports that count ``obs_tokens_out`` at frame-accept time
        (the process transport) MUST implement this: those tokens
        already crossed into the control plane, so re-running their
        requests on another replica would both waste a second decode
        and break the delivered-token reconciliation. Transports that
        count at drain time may return ``[]`` (the default) — their
        buffered work is uncounted and safe to retry."""
        return []

    # -- lifecycle -------------------------------------------------------
    def drain(self) -> None:
        raise NotImplementedError

    @property
    def drained(self) -> bool:
        raise NotImplementedError

    @property
    def idle(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        """Release transport resources (kill threads/processes)."""

    # -- placement surface ----------------------------------------------
    @property
    def queue_depth(self) -> int:
        raise NotImplementedError

    @property
    def queue_capacity(self) -> int:
        raise NotImplementedError

    @property
    def live_slots(self) -> int:
        raise NotImplementedError

    # -- admission validation -------------------------------------------
    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        raise NotImplementedError

    @property
    def default_max_new_tokens(self) -> int:
        raise NotImplementedError

    # -- health ----------------------------------------------------------
    def health(self) -> ReplicaHealth:
        raise NotImplementedError

    # -- KV handoff (paged pools only; every hook may no-op) -------------
    def export_prefix(self, prompt: Sequence[int]) -> Optional[dict]:
        """Serialize the cached shared-prefix blocks covering
        ``prompt`` (None when the backend has no pool / no hits)."""
        return None

    def import_prefix(self, payload: dict) -> int:
        """Seat an exported payload into this replica's pool; returns
        blocks seated (0 when unsupported)."""
        return 0

    def invalidate_prefix(self, prompt: Sequence[int]) -> int:
        """Drop this replica's cached prefix entries for ``prompt``;
        returns entries invalidated."""
        return 0

    def cached_prefix_blocks(self, prompt: Sequence[int]) -> int:
        """Leading full prompt blocks already cached here (the
        warm-handoff probe)."""
        return 0

    def prefix_directory(self) -> Optional[dict]:
        """This replica's advertised KV residency: ``{"block_size",
        "digests", "occupancy", "blocks_free", "blocks_total"}`` (the
        pool's ``prefix_digest_summary``), or None when the replica has
        no paged pool / the directory hasn't arrived yet. Process
        replicas ship it on the heartbeat cadence — it may be a beat
        stale, which placement tolerates (a miss just means a cold
        prefill)."""
        return None

    def hot_prefixes(self, min_refs: int) -> List[dict]:
        """Prefix chains shared by >= ``min_refs`` live slots, each as
        ``{"digest", "refs", "depth", "tokens"}`` with the full token
        chain — the proactive-replication feed."""
        return []


class InProcessTransport(ReplicaTransport):
    """One :class:`~..serve.engine.ServeEngine` behind the transport
    interface.

    Serial mode (default) is the serial router contract: the controller
    calls ``poll()`` once per fleet tick and that call runs
    ``engine.tick()`` — single-threaded, deterministic, what the pinned
    router tests drive with a fake clock.

    ``async_tick=True`` starts a daemon thread that ticks the engine
    whenever it has work; ``poll()`` just drains the finished-response
    buffer. Every engine call (tick/place/evict/drain) is serialized
    under one per-replica lock, so the engine itself stays
    single-threaded — the thread merely moves WHOSE loop runs it. A
    wedged or slow replica then blocks only its own thread.
    """

    def __init__(self, engine: ServeEngine, *, async_tick: bool = False,
                 tick_interval_s: float = 0.0,
                 role: Optional[str] = None):
        self.engine = engine
        # phase role for disaggregated placement (fleet/disagg.py):
        # defaults to the engine's own operating phase so an engine
        # built prefill-only/decode-only advertises itself correctly
        self.role = role if role is not None \
            else getattr(engine, "phase", "mixed")
        self.async_tick = bool(async_tick)
        self._lock = threading.Lock()
        self._buffer: "deque[Response]" = deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick_interval_s = tick_interval_s
        if self.async_tick:
            self._thread = threading.Thread(
                target=self._tick_loop, name="fleet-replica-tick",
                daemon=True)
            self._thread.start()

    # -- async tick loop -------------------------------------------------

    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            did_work = False
            with self._lock:
                eng = self.engine
                if not eng.idle or (eng.draining and not eng.drained):
                    self._buffer.extend(eng.tick())
                    did_work = True
            if not did_work:
                time.sleep(0.001)
            elif self._tick_interval_s:
                time.sleep(self._tick_interval_s)

    # -- work ------------------------------------------------------------

    def place(self, req: Request) -> None:
        with self._lock:
            self.engine.place(req)

    def poll(self) -> List[Response]:
        if self.async_tick:
            out = []
            while self._buffer:
                out.append(self._buffer.popleft())
        else:
            out = self.engine.tick()
        for resp in out:
            self.obs_tokens_out += len(resp.tokens)
            self.obs_responses_out += 1
        return out

    def evict_queued(self) -> List[Request]:
        with self._lock:
            return self.engine.evict_queued()

    def cancel(self, request_id: int) -> bool:
        return self.engine.cancel(request_id)

    # -- lifecycle -------------------------------------------------------

    def drain(self) -> None:
        with self._lock:
            self.engine.drain()

    @property
    def drained(self) -> bool:
        if self.async_tick:
            with self._lock:
                return self.engine.drained and not self._buffer
        return self.engine.drained

    @property
    def idle(self) -> bool:
        # pending async responses still count as work for the fleet —
        # and the async read must hold the tick lock: mid-tick the
        # engine can look idle (last slot retired) BEFORE the response
        # reaches the buffer, and an unlocked read of that instant
        # would let the controller conclude the fleet is done
        if self.async_tick:
            with self._lock:
                return self.engine.idle and not self._buffer
        return self.engine.idle

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    # -- placement surface ----------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self.engine.queue.depth

    @property
    def queue_capacity(self) -> int:
        return self.engine.queue.capacity

    @property
    def live_slots(self) -> int:
        return self.engine.live_slots

    # -- admission validation -------------------------------------------

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        self.engine.backend.validate(prompt_len, max_new_tokens)

    @property
    def default_max_new_tokens(self) -> int:
        return self.engine.backend.gen.max_new_tokens

    # -- health ----------------------------------------------------------

    def health(self) -> ReplicaHealth:
        wd = self.engine.watchdog
        return ReplicaHealth(
            slow_streak=wd.slow_streak if wd is not None else 0,
            miss_ewma=wd.miss_ewma if wd is not None else 0.0,
            stuck_slots=wd.stuck_slots if wd is not None else 0,
            consecutive_decode_errors=(
                self.engine.consecutive_decode_errors),
            heartbeat_age_s=0.0, alive=True)

    # -- KV handoff ------------------------------------------------------

    def export_prefix(self, prompt: Sequence[int]) -> Optional[dict]:
        exp = getattr(self.engine.backend, "export_prefix_payload", None)
        if exp is None:
            return None
        # in-process: exact bytes (codec="raw"), no lossy serialization.
        # Must hold the tick lock: the async tick thread's decode step
        # DONATES the pool buffers, and an export racing it reads a
        # deleted buffer (the disagg controller exports from replicas
        # that are still actively prefilling).
        with self._lock:
            return exp(prompt, codec="raw")

    def import_prefix(self, payload: dict) -> int:
        imp = getattr(self.engine.backend, "import_prefix_payload", None)
        if imp is None:
            return 0
        with self._lock:
            return imp(payload)

    def invalidate_prefix(self, prompt: Sequence[int]) -> int:
        pool = getattr(self.engine.backend, "pool", None)
        if pool is None:
            return 0
        with self._lock:
            return pool.invalidate(pool.prefix_hashes(prompt))

    def cached_prefix_blocks(self, prompt: Sequence[int]) -> int:
        pool = getattr(self.engine.backend, "pool", None)
        if pool is None:
            return 0
        with self._lock:
            return pool.cached_prefix_blocks(prompt)

    def prefix_directory(self) -> Optional[dict]:
        pool = getattr(self.engine.backend, "pool", None)
        if pool is None:
            return None
        return pool.prefix_digest_summary()

    def hot_prefixes(self, min_refs: int) -> List[dict]:
        pool = getattr(self.engine.backend, "pool", None)
        if pool is None:
            return []
        return pool.hot_prefixes(min_refs)


# ---------------------------------------------------------------------------
# replica record


class Replica:
    """Controller-side record of one replica: health state plus the
    hysteresis counters the state machine runs on. ``engine`` is the
    in-process convenience accessor (None for a process replica)."""

    __slots__ = ("index", "transport", "state", "healthy_streak",
                 "idle_ticks", "error_ticks", "had_error_this_tick")

    def __init__(self, index: int, transport: ReplicaTransport):
        self.index = index
        self.transport = transport
        self.state = HEALTHY
        self.healthy_streak = 0
        self.idle_ticks = 0
        self.error_ticks = 0          # cumulative ticks with retryable fails
        self.had_error_this_tick = False

    @property
    def engine(self):
        return getattr(self.transport, "engine", None)

    @property
    def role(self) -> str:
        """The replica's phase role (``prefill``/``decode``/``mixed``),
        as advertised by its transport. A transport that predates roles
        reads as ``mixed`` — the serve-both-phases default."""
        return getattr(self.transport, "role", "mixed")

    @property
    def load(self) -> int:
        return self.transport.queue_depth + self.transport.live_slots

    def __repr__(self) -> str:
        return (f"Replica({self.index}, state={self.state}, "
                f"load={self.load})")


# ---------------------------------------------------------------------------
# the controller


class FleetController:
    """Shard one front :class:`~..serve.queue.RequestQueue` across N
    replica transports with health-gated failover.

    The surface mirrors :class:`~..serve.engine.ServeEngine` — ``submit``
    / ``tick`` / ``cancel`` / ``response`` / ``drain`` / ``idle`` /
    ``run_until_idle`` — so drivers (``apps/serve.py``) swap one for
    the other without restructuring their loop. ``spawn_fn`` (if given)
    builds one more transport on demand for the spawn hook.
    """

    def __init__(self, transports: Sequence[ReplicaTransport],
                 queue: Optional[RequestQueue] = None, *,
                 policy: RouterPolicy = RouterPolicy(),
                 spawn_fn: Optional[Callable[[], ReplicaTransport]] = None,
                 event_log=None,
                 clock: Optional[Callable[[], float]] = None,
                 journal=None):
        transports = list(transports)
        if not transports:
            raise ValueError(
                "the fleet needs at least one replica transport")
        if queue is None:
            from ..serve.queue import RequestQueue
            queue = RequestQueue(clock=clock or time.monotonic)
        elif clock is not None and clock is not queue.clock:
            raise ValueError(
                "pass the clock on the queue (the fleet adopts "
                "queue.clock)")
        self.queue = queue
        self.clock = queue.clock
        self.policy = policy
        self.spawn_fn = spawn_fn
        self.journal = journal
        self.events = event_log if event_log is not None else NULL_EVENT_LOG
        self.replicas: List[Replica] = []
        for tr in transports:
            self._add_replica(tr)
        self._responses: Dict[int, Response] = {}
        self._tracked: Dict[int, Request] = {}
        self._parked: List[Tuple[float, Request]] = []
        self._session_of: Dict[int, str] = {}
        self._session_map: Dict[str, int] = {}
        self._placed_on: Dict[int, int] = {}
        self._kv_replicated: Dict[str, set] = {}
        self._pending_out: List[Response] = []
        self._tick_index = 0
        self._depth_streak = 0
        self._draining = False

    # -- construction helpers ----------------------------------------------

    def _add_replica(self, transport: ReplicaTransport) -> Replica:
        rep = Replica(len(self.replicas), transport)
        self.replicas.append(rep)
        return rep

    # -- front door --------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None, seed: int = 0,
               priority: int = 0, timeout_s: Optional[float] = None,
               session: Optional[str] = None) -> Request:
        """Validate + enqueue at the fleet front door. Raises
        ``ValueError`` on an unservable request,
        :class:`~..serve.engine.EngineDraining` after :meth:`drain`, and
        :class:`~..serve.queue.QueueFull` when the front queue is at
        capacity — which is exactly what happens when every replica is
        SUSPECT or worse: placement stops, the front fills, callers feel
        backpressure instead of silent loss."""
        from ..serve.engine import EngineDraining
        from ..serve.queue import QueueFull
        reg = get_registry()
        if self._draining:
            raise EngineDraining(
                "fleet is draining: live requests are finishing and no "
                "new work is admitted")
        tr = self.replicas[0].transport
        if max_new_tokens is None:
            max_new_tokens = tr.default_max_new_tokens
        tr.validate(len(prompt), max_new_tokens)
        try:
            req = self.queue.submit(prompt, max_new_tokens=max_new_tokens,
                                    seed=seed, priority=priority,
                                    timeout_s=timeout_s)
        except QueueFull:
            reg.counter("serve.fleet.rejected").inc()
            raise
        if self.journal is not None:
            # journaled BEFORE the request becomes placeable: a crash
            # from here on replays it from the WAL
            self.journal.append(
                "submit", request=req.id, prompt=list(req.prompt),
                max_new_tokens=req.max_new_tokens, seed=req.seed,
                priority=req.priority, trace=req.trace_id,
                session=None if session is None else str(session),
                remaining_s=(None if req.deadline is None
                             else req.deadline - self.clock()))
        self._tracked[req.id] = req
        if session is not None:
            self._session_of[req.id] = str(session)
        reg.counter("serve.fleet.submitted").inc()
        reg.gauge("serve.fleet.front_depth").set(self.queue.depth)
        self.events.event(REQUEST, request=req.id, trace=req.trace_id,
                          stage="queued", prompt_len=len(req.prompt),
                          priority=req.priority, session=session)
        return req

    def cancel(self, request_id: int) -> bool:
        """Mark a live request cancelled wherever it currently sits —
        front queue, parked for retry, a replica's queue, or a running
        slot. One flag flip on the shared :class:`~..serve.queue.Request`;
        whichever sweep sees it first emits the single terminal
        ``cancelled`` response. False for unknown/terminal ids."""
        req = self._tracked.get(request_id)
        if req is None:
            return False
        req.cancelled = True
        # a process replica holds a COPY of the request across the wire:
        # forward the flag so the remote sweep sees it too
        idx = self._placed_on.get(request_id)
        if idx is not None:
            try:
                self.replicas[idx].transport.cancel(request_id)
            except TransportError:
                pass  # drop recovery reclaims it next tick
        return True

    def response(self, request_id: int) -> Optional[Response]:
        return self._responses.get(request_id)

    # -- drain / status ----------------------------------------------------

    def drain(self) -> None:
        """Fleet-wide graceful shutdown: ``submit`` starts raising, the
        next tick sheds front-queued and parked work
        (``finish_reason="drain"``) and every replica drains its live
        slots. Idempotent."""
        if not self._draining:
            self._draining = True
            self.events.event("resilience", action="fleet_drain",
                              front=self.queue.depth,
                              parked=len(self._parked))
            for rep in self.replicas:
                if rep.state != RETIRED:
                    try:
                        rep.transport.drain()
                    except TransportError:
                        pass

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        return self._draining and self.idle

    @property
    def idle(self) -> bool:
        # undrained salvaged responses (_pending_out) are still work:
        # a caller that gates its tick loop on idle must not conclude
        # the fleet is done while deliveries sit in the hand-off buffer
        return (self.queue.depth == 0 and not self._parked
                and not self._pending_out
                and all(r.state == RETIRED or r.transport.idle
                        for r in self.replicas))

    def counts(self) -> Dict[str, int]:
        """Replica count per health state (``{state: n}``)."""
        out = {s: 0 for s in STATES}
        for rep in self.replicas:
            out[rep.state] += 1
        return out

    def close(self) -> None:
        """Release every transport (threads, child processes)."""
        for rep in self.replicas:
            try:
                rep.transport.close()
            except Exception:
                pass

    # -- crash recovery (restart from the journal) -------------------------

    @classmethod
    def from_journal(cls, state, transports: Sequence[ReplicaTransport],
                     queue: Optional[RequestQueue] = None, *,
                     journal=None, policy: RouterPolicy = RouterPolicy(),
                     spawn_fn=None, event_log=None,
                     clock: Optional[Callable[[], float]] = None
                     ) -> "FleetController":
        """Rebuild a controller after a crash: ``state`` is the
        replayed WAL (:meth:`~.journal.RequestJournal.recover`) and
        ``transports`` the re-dialed surviving children (rejoin-mode
        :class:`~.proc.ProcessReplicaTransport`, index-aligned with the
        journal's replica records). The exactly-once ledger, retry
        parks and phase tags come back from the journal; placements are
        reconciled against what each child actually still holds —
        still live there → adopted in place, finished during the outage
        → its replayed response salvaged and delivered, gone → parked
        for immediate re-placement. Pass a fresh ``journal`` on the
        same path to keep the WAL growing through the new life."""
        ctl = cls(transports, queue, policy=policy, spawn_fn=spawn_fn,
                  event_log=event_log, clock=clock, journal=journal)
        ctl._restore(state)
        return ctl

    def _restore(self, state) -> None:
        import itertools
        from ..serve.queue import Request, Response
        reg = get_registry()
        now = self.clock()
        # never reuse a journaled id: the front queue's sequence resumes
        # past everything the previous life handed out
        self.queue._seq = itertools.count(state.max_request_id + 1)
        # terminal stubs: ids the previous life already answered. A
        # replica replaying one of their responses — or a recovered
        # placement racing to finish one — must still trip the
        # duplicate-delivery raise, so the ledger gets a stub per id.
        for rid, rec in state.terminal.items():
            self._responses[rid] = Response(
                request_id=rid, tokens=[], status=rec.get("status", "ok"),
                finish_reason=rec.get("finish_reason", "eos"),
                prompt_len=0, ttft=None, latency=0.0)
        if state.clean:
            # the log ends with clean_shutdown: nothing was in flight
            self.events.event("resilience", action="controller_restart",
                              clean=True, terminal=len(state.terminal))
            return
        # what does each surviving child still hold? (rejoin-mode
        # transports answer over the wire; anything else has no state)
        live_ids: Dict[int, set] = {}
        buffered: Dict[int, set] = {}
        for rep in self.replicas:
            tr = rep.transport
            fn = getattr(tr, "remote_request_ids", None)
            if fn is not None:
                try:
                    live_ids[rep.index] = set(fn())
                except TransportError:
                    live_ids[rep.index] = set()
            fn = getattr(tr, "orphan_response_ids", None)
            if fn is not None:
                buffered[rep.index] = set(fn())
        orphans = 0
        adopted = 0
        for rid in state.orphans:
            rec = state.requests[rid]
            req = Request(
                id=rid, prompt=list(rec["prompt"]),
                max_new_tokens=int(rec["max_new_tokens"]),
                seed=int(rec.get("seed", 0)),
                priority=int(rec.get("priority", 0)),
                deadline=(None if rec.get("remaining_s") is None
                          else now + float(rec["remaining_s"])),
                submitted_at=now, trace_id=rec.get("trace"))
            req.attempts = state.attempts.get(rid, 0)
            orphans += 1
            self._tracked[rid] = req
            sess = rec.get("session")
            if sess is not None:
                self._session_of[rid] = sess
            self._restore_phase(req, state)
            target = state.placed_on.get(rid)
            if target is not None and target < len(self.replicas) \
                    and (rid in live_ids.get(target, ())
                         or rid in buffered.get(target, ())):
                adopt = getattr(self.replicas[target].transport,
                                "adopt", None)
                if adopt is not None:
                    adopt(req)
                    self._placed_on[rid] = target
                    adopted += 1
                    continue
            # not live anywhere we can see: park, eligible immediately
            self._parked.append((now, req))
        # responses the children replayed for ids that were NOT
        # adopted: journaled terminals are duplicates (drop), tracked
        # orphans are work that finished during the outage (salvage)
        salvaged = 0
        for rep in self.replicas:
            seal = getattr(rep.transport, "seal_rejoin", None)
            if seal is None:
                continue
            for resp in seal():
                if resp.request_id in self._responses:
                    continue
                if resp.request_id in self._tracked:
                    out = self._salvage(rep, resp)
                    if out is not None:
                        self._pending_out.append(out)
                        salvaged += 1
        self._parked = [(t, r) for t, r in self._parked
                        if r.id not in self._responses]
        reg.counter("serve.fleet.recovered_orphans").inc(orphans)
        reg.counter("serve.fleet.recovered_adopted").inc(adopted)
        if salvaged:
            reg.counter("serve.fleet.salvaged").inc(salvaged)
        self.events.event("resilience", action="controller_restart",
                          clean=False, terminal=len(state.terminal),
                          orphans=orphans, adopted=adopted,
                          salvaged=salvaged, parked=len(self._parked))

    def _restore_phase(self, req: Request, state) -> None:
        """Phase-tag hook for recovery — the base controller has no
        phases. :class:`~.disagg.DisaggController` overrides."""

    def _salvage(self, rep: Replica, resp: Response):
        """One response ``rep``'s child replayed for a tracked orphan:
        for the base controller every replica is terminal-producing,
        so it IS the finished work of the outage — deliver it.
        :class:`~.disagg.DisaggController` overrides to tell replayed
        shadow frames apart from genuine decode terminals."""
        return self._deliver(resp)

    # -- delivery (the exactly-once ledger) --------------------------------

    def _deliver(self, resp: Response) -> Optional[Response]:
        """Record a terminal response in the exactly-once ledger and
        return it. Subclasses may return None to CONSUME a response
        instead of delivering it (the disaggregated controller swallows
        the prefill phase's one-token terminal and re-enters the
        request for its decode phase) — every caller that surfaces
        responses must tolerate None. The base implementation never
        returns None, and never intercepts the ``_finish_unplaced``
        records (their status is never ``ok``)."""
        if resp.request_id in self._responses:
            raise RuntimeError(
                f"duplicate terminal response for request "
                f"{resp.request_id} (exactly-once delivery violated)")
        if self.journal is not None:
            # the exactly-once hinge: durable before the ledger record,
            # so a restart can never answer this id a second time
            self.journal.append(
                "deliver", request=resp.request_id, status=resp.status,
                finish_reason=resp.finish_reason, tokens=len(resp.tokens))
        self._responses[resp.request_id] = resp
        req = self._tracked.pop(resp.request_id, None)
        self._session_of.pop(resp.request_id, None)
        placed_on = self._placed_on.pop(resp.request_id, None)
        self.queue.forget(resp.request_id)
        reg = get_registry()
        reg.counter("serve.fleet.delivered").inc()
        reg.counter("serve.fleet.delivered_tokens").inc(len(resp.tokens))
        if resp.status == "ok":
            reg.counter("serve.fleet.ok").inc()
        if req is not None and req.attempts > 1:
            reg.counter("serve.fleet.failed_over").inc()
        self.events.event(REQUEST, request=resp.request_id,
                          trace=getattr(req, "trace_id", None),
                          stage="delivered", status=resp.status,
                          finish_reason=resp.finish_reason,
                          tokens=len(resp.tokens), replica=placed_on,
                          attempts=getattr(req, "attempts", 0))
        return resp

    def _finish_unplaced(self, req: Request, status: str, reason: str,
                         now: float) -> Response:
        """Terminal record for a request that never (re)reached a
        replica: front-reaped, parked-reaped, shed on fleet drain, or
        retries exhausted."""
        from ..serve.queue import Response
        resp = Response(request_id=req.id, tokens=[], status=status,
                        finish_reason=reason, prompt_len=len(req.prompt),
                        ttft=None, latency=now - req.submitted_at)
        self.events.event(REQUEST, request=req.id, status=status,
                          finish_reason=reason, replica=None,
                          attempts=req.attempts, trace=req.trace_id,
                          stage="terminal")
        return self._deliver(resp)

    # -- retry parking -----------------------------------------------------

    def _as_requests(self,
                     items: Sequence[Union[Request, int]]) -> List[Request]:
        """Resolve a transport's evicted items — Request objects pass
        through; bare ids (a process replica holds only copies) map to
        the controller's tracked originals, which are authoritative for
        deadlines and attempts. Unknown/already-terminal ids drop."""
        from ..serve.queue import Request
        out: List[Request] = []
        for it in items:
            req = it if isinstance(it, Request) else self._tracked.get(it)
            if req is not None:
                out.append(req)
        return out

    def reclaim(self, requests: List[Request], now: float) -> List[Response]:
        """Re-absorb requests knocked off a replica — the ONE
        park-or-finish decision all recovery paths share (a wedged
        replica's evicted backlog, per-request retryable failures from
        a live tick, and a transport drop's in-flight set), so the
        exactly-once ledger has a single writer. Per request: cancelled
        or past its deadline → parked for the next sweep's terminal
        cancelled/timeout record; retry budget remaining → parked with
        exponential backoff; else ONE terminal ``retries_exhausted``
        error. Returns the terminal responses (already recorded in the
        ledger); parked requests surface through later ticks."""
        reg = get_registry()
        finished: List[Response] = []
        for req in requests:
            if req.cancelled or (req.deadline is not None
                                 and now >= req.deadline):
                # next tick's parked sweep emits the terminal
                # cancelled/timeout record
                self._parked.append((now, req))
            elif req.attempts < self.policy.retry_budget:
                self._park(req, now)
            else:
                reg.counter("serve.fleet.retries_exhausted").inc()
                finished.append(self._finish_unplaced(
                    req, "error", "retries_exhausted", now))
        return finished

    def _park(self, req: Request, now: float) -> None:
        p = self.policy
        delay = min(p.backoff_base_s * (2.0 ** max(req.attempts - 1, 0)),
                    p.backoff_max_s)
        if self.journal is not None:
            self.journal.append("park", request=req.id,
                                attempts=req.attempts, delay_s=delay)
        self._parked.append((now + delay, req))
        get_registry().counter("serve.fleet.retried").inc()
        self.events.event("resilience", action="retry_parked",
                          request=req.id, attempts=req.attempts,
                          delay_s=delay, trace=req.trace_id,
                          stage="retry_parked")

    # -- placement ---------------------------------------------------------

    def _placeable(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.state == HEALTHY
                and r.transport.queue_depth < r.transport.queue_capacity]

    def _role_filter(self, req: Request,
                     candidates: List[Replica]) -> List[Replica]:
        """Restrict placement candidates by the request's phase.

        A phase-tagged request (``req.phase`` set by the disaggregated
        controller) wants its role pool — ``prefill`` requests go to
        prefill replicas, ``decode`` requests to decode replicas — and
        falls back to mixed replicas when the wanted pool is empty or
        entirely sick. A phase-less request only ever lands on mixed
        replicas: a prefill-only engine would reject its
        ``max_new_tokens`` and a decode-only engine would refuse to
        prefill it. In an all-mixed fleet (every deployment before
        disaggregation) this is the identity filter."""
        want = getattr(req, "phase", None)
        if want in ("prefill", "decode"):
            pool = [r for r in candidates if r.role == want]
            return pool or [r for r in candidates if r.role == "mixed"]
        return [r for r in candidates if r.role == "mixed"]

    def _choose(self, req: Request, candidates: List[Replica]) -> Replica:
        if self.policy.placement == "prefix":
            rep = self._choose_by_prefix(req, candidates)
            if rep is not None:
                return rep
        if self.policy.placement in ("session", "prefix"):
            sess = self._session_of.get(req.id)
            if sess is not None:
                home = self._session_map.get(sess)
                for rep in candidates:
                    if rep.index == home:
                        return rep
        return min(candidates, key=lambda r: (r.load, r.index))

    def _choose_by_prefix(self, req: Request,
                          candidates: List[Replica]) -> Optional[Replica]:
        """Score candidates by matched-prefix depth x occupancy
        headroom from their advertised directories: the request lands
        where its prefix already lives UNLESS that replica is nearly
        full (a deep match on a saturated pool would evict what it came
        for). None when no candidate matches anything — the caller
        falls back to session pin / least-loaded."""
        from ..serve.kvpool import prefix_hashes, prefix_match_depth
        best: Optional[Replica] = None
        best_key: Tuple[float, int, int] = (0.0, 0, 0)
        for rep in candidates:
            try:
                d = rep.transport.prefix_directory()
            except TransportError:
                continue
            if not d or not d.get("digests") or not d.get("block_size"):
                continue
            depth = prefix_match_depth(
                prefix_hashes(req.prompt, int(d["block_size"])),
                set(d["digests"]))
            if depth == 0:
                continue
            total = max(1, int(d.get("blocks_total", 1)))
            headroom = max(0.05, int(d.get("blocks_free", 0)) / total)
            key = (depth * headroom, -rep.load, -rep.index)
            if key > best_key:
                best, best_key = rep, key
        if best is not None:
            get_registry().counter("serve.fleet.prefix_placements").inc()
        return best

    def _kv_handoff(self, req: Request, sess: str, old_idx: int,
                    new_rep: Replica) -> None:
        """Session remap off its home replica: actually move the
        session's shared-prefix KV. Order matters and each step keeps
        the warm/cold counter semantics:

        1. probe the NEW home (warm/cold classifies what this handoff
           costs — before the import, or shipping would mask itself);
        2. export the cached prefix blocks from the OLD home (raw bytes
           in-process, int8-serialized across a process boundary);
        3. seat them into the new home's pool (refcount-0 cached
           entries: the request's admission takes the refs);
        4. invalidate the old home (the conversation continues on the
           new home; a later remap BACK must re-prefill, not extend a
           stale prefix).

        Transports without a paged pool no-op every step — the hook
        then only moves counters, exactly the in-process router behavior."""
        reg = get_registry()
        reg.counter("serve.fleet.kv_handoff_total").inc()
        old_tr = self.replicas[old_idx].transport
        new_tr = new_rep.transport
        warm = new_tr.cached_prefix_blocks(req.prompt)
        shipped = nbytes = 0
        if not warm:
            try:
                payload = old_tr.export_prefix(req.prompt)
            except TransportError:
                payload = None    # dead home: nothing to ship
            if payload is not None:
                nbytes = int(payload.get("nbytes", 0))
                try:
                    shipped = new_tr.import_prefix(payload)
                except TransportError:
                    shipped = 0
        if shipped:
            reg.counter("serve.fleet.kv_handoff_shipped").inc(shipped)
            reg.counter("serve.fleet.kv_handoff_bytes").inc(nbytes)
            reg.gauge(labelled("serve.fleet.handoff_bytes",
                               replica=new_rep.index)).set(nbytes)
        invalidated = 0
        try:
            invalidated = old_tr.invalidate_prefix(req.prompt)
        except TransportError:
            pass
        if invalidated:
            reg.counter(
                "serve.fleet.kv_handoff_invalidated").inc(invalidated)
        reg.counter("serve.fleet.kv_handoff_warm" if warm
                    else "serve.fleet.kv_handoff_cold").inc()
        self.events.event("resilience", action="kv_handoff",
                          request=req.id, session=sess,
                          from_replica=old_idx, to_replica=new_rep.index,
                          invalidated=invalidated, warm_blocks=warm,
                          shipped_blocks=shipped, bytes=nbytes,
                          trace=req.trace_id, stage="handoff",
                          attempts=req.attempts)

    def _replicate_hot_prefixes(self) -> None:
        """Push hot prefixes (refcount >= ``policy.kv_hot_refs``) to one
        sibling each, ahead of demand, through the same export/import
        path a session remap uses. A digest ships at most once per
        (digest, target) pair — ``_kv_replicated`` remembers what went
        where — and at most ``kv_replicate_max_per_tick`` exports run
        per tick so replication never starves placement."""
        reg = get_registry()
        budget = self.policy.kv_replicate_max_per_tick
        healthy = [r for r in self.replicas if r.state == HEALTHY]
        if len(healthy) < 2:
            return
        for src in healthy:
            if budget <= 0:
                return
            try:
                hot = src.transport.hot_prefixes(self.policy.kv_hot_refs)
            except TransportError:
                continue
            for entry in hot:
                if budget <= 0:
                    return
                digest = entry.get("digest")
                tokens = entry.get("tokens")
                if not digest or not tokens:
                    continue
                shipped_to = self._kv_replicated.setdefault(digest, set())
                sibling = None
                sib_free = -1.0
                for rep in healthy:
                    if rep is src or rep.index in shipped_to:
                        continue
                    try:
                        d = rep.transport.prefix_directory()
                    except TransportError:
                        continue
                    if d and digest in set(d.get("digests", ())):
                        shipped_to.add(rep.index)   # already resident
                        continue
                    free = (int(d.get("blocks_free", 0))
                            / max(1, int(d.get("blocks_total", 1)))
                            if d else 0.0)
                    if free > sib_free:
                        sibling, sib_free = rep, free
                if sibling is None:
                    continue
                budget -= 1
                try:
                    payload = src.transport.export_prefix(tokens)
                except TransportError:
                    continue
                if payload is None:
                    continue
                try:
                    seated = sibling.transport.import_prefix(payload)
                except TransportError:
                    continue
                shipped_to.add(sibling.index)
                if seated:
                    nbytes = int(payload.get("nbytes", 0))
                    reg.counter("serve.fleet.kv_replicated").inc(seated)
                    reg.counter("serve.fleet.kv_replicated_bytes").inc(
                        nbytes)
                    self.events.event(
                        "serve", action="kv_replicated",
                        digest=digest[:12], blocks=seated,
                        refs=entry.get("refs"),
                        from_replica=src.index,
                        to_replica=sibling.index, bytes=nbytes)

    def _try_place(self, req: Request, now: float) -> bool:
        candidates = self._role_filter(req, self._placeable())
        if not candidates:
            return False
        rep = self._choose(req, candidates)
        sess = self._session_of.get(req.id)
        if sess is not None:
            home = self._session_map.get(sess)
            if home is not None and home != rep.index:
                self._kv_handoff(req, sess, home, rep)
        if self.journal is not None:
            self.journal.append("place", request=req.id,
                                replica=rep.index,
                                attempts=req.attempts + 1)
        try:
            rep.transport.place(req)        # increments req.attempts
        except TransportError:
            self._transport_drop(rep, now)
            return False
        self._placed_on[req.id] = rep.index
        if sess is not None and rep.state == HEALTHY:
            self._session_map[sess] = rep.index
        self.events.event(REQUEST, request=req.id, trace=req.trace_id,
                          stage="placed", replica=rep.index,
                          attempts=req.attempts)
        return True

    # -- health state machine ----------------------------------------------

    def _inflight_on(self, rep: Replica) -> List[Request]:
        """Requests currently placed on this replica, per the
        controller's own ledger — the authoritative in-flight map when
        the transport can no longer be asked."""
        return [self._tracked[rid]
                for rid, idx in list(self._placed_on.items())
                if idx == rep.index and rid in self._tracked]

    def _transport_drop(self, rep: Replica, now: float) -> None:
        """The transport died (not necessarily the replica): reclaim
        everything in flight there from the controller ledger and
        retire the replica — exactly-once holds because the ledger
        lives here and the dead connection's frames are never read
        again. One-way, like a wedge, but with no drain (nothing can be
        asked to drain)."""
        if rep.state == RETIRED:
            return
        reg = get_registry()
        reg.counter("serve.fleet.transport_drops").inc()
        # Responses the wire delivered before it died but no poll ever
        # drained: deliver them. The work is done and (on the process
        # transport) their tokens are already in ``obs_tokens_out``, so
        # reclaiming those requests would run a second decode elsewhere
        # and leave counted-but-undelivered tokens breaking the
        # observer's reconciliation. Delivered BEFORE computing the
        # in-flight set so they drop out of ``_placed_on`` first.
        try:
            salvaged = rep.transport.salvage()
        except Exception:
            salvaged = []
        for resp in salvaged:
            out = self._deliver(resp)
            if out is not None:
                self._pending_out.append(out)
        if salvaged:
            reg.counter("serve.fleet.salvaged").inc(len(salvaged))
        inflight = self._inflight_on(rep)
        for req in inflight:
            self._placed_on.pop(req.id, None)
        self.events.event("resilience", action="transport_drop",
                          replica=rep.index, inflight=len(inflight),
                          salvaged=len(salvaged))
        rep.state = RETIRED
        reg.counter("serve.fleet.retired").inc()
        try:
            rep.transport.close()
        except Exception:
            pass
        self.reclaim(inflight, now)

    def _wedge(self, rep: Replica, reason: str, now: float) -> None:
        """WEDGED: reclaim the backlog intact, re-place or park it under
        the retry budget, and start draining the live slots. One-way."""
        rep.state = WEDGED
        get_registry().counter("serve.fleet.wedged").inc()
        try:
            evicted = self._as_requests(rep.transport.evict_queued())
        except TransportError:
            # the transport is gone too: the drop path reclaims the
            # whole in-flight set itself — reclaiming `evicted` here as
            # well would park every request TWICE and break the
            # exactly-once ledger with duplicate terminals
            self._transport_drop(rep, now)
            return
        self.events.event("resilience", action="replica_wedged",
                          replica=rep.index, reason=reason,
                          evicted=len(evicted))
        for req in evicted:
            self._placed_on.pop(req.id, None)
        # terminal responses land in the ledger; tick's delivered list
        # picks them up via response() like any mid-health-pass finish
        self.reclaim(evicted, now)
        if rep.state == WEDGED:          # transport still up: drain live
            try:
                rep.transport.drain()
                rep.state = DRAINING
            except TransportError:
                self._transport_drop(rep, now)

    def _update_health(self, rep: Replica, now: float) -> None:
        p = self.policy
        if rep.state == RETIRED:
            return
        if rep.state == DRAINING:
            try:
                if rep.transport.drained:
                    rep.state = RETIRED
                    get_registry().counter("serve.fleet.retired").inc()
                    self.events.event("resilience",
                                      action="replica_retired",
                                      replica=rep.index)
            except TransportError:
                self._transport_drop(rep, now)
            return

        try:
            h = rep.transport.health()
        except TransportError:
            self._transport_drop(rep, now)
            return
        if not h.alive or (p.heartbeat_timeout_s is not None
                           and h.heartbeat_age_s > p.heartbeat_timeout_s):
            self._wedge(rep, f"heartbeat lost (age="
                             f"{h.heartbeat_age_s:.3f}s)", now)
            return
        slow = h.slow_streak
        ewma = h.miss_ewma
        derr = h.consecutive_decode_errors
        if rep.had_error_this_tick:
            rep.error_ticks += 1

        if (slow >= p.wedge_slow_streak or derr >= p.wedge_decode_errors
                or rep.error_ticks >= p.wedge_error_ticks):
            self._wedge(rep, f"slow_streak={slow} decode_errors={derr} "
                             f"error_ticks={rep.error_ticks}", now)
            return

        bad = (slow >= p.suspect_slow_streak or derr > 0
               or rep.had_error_this_tick
               or (p.suspect_miss_ewma is not None
                   and ewma > p.suspect_miss_ewma))
        if rep.state == HEALTHY and bad:
            rep.state = SUSPECT
            rep.healthy_streak = 0
            get_registry().counter("serve.fleet.suspected").inc()
            self.events.event("resilience", action="replica_suspect",
                              replica=rep.index, slow_streak=slow,
                              decode_errors=derr, miss_ewma=ewma)
        elif rep.state == SUSPECT:
            if bad:
                rep.healthy_streak = 0
            else:
                rep.healthy_streak += 1
                if rep.healthy_streak >= p.recover_healthy_ticks:
                    rep.state = HEALTHY
                    rep.healthy_streak = 0
                    get_registry().counter("serve.fleet.recovered").inc()
                    self.events.event("resilience",
                                      action="replica_recovered",
                                      replica=rep.index)

    def _lifecycle(self, now: float) -> None:
        """Spawn on sustained front-queue depth; retire sustained-idle
        replicas (never below ``min_replicas`` placeable ones)."""
        p = self.policy
        active = [r for r in self.replicas if r.state in (HEALTHY, SUSPECT)]
        if p.spawn_depth is not None and self.spawn_fn is not None:
            if self.queue.depth >= p.spawn_depth:
                self._depth_streak += 1
            else:
                self._depth_streak = 0
            if self._depth_streak >= p.spawn_sustain_ticks \
                    and len(active) < p.max_replicas:
                rep = self._add_replica(self.spawn_fn())
                self._depth_streak = 0
                get_registry().counter("serve.fleet.spawned").inc()
                self.events.event("resilience", action="replica_spawned",
                                  replica=rep.index,
                                  front_depth=self.queue.depth)
        if p.retire_idle_ticks is None:
            return
        for rep in self.replicas:
            if rep.state != HEALTHY:
                continue
            if rep.transport.idle and self.queue.depth == 0 \
                    and not self._parked:
                rep.idle_ticks += 1
            else:
                rep.idle_ticks = 0
            active = [r for r in self.replicas
                      if r.state in (HEALTHY, SUSPECT)]
            if rep.idle_ticks >= p.retire_idle_ticks \
                    and len(active) > p.min_replicas:
                rep.transport.drain()
                rep.state = DRAINING
                rep.idle_ticks = 0
                get_registry().counter("serve.fleet.idle_retired").inc()
                self.events.event("resilience",
                                  action="replica_idle_retired",
                                  replica=rep.index)

    # -- the fleet tick ----------------------------------------------------

    def tick(self) -> List[Response]:
        """One fleet scheduling round: sweep the front/parked sets,
        advance every replica's health machine, place onto HEALTHY
        replicas, poll the replicas (serial in-process transports tick
        here; async/process replicas tick themselves and this just
        drains), then deliver-or-retry their terminal responses.
        Returns the responses DELIVERED this tick (retried failures are
        not delivered — they park)."""
        reg = get_registry()
        now = self.clock()
        tick_idx = self._tick_index
        delivered: List[Response] = []

        # 0) fleet drain — push back everything not yet on a replica
        if self._draining:
            for req in self.queue.evict_all():
                delivered.append(
                    self._finish_unplaced(req, "shed", "drain", now))
            for _, req in self._parked:
                delivered.append(
                    self._finish_unplaced(req, "shed", "drain", now))
            self._parked = []

        # 1) front + parked sweeps — deaths that never cost a replica
        for req, reason in self.queue.reap(now):
            status = "cancelled" if reason == "cancelled" else "timeout"
            delivered.append(
                self._finish_unplaced(req, status, reason, now))
        still = []
        for eligible_at, req in self._parked:
            if req.cancelled:
                delivered.append(
                    self._finish_unplaced(req, "cancelled", "cancelled",
                                          now))
            elif req.deadline is not None and now >= req.deadline:
                delivered.append(
                    self._finish_unplaced(req, "timeout", "deadline", now))
            else:
                still.append((eligible_at, req))
        self._parked = still

        # 2) health transitions + lifecycle (uses last tick's signals)
        for rep in self.replicas:
            self._update_health(rep, now)
            rep.had_error_this_tick = False
        if not self._draining:
            self._lifecycle(now)

        # 2b) dead fleet — no replica can ever serve again (none healthy
        # or recoverable, no spawn hook armed): fail the stranded work
        # now instead of parking it forever
        recoverable = any(r.state in (HEALTHY, SUSPECT)
                          for r in self.replicas)
        can_spawn = (self.spawn_fn is not None
                     and self.policy.spawn_depth is not None)
        if not recoverable and not can_spawn and not self._draining:
            stranded = self.queue.evict_all() + [r for _, r in self._parked]
            self._parked = []
            for req in stranded:
                reg.counter("serve.fleet.retries_exhausted").inc()
                delivered.append(self._finish_unplaced(
                    req, "error", "no_replicas", now))

        # 3) placement — parked retries first (oldest work), then front
        if not self._draining:
            still = []
            for eligible_at, req in self._parked:
                if eligible_at > now or not self._try_place(req, now):
                    still.append((eligible_at, req))
            self._parked = still
            while self.queue.depth and self._placeable():
                req = self.queue.pop()
                if not self._try_place(req, now):
                    # the pop is not a lease on delivery: placement can
                    # race a transport death (place RPC hits a socket
                    # that just died → drop → False) and the request
                    # must survive it — park for the next sweep
                    self._parked.append((now, req))

        # 3b) proactive hot-prefix replication — before the poll so a
        # prefix shipped this tick is visible to next tick's placement
        if self.policy.kv_hot_refs is not None and not self._draining:
            self._replicate_hot_prefixes()

        # 4) poll the replicas, deliver-or-retry what they finish
        for rep in self.replicas:
            if rep.state == RETIRED:
                continue
            try:
                finished = rep.transport.poll()
            except TransportError:
                self._transport_drop(rep, now)
                continue
            for resp in finished:
                req = self._tracked.get(resp.request_id)
                if (resp.status == "error"
                        and resp.finish_reason in RETRYABLE_REASONS
                        and req is not None):
                    rep.had_error_this_tick = True
                    self._placed_on.pop(req.id, None)
                    delivered.extend(self.reclaim([req], now))
                    continue
                out = self._deliver(resp)
                if out is not None:
                    delivered.append(out)

        # 5) fleet gauges
        counts = self.counts()
        for state, n in counts.items():
            reg.gauge(f"serve.fleet.replicas_{state}").set(n)
        reg.gauge("serve.fleet.front_depth").set(self.queue.depth)
        reg.gauge("serve.fleet.parked").set(len(self._parked))
        if self.journal is not None:
            reg.gauge("serve.fleet.journal_records").set(
                self.journal.records_written)
            reg.gauge("serve.fleet.journal_bytes").set(
                self.journal.bytes_written)
            age = self.journal.fsync_age_s
            if age is not None:
                reg.gauge("serve.fleet.journal_fsync_age_s").set(age)
        for rep in self.replicas:
            tr = rep.transport
            reg.gauge(labelled("serve.fleet.replica.state",
                               replica=rep.index)).set(
                _STATE_CODE[rep.state])
            if rep.state == RETIRED:
                continue
            try:
                h = tr.health()
                reg.gauge(labelled("serve.fleet.replica.queue_depth",
                                   replica=rep.index)).set(tr.queue_depth)
                reg.gauge(labelled("serve.fleet.replica.live_slots",
                                   replica=rep.index)).set(tr.live_slots)
                reg.gauge(labelled("serve.fleet.rpc_inflight",
                                   replica=rep.index)).set(tr.rpc_inflight)
                reg.gauge(labelled("serve.fleet.rpc_retries",
                                   replica=rep.index)).set(tr.rpc_retries)
                reg.gauge(labelled("serve.fleet.heartbeat_age_s",
                                   replica=rep.index)).set(
                    h.heartbeat_age_s)
            except TransportError:
                self._transport_drop(rep, now)
        # responses salvaged off a dropped transport this tick (already
        # in the ledger) — surface them through the normal return path
        if self._pending_out:
            delivered.extend(self._pending_out)
            self._pending_out = []
        self._tick_index = tick_idx + 1
        return delivered

    # -- convenience loops -------------------------------------------------

    def run_until_idle(self, max_ticks: int = 1_000_000) -> List[Response]:
        """Tick until every tracked request delivered. With every
        replica dead this still terminates: retries exhaust their
        budgets and the dead-fleet sweep fails anything stranded."""
        delivered: List[Response] = []
        for _ in range(max_ticks):
            if self.idle:
                return delivered
            delivered.extend(self.tick())
        raise RuntimeError(
            f"fleet not idle after {max_ticks} ticks (front="
            f"{self.queue.depth}, parked={len(self._parked)}, "
            f"replicas={self.counts()})")
