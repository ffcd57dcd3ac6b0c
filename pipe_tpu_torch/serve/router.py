"""Fleet front door: N serve-engine replicas behind one request queue.

Counterpart of ``pipe_tpu/serve/router.py``, copied (host code only).

The placement/health/exactly-once state machine lives in
:mod:`~..fleet.control` (the transport-agnostic
:class:`~..fleet.control.FleetController`), where it coordinates both
in-process engines and real OS-process replicas
(:mod:`~..fleet.proc`). This module keeps the original engine-facing
constructor — :class:`Router` is the controller over
:class:`~..fleet.control.InProcessTransport` wrappers, one per engine —
so a caller holding engines builds a fleet in one call:

* **One front queue, N replica queues.** Callers submit to the router's
  bounded :class:`~.queue.RequestQueue` (ids are fleet-unique — replica
  queues never mint ids); each tick the router places waiting requests
  onto HEALTHY replicas, least-loaded or session-affine. Deadlines,
  priorities and cancellation ride the *same* :class:`~.queue.Request`
  object end-to-end: ``submitted_at``/``deadline`` are set once at
  submit and survive every re-queue, so a failed-over request never
  regains deadline credit, and ``cancel`` is one flag flip wherever the
  request currently sits (front, parked for retry, replica queue, or a
  live slot).

* **A health state machine per replica**, driven entirely by signals
  the engines already export — the :class:`~..resilience.TickWatchdog`
  read-only surface (``slow_streak``, ``miss_ewma``) plus
  ``ServeEngine.consecutive_decode_errors`` and retryable-failure
  responses. States::

      HEALTHY --(slow streak / decode error / retryable failure)--> SUSPECT
      SUSPECT --(recover_healthy_ticks clean ticks)--> HEALTHY
      HEALTHY|SUSPECT --(wedge thresholds)--> WEDGED
      WEDGED --(queued work evicted, drain() issued)--> DRAINING
      DRAINING --(engine.drained)--> RETIRED

  SUSPECT only stops *placement* (hysteresis: transient stalls must not
  flap work across the fleet); WEDGED is one-way — the replica's queued
  requests are reclaimed intact (``evict_queued``) and its live slots
  run out under ``drain()``.

* **Retry budgets, not retry storms.** A request bounced by a wedged or
  erroring replica (``finish_reason`` ``backend_error``/``stuck``) is
  parked with exponential backoff (``backoff_base_s * 2^(attempts-1)``,
  capped) and re-placed on a healthy replica while
  ``attempts < retry_budget`` (attempts counts placements). Budget
  exhausted → one terminal ``status="error"`` /
  ``finish_reason="retries_exhausted"`` response. Every submitted id
  yields **exactly one** terminal :class:`~.queue.Response` through the
  router — a duplicate delivery raises.

* **Lifecycle**: ``spawn_fn`` adds a replica after the front queue sits
  at ``spawn_depth`` for ``spawn_sustain_ticks`` consecutive ticks;
  ``retire_idle_ticks`` drains replicas the traffic no longer needs
  (never below ``min_replicas``). Both are host decisions between
  ticks; compiled programs are untouched.

The router is strictly additive: not constructing one changes nothing
anywhere (``apps/serve.py`` keeps the direct single-engine path, and
the engines' captured programs are the same — the opt-out-is-absent
discipline of the resilience layer). The default serial mode is
single-threaded like the engine tick loop; ``async_tick=True`` gives
each replica its own tick thread (:class:`~..fleet.control
.InProcessTransport` async mode), so one slow replica no longer stalls
its siblings — the fleet ``tick()`` then only sweeps/places/delivers.
Replica chaos (``wedge_replica``/``kill_replica``/``slow_replica``)
wraps the replica backends only when a
:class:`~..resilience.ChaosPlan` is passed.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Sequence

from ..fleet.control import (DRAINING, HEALTHY, RETIRED, RETRYABLE_REASONS,
                             STATES, SUSPECT, WEDGED, _STATE_CODE,
                             FleetController, InProcessTransport, Replica,
                             RouterPolicy)
from .engine import ServeEngine
from .queue import RequestQueue

__all__ = ["Router", "RouterPolicy", "Replica",
           "HEALTHY", "SUSPECT", "WEDGED", "DRAINING", "RETIRED"]

# re-exported for callers that imported them from here
_ = (STATES, _STATE_CODE, RETRYABLE_REASONS)


class Router(FleetController):
    """Shard one front :class:`~.queue.RequestQueue` across N
    :class:`~.engine.ServeEngine` replicas with health-gated failover.

    ``engines`` must be homogeneous (same model/buckets/caps — admission
    validation uses replica 0's backend) and each must own its own
    queue on the *same clock* as the front queue. ``spawn_fn`` (if
    given) builds one more engine on demand for the spawn hook.
    ``chaos`` arms replica-level fault injection
    (:data:`~..resilience.chaos.REPLICA_KINDS`, addressed by
    ``Fault.stage`` = replica index); None leaves the backends
    untouched. ``async_tick=True`` runs each replica under its own tick
    thread instead of the serial per-``tick()`` round-robin.

    The surface mirrors :class:`~.engine.ServeEngine` — ``submit`` /
    ``tick`` / ``cancel`` / ``response`` / ``drain`` / ``idle`` /
    ``run_until_idle`` — so drivers (``apps/serve.py``) swap one for
    the other without restructuring their loop.
    """

    def __init__(self, engines: Sequence[ServeEngine],
                 queue: Optional[RequestQueue] = None, *,
                 policy: RouterPolicy = RouterPolicy(),
                 spawn_fn: Optional[Callable[[], ServeEngine]] = None,
                 chaos=None, event_log=None,
                 clock: Optional[Callable[[], float]] = None,
                 async_tick: bool = False):
        engines = list(engines)
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        if queue is None:
            queue = RequestQueue(clock=clock or time.monotonic)
        elif clock is not None and clock is not queue.clock:
            raise ValueError(
                "pass the clock on the queue (router adopts queue.clock)")
        seen = set()
        for eng in engines:
            if eng.queue is queue:
                raise ValueError(
                    "a replica engine may not share the router's front "
                    "queue (the router owns placement)")
            if id(eng.queue) in seen:
                raise ValueError(
                    "replica engines may not share a queue with each "
                    "other (each replica owns its backlog)")
            seen.add(id(eng.queue))
            if eng.clock is not queue.clock:
                raise ValueError(
                    "every replica engine must run on the front queue's "
                    "clock (deadlines are absolute in one clock domain)")
        self.chaos = chaos
        self.async_tick = bool(async_tick)
        wrapped_spawn = None
        if spawn_fn is not None:
            def wrapped_spawn():
                return InProcessTransport(spawn_fn(),
                                          async_tick=self.async_tick)
        super().__init__(
            [InProcessTransport(e, async_tick=self.async_tick)
             for e in engines],
            queue, policy=policy, spawn_fn=wrapped_spawn,
            event_log=event_log)

    # -- construction helpers ----------------------------------------------

    def _add_replica(self, transport: InProcessTransport) -> Replica:
        rep = super()._add_replica(transport)
        # trace completeness for the in-process fleet: replica engines
        # built without their own event log inherit the router's, so
        # per-request prefill/terminal records land in the SAME stream
        # the controller's queued/placed/delivered records use and
        # FleetObserver.stitch() sees one complete timeline (the
        # process-fleet equivalent ships child events over the wire)
        from ..obs.events import NULL_EVENT_LOG
        eng = getattr(transport, "engine", None)
        if eng is not None and eng.events is NULL_EVENT_LOG \
                and self.events is not NULL_EVENT_LOG:
            eng.events = self.events
        if self.chaos is not None:
            self._install_chaos(rep)
        return rep

    def _install_chaos(self, rep: Replica) -> None:
        """Wrap this replica's backend so planned replica faults fire at
        the router tick they cover. Kill/wedge raise from BOTH prefill
        and decode (a dead box fails everything); slow sleeps inside
        decode so the replica's own watchdog sees the overrun — chaos
        manifests only through the signals real faults would produce."""
        from ..resilience.chaos import ChaosError
        plan, router, idx = self.chaos, self, rep.index
        backend = rep.engine.backend
        orig_decode, orig_prefill = backend.decode, backend.prefill

        def _dead() -> Optional[str]:
            t = router._tick_index
            if plan.replica_fault("kill_replica", t, idx) is not None:
                return "kill_replica"
            if plan.replica_fault("wedge_replica", t, idx) is not None:
                return "wedge_replica"
            return None

        def chaotic_decode(live, *args, **kwargs):
            kind = _dead()
            if kind is not None:
                raise ChaosError(
                    f"injected {kind} on replica {idx} at router tick "
                    f"{router._tick_index}")
            f = plan.replica_fault("slow_replica", router._tick_index, idx)
            if f is not None:
                time.sleep(f.magnitude)
            return orig_decode(live, *args, **kwargs)

        # wraps() keeps the wrapped prefill's signature visible so the
        # engine's demand-kwarg probe (_prefill_kwargs) sees the real
        # backend: paged pools still get max_new_tokens, 3-arg
        # stub/legacy backends still get the legacy call.
        @functools.wraps(orig_prefill)
        def chaotic_prefill(slot, prompt, seed, **kw):
            kind = _dead()
            if kind is not None:
                raise ChaosError(
                    f"injected {kind} on replica {idx} at router tick "
                    f"{router._tick_index}")
            return orig_prefill(slot, prompt, seed, **kw)

        backend.decode = chaotic_decode
        backend.prefill = chaotic_prefill
