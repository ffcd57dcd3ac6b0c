"""Disaggregated prefill/decode serving: phase-specialized replicas.

Counterpart of ``pipe_tpu/fleet/disagg.py``, copied (host code only).

A mixed replica runs both phases in one engine, so a burst of long
prompts stalls every live decode slot behind multi-chunk prefills (the
engine admits first, then runs ONE decode chunk per tick) — TTFT and
decode tail latency fight for the same host loop. Disaggregation
splits the fleet by phase instead:

* **prefill replicas** (``ReplicaSpec.role="prefill"``) run only the
  chunked-prefill program at large batch. Requests arrive clamped to
  ``max_new_tokens=1`` and retire at their first token — the engine's
  existing one-token fast path — leaving the prefix blocks cached in
  the replica's paged pool.
* **decode replicas** (``role="decode"``) run only the resident decode
  loop at high slot counts. They never prefill from scratch: the
  controller ships the prefill replica's cached prefix blocks through
  the existing ``export_prefix_payload``/``import_prefix_payload``
  path (raw bytes in-process, int8 across the wire) before placement,
  and a decode-only engine refuses a cold multi-block prompt outright
  (``serve/engine.py:_check_phase``).
* **mixed replicas** stay what they always were, and are the fallback
  for either phase when a role pool is empty or entirely sick.

:class:`DisaggController` subclasses :class:`~.control.FleetController`
and keeps every invariant it proved — one front queue, the health
machine, retry budgets, and most importantly the exactly-once delivery
ledger. The two-phase flow is built from pieces the base controller
already has:

1. ``submit`` stashes the caller's ``max_new_tokens``, clamps the
   request to 1 token and tags ``req.phase="prefill"``; role-aware
   placement (``_role_filter``) routes it to the prefill pool.
2. The prefill replica retires the request after its first token — a
   **shadow terminal**. ``_deliver`` intercepts it before the ledger:
   the response is consumed (never client-visible), the request flips
   to ``phase="decode"`` with its original budget restored, and
   re-enters placement through the parked queue. Consuming the shadow
   also pops ``_placed_on``, so a prefill replica dying later cannot
   reclaim (and double-place) a request that already moved on.
3. Decode placement ships the KV prefix (warm-probe first, exactly the
   warm-probe handoff discipline) and places. The decode replica resumes
   from the seated blocks and generates the full budget; with the same
   per-request seed the first token is regenerated identically, so no
   stream stitching is needed. Only this terminal reaches the client.

Failure anywhere routes through the base controller's one
park-or-finish gate (``reclaim``): a prefill replica SIGKILLed before
the shadow is polled has it salvaged off the dead wire and consumed
the same way; killed after export but before the decode import
acknowledges, the ship simply comes up cold and the request falls back
to a mixed replica for an ordinary prefill — one delivery either way.

:func:`suggest_roles` is the cost-driven planner: it sizes the
prefill:decode split from measured per-phase token costs (the
telemetry the engine already records — TTFT and per-token decode
histograms) instead of by hand.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..obs.events import REQUEST
from ..obs.telemetry import get_registry, labelled
from .control import RETIRED, FleetController, Replica, TransportError

if False:  # type-hint names only (serve imports stay lazy, see control.py)
    from ..serve.queue import Request, Response  # noqa: F401

__all__ = ["DisaggController", "RoleSuggestion", "suggest_roles"]


class DisaggController(FleetController):
    """Phase-aware fleet controller: every request flows
    prefill → KV handoff → decode across role-specialized replicas.

    Construction is the base controller's: pass transports whose
    ``role`` attributes carry the split (``ReplicaSpec.role`` for
    process replicas, the ``role=`` kwarg or the engine's ``phase``
    for in-process ones). A fleet of only mixed replicas degenerates
    to two placements per request on the same pool — correct, just
    pointless — so deployments gate on ``suggest_roles`` first.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # per-request disagg state, keyed by request id. Entries live
        # from submit to the CLIENT-VISIBLE terminal (the decode
        # phase's, or a genuine failure in either phase).
        self._orig_max_new: Dict[int, int] = {}
        self._prefill_on: Dict[int, int] = {}   # id -> prefill replica
        # shadow tokens consumed (never delivered): the observer adds
        # these to the delivered side of its token reconciliation,
        # because the prefill replica's obs_tokens_out counted them
        self.obs_shadow_tokens = 0

    # -- front door --------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None, seed: int = 0,
               priority: int = 0, timeout_s: Optional[float] = None,
               session: Optional[str] = None):
        """Validate/enqueue like the base controller (against the full
        token budget), then clamp the request to its prefill phase."""
        req = super().submit(prompt, max_new_tokens=max_new_tokens,
                             seed=seed, priority=priority,
                             timeout_s=timeout_s, session=session)
        self._orig_max_new[req.id] = req.max_new_tokens
        req.max_new_tokens = 1
        req.phase = "prefill"
        get_registry().counter("serve.fleet.disagg_submitted").inc()
        return req

    # -- the shadow-terminal interception ----------------------------------

    def _deliver(self, resp):
        rid = resp.request_id
        req = self._tracked.get(rid)
        if (req is not None and req.phase == "prefill"
                and resp.status == "ok"):
            return self._consume_shadow(req, resp)
        # genuine terminal (decode finished, or a failure in either
        # phase): drop the disagg state and deliver exactly once
        self._orig_max_new.pop(rid, None)
        self._prefill_on.pop(rid, None)
        return super()._deliver(resp)

    def _consume_shadow(self, req, resp) -> None:
        """The prefill phase's one-token terminal: never delivered.
        Remember where the prefix now lives, restore the caller's
        budget, flip the request to its decode phase and re-enter it
        through the parked queue (eligible immediately — backoff is for
        failures; this is progress). Popping ``_placed_on`` here is the
        exactly-once hinge: the request is no longer "in flight" on the
        prefill replica, so a later transport drop there reclaims
        nothing for it."""
        if self.journal is not None:
            # durable BEFORE the hinge: a crash after this record knows
            # the request crossed into its decode phase (and where the
            # prefix lives), a crash before it replays the prefill
            self.journal.append(
                "shadow", request=req.id,
                src=self._placed_on.get(req.id),
                max_new_tokens=self._orig_max_new.get(
                    req.id, req.max_new_tokens))
        src = self._placed_on.pop(req.id, None)
        if src is not None:
            self._prefill_on[req.id] = src
        req.max_new_tokens = self._orig_max_new.get(
            req.id, req.max_new_tokens)
        req.phase = "decode"
        self.obs_shadow_tokens += len(resp.tokens)
        now = self.clock()
        self._parked.append((now, req))
        reg = get_registry()
        reg.counter("serve.fleet.disagg_prefill_done").inc()
        if src is not None:
            role = self.replicas[src].role
            reg.counter(labelled("serve.fleet.handoff_requests",
                                 role=role)).inc()
        self.events.event(REQUEST, request=req.id, trace=req.trace_id,
                          stage="handoff", replica=src,
                          attempts=req.attempts,
                          tokens=len(resp.tokens))
        return None

    # -- crash recovery ----------------------------------------------------

    def _restore_phase(self, req, state) -> None:
        """Rebuild the disagg tags for one recovered orphan. The
        journal's ``submit`` record carries the FULL budget (the base
        controller journals before this class clamps), so: a ``shadow``
        record means the request already crossed the hinge — restore
        the budget and re-enter as its decode phase, remembering the
        prefix source; no shadow record means the prefill never
        finished — re-clamp to one token and replay the prefill."""
        self._orig_max_new[req.id] = req.max_new_tokens
        rec = state.shadow.get(req.id)
        if rec is not None:
            req.phase = "decode"
            src = rec.get("src")
            if src is not None:
                self._prefill_on[req.id] = int(src)
        else:
            req.phase = "prefill"
            req.max_new_tokens = 1

    def _salvage(self, rep, resp):
        """Replayed responses are phase-ambiguous on a disagg fleet: a
        prefill child's retained window holds SHADOW frames, and a
        shadow for a request whose hinge is already journaled is a
        duplicate — consuming it again would restart the decode phase
        a decode child may be about to answer. Only a shadow the crash
        interrupted (the request still tagged ``prefill``) is progress;
        everything else from a prefill child is dropped, and decode
        children salvage as usual."""
        req = self._tracked.get(resp.request_id)
        if resp.status == "ok" and (req is None or req.phase != "prefill"):
            if rep.role == "prefill":
                return None           # prefill children never hold terminals
            if (rep.role == "mixed" and len(resp.tokens) <= 1
                    and req is not None and req.max_new_tokens > 1):
                return None           # a mixed child's replayed shadow
        return self._deliver(resp)

    # -- decode placement (KV ship + fallbacks) ----------------------------

    def _try_place(self, req, now: float) -> bool:
        if req.phase == "decode":
            return self._place_decode(req, now)
        return super()._try_place(req, now)

    def _place_decode(self, req, now: float) -> bool:
        """Place the decode phase: choose from the decode pool (mixed
        as fallback), ship the prefix from the prefill replica unless
        the target is already warm, then place. A decode-only engine
        that still refuses (the ship came up cold — prefill replica
        dead, pool mismatch, prefix evicted) falls back to a mixed
        replica, which re-prefills like any ordinary request; no mixed
        replica either → the request flips back to its prefill phase
        for a fresh prefix (never parked-forever in a static fleet)."""
        placeable = self._placeable()
        candidates = self._role_filter(req, placeable)
        if not candidates:
            return False
        rep = self._choose(req, candidates)
        src = self._prefill_on.get(req.id)
        if src is not None and src != rep.index:
            self._ship_prefix(req, src, rep)
        try:
            rep.transport.place(req)        # increments req.attempts
        except TransportError:
            self._transport_drop(rep, now)
            return False
        except ValueError:
            if rep.role != "decode":
                raise                       # mixed refused: genuine
            get_registry().counter(
                "serve.fleet.disagg_decode_refused").inc()
            mixed = [r for r in placeable if r.role == "mixed"]
            if not mixed:
                # "Parked until a mixed replica recovers" is FOREVER in
                # a static prefill/decode fleet: the prefix is gone
                # (evicted under pool pressure, or the source died) and
                # every retry re-fails identically. Send the request
                # back through the prefill phase instead — re-clamp,
                # forget the stale source, and the parked queue
                # re-enters it on the prefill pool for a fresh prefix.
                # Exactly-once holds (no decode placement happened) and
                # the per-request retry budget still bounds the loop.
                self._prefill_on.pop(req.id, None)
                req.max_new_tokens = 1
                req.phase = "prefill"
                get_registry().counter(
                    "serve.fleet.disagg_reprefill").inc()
                return False
            rep = min(mixed, key=lambda r: (r.load, r.index))
            get_registry().counter(
                "serve.fleet.disagg_mixed_fallback").inc()
            try:
                rep.transport.place(req)
            except TransportError:
                self._transport_drop(rep, now)
                return False
        self._placed_on[req.id] = rep.index
        self.events.event(REQUEST, request=req.id, trace=req.trace_id,
                          stage="placed", replica=rep.index,
                          attempts=req.attempts, phase="decode")
        return True

    def _ship_prefix(self, req, src_idx: int, rep: Replica) -> bool:
        """Move the request's cached prefix blocks from the prefill
        replica to the decode target — warm-probe first (
        discipline: record what the handoff COST, not what it did),
        then export/import. Every failure degrades to cold: the caller
        decides whether cold is acceptable (mixed target re-prefills)
        or grounds for fallback (decode target refuses). True when the
        target ends up warm."""
        reg = get_registry()
        warm = 0
        try:
            warm = rep.transport.cached_prefix_blocks(req.prompt)
        except TransportError:
            pass
        if warm:
            reg.counter("serve.fleet.disagg_handoff_warm").inc()
            return True
        payload = None
        src_rep = self.replicas[src_idx]
        if src_rep.state != RETIRED:
            try:
                payload = src_rep.transport.export_prefix(req.prompt)
            except TransportError:
                payload = None      # died mid-export: ship nothing
        seated = nbytes = 0
        if payload is not None:
            nbytes = int(payload.get("nbytes", 0))
            try:
                seated = rep.transport.import_prefix(payload)
            except TransportError:
                seated = 0          # died mid-import: target is cold
        if seated:
            reg.counter("serve.fleet.disagg_handoff_shipped").inc(seated)
            reg.counter("serve.fleet.disagg_handoff_bytes").inc(nbytes)
            reg.gauge(labelled("serve.fleet.handoff_bytes",
                               replica=rep.index,
                               role=rep.role)).set(nbytes)
        else:
            reg.counter("serve.fleet.disagg_handoff_cold").inc()
        self.events.event("resilience", action="disagg_kv_ship",
                          request=req.id, from_replica=src_idx,
                          to_replica=rep.index, shipped_blocks=seated,
                          bytes=nbytes, trace=req.trace_id,
                          stage="handoff", attempts=req.attempts)
        return seated > 0


# ---------------------------------------------------------------------------
# the cost-driven role planner


@dataclasses.dataclass(frozen=True)
class RoleSuggestion:
    """What :func:`suggest_roles` decided and why. ``roles`` is
    index-aligned with the fleet's transports; ``prefill_frac`` is the
    prefill share of per-request compute the split was sized from;
    ``source`` records where the per-token costs came from
    (``"args"``, ``"telemetry"``, or ``"uniform"`` when neither had
    data)."""

    roles: List[str]
    n_prefill: int
    n_decode: int
    prefill_frac: float
    prefill_token_s: float
    decode_token_s: float
    source: str


def suggest_roles(n_replicas: int, *, prompt_len: int,
                  max_new_tokens: int,
                  prefill_token_s: Optional[float] = None,
                  decode_token_s: Optional[float] = None,
                  registry=None) -> RoleSuggestion:
    """Size the prefill:decode split from measured phase costs.

    The prefill share of one request's compute is
    ``f = L_p * c_p / (L_p * c_p + L_d * c_d)`` for expected prompt
    length ``L_p``, token budget ``L_d`` and per-token costs ``c_p``
    (prefill) and ``c_d`` (decode). The fleet should put ``round(f*n)``
    replicas on prefill — clamped to ``[1, n-1]`` so neither pool is
    empty — because a pool sized below its compute share becomes the
    bottleneck and the other idles (the pipeline-planning argument:
    stage shares should track measured stage costs, not symmetry).

    Costs default from the serving telemetry already being recorded:
    ``serve.engine.ttft_sec`` (mean TTFT / prompt length approximates
    the per-token prefill cost — TTFT is dominated by the prefill
    chunks) and ``serve.engine.token_sec`` (mean per-token decode
    latency). Pass ``prefill_token_s``/``decode_token_s`` to override
    (a bench measuring them directly, or capacity planning for a
    workload not yet served). With no telemetry and no overrides the
    costs fall back to uniform (``f`` is then just the token-count
    ratio). Fleets of fewer than two replicas stay all-mixed — there
    is nothing to specialize.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if prompt_len < 1 or max_new_tokens < 1:
        raise ValueError(
            f"prompt_len and max_new_tokens must be >= 1, got "
            f"{prompt_len} and {max_new_tokens}")
    source = "args"
    if prefill_token_s is None or decode_token_s is None:
        reg = registry if registry is not None else get_registry()
        ttft = reg.histogram("serve.engine.ttft_sec")
        toks = reg.histogram("serve.engine.token_sec")
        if prefill_token_s is None and ttft.count:
            prefill_token_s = (ttft.sum / ttft.count) / max(1, prompt_len)
            source = "telemetry"
        if decode_token_s is None and toks.count:
            decode_token_s = toks.sum / toks.count
            source = "telemetry"
    if prefill_token_s is None or decode_token_s is None \
            or prefill_token_s <= 0 or decode_token_s <= 0:
        prefill_token_s = decode_token_s = 1.0
        source = "uniform"
    pre = prompt_len * prefill_token_s
    dec = max_new_tokens * decode_token_s
    frac = pre / (pre + dec)
    if n_replicas < 2:
        return RoleSuggestion(roles=["mixed"] * n_replicas, n_prefill=0,
                              n_decode=0, prefill_frac=frac,
                              prefill_token_s=prefill_token_s,
                              decode_token_s=decode_token_s,
                              source=source)
    n_pre = min(max(int(round(frac * n_replicas)), 1), n_replicas - 1)
    return RoleSuggestion(
        roles=["prefill"] * n_pre + ["decode"] * (n_replicas - n_pre),
        n_prefill=n_pre, n_decode=n_replicas - n_pre, prefill_frac=frac,
        prefill_token_s=prefill_token_s, decode_token_s=decode_token_s,
        source=source)
