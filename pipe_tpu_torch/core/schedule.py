"""Pipeline schedules as data (plain numpy).

Counterpart of ``pipe_tpu/core/schedule.py``, copied: it imports only numpy,
so only its imports change. The reference's only schedule is the GPipe
fill-drain clock-cycle wavefront (``_clock_cycles``, reference
``pipeline.py:63-79``): at cycle ``k`` every pair ``(i, j)`` with
``i + j == k`` runs, for micro-batch ``i`` of ``m`` on stage ``j`` of ``n``,
giving ``m + n - 1`` cycles and a bubble fraction of ``(n - 1) / (m + n - 1)``.

Here a schedule is an object producing that wavefront as *data*, so the same
(i, j) contract drives the serial emulator (``parallel/emulator.py``, which
walks ``cycles``) and the table executor (``parallel/scheduled.py``, which
walks ``op_tables``), and the other schedules (1F1B, interleaved 1F1B,
zero-bubble) slot in without touching the executors. The overlapped-transport
retimer, the phase compiler and the elastic re-plan are copied with the rest;
the port's one-device executor runs the serialized tables and consults them
only through the tests and ``memory_plan``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "clock_cycles",
    "bubble_fraction",
    "Schedule",
    "GPipeSchedule",
    "OneFOneBSchedule",
    "InterleavedSchedule",
    "InterleavedOneFOneBSchedule",
    "get_schedule",
    "verify_op_tables",
    "verify_interleaved_op_tables",
    "IDLE",
    "FWD",
    "BWD",
    "WGRAD",
    "ZeroBubbleSchedule",
    "ZeroBubbleDeepSchedule",
    "verify_zb_op_tables",
    "zb_joint_capacity",
    "shift_comm_tables",
    "verify_shifted_op_tables",
    "overlap_fifo_capacity",
    "align_phase_tables",
    "segment_phases",
    "compile_phases",
    "PhaseSegment",
    "PhaseProgram",
    "PhaseVerdict",
    "PHASE_KLASS_FB",
    "PHASE_KLASS_FBW",
    "ElasticPlan",
    "replan_stage_loss",
]

# Op codes for the (cycle, stage) tables driving the manual fwd+bwd executor
# (parallel.scheduled.ScheduledPipeline). BWD is the combined backward
# (input AND weight grads in one slot) for the classic schedules; zero-bubble
# tables split it into BWD (= B, input-grad only, rides the rigid reverse
# ring) and WGRAD (= W, weight-grad only, freely deferrable).
IDLE, FWD, BWD, WGRAD = 0, 1, 2, 3


def _place(op: np.ndarray, mbi: np.ndarray, t: int, j: int,
           code: int, i: int) -> None:
    if op[t, j] != IDLE:
        raise AssertionError(
            f"schedule collision at cycle {t}, stage {j}: "
            f"op {op[t, j]} already placed, tried {code} (mb {i})")
    op[t, j] = code
    mbi[t, j] = i


def clock_cycles(m: int, n: int) -> Iterator[List[Tuple[int, int]]]:
    """Anti-diagonal wavefront: cycle k runs {(i, j) : i + j == k}.

    Direct capability match of reference ``pipeline.py:63-79``.
    m micro-batches over n stages in m + n - 1 cycles.
    """
    for k in range(m + n - 1):
        yield [(k - j, j) for j in range(max(0, k - m + 1), min(n, k + 1))]


def bubble_fraction(m: int, n: int) -> float:
    """GPipe analytical bubble: (n-1)/(m+n-1) of cycles are idle fill/drain."""
    return (n - 1) / (m + n - 1)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base schedule: maps (micro-batches m, stages n) to an ordered cycle list.

    ``cycles(m, n)[k]`` is the list of (microbatch, stage) pairs that may run
    concurrently at cycle k. Executors rely only on this contract.
    """

    name: str = "base"

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        raise NotImplementedError

    def num_cycles(self, m: int, n: int) -> int:
        return len(self.cycles(m, n))

    def bubble(self, m: int, n: int) -> float:
        total = self.num_cycles(m, n) * n
        busy = m * n
        return (total - busy) / total

    # --- manual fwd+bwd executor contract (parallel.scheduled) ---

    def op_tables(self, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(op[T, n], mb[T, n])`` over ``T = 2(m+n-1)`` uniform slots.

        ``op[t, j]`` says what stage ``j`` does at cycle ``t`` (IDLE/FWD/BWD)
        and ``mb[t, j]`` on which micro-batch. Invariants every table must
        satisfy (asserted by construction + :func:`verify_op_tables`):

        * each (i, j) appears exactly once as FWD and once as BWD;
        * FWD of (i, j) happens strictly after FWD of (i, j-1);
        * BWD of (i, j) happens exactly one cycle after BWD of (i, j+1)
          (gradients ride a reverse ppermute with no buffering);
        * BWD of (i, j) happens after FWD of (i, j).
        """
        raise NotImplementedError

    def stash_slots(self, m: int, n: int) -> int:
        """Max simultaneously-live stashed input activations per stage."""
        raise NotImplementedError

    def wstash_slots(self, m: int, n: int) -> int:
        """Max live deferred-W cotangents per stage (0 unless the schedule
        splits backward into B and W ops — see :class:`ZeroBubbleSchedule`)."""
        return 0

    @property
    def splits_backward(self) -> bool:
        """True when op tables carry separate B (input-grad) and W
        (weight-grad) ops — the zero-bubble lineage. Executors consult this
        to shape carries and to warn on checkpoint modes that defeat the
        split (see :class:`ZeroBubbleSchedule`'s executor note)."""
        return False

    @property
    def v(self) -> int:
        """Interleave depth: virtual stages per device (1 = not interleaved)."""
        return 1


@dataclasses.dataclass(frozen=True)
class GPipeSchedule(Schedule):
    """Synchronous fill–drain (the reference's schedule, ``pipeline.py:63-79``)."""

    name: str = "gpipe"

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        return [list(c) for c in clock_cycles(m, n)]

    def op_tables(self, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fill–drain forward then full reverse wavefront backward.

        Forward is the reference wavefront (FWD of (i, j) at cycle ``i + j``,
        ``pipeline.py:63-79``); backward is its mirror, the order the autograd
        engine discovers at runtime in the reference (LIFO per stage,
        ``pipeline.py:128-132``) — here precomputed as data.
        """
        T = 2 * (m + n - 1)
        op = np.full((T, n), IDLE, np.int32)
        mbi = np.zeros((T, n), np.int32)
        for j in range(n):
            for i in range(m):
                _place(op, mbi, i + j, j, FWD, i)
                _place(op, mbi, (m + n - 1) + (m - 1 - i) + (n - 1 - j),
                       j, BWD, i)
        return op, mbi

    def stash_slots(self, m: int, n: int) -> int:
        """All m forwards complete before any backward: O(m) live inputs."""
        return m


@dataclasses.dataclass(frozen=True)
class OneFOneBSchedule(Schedule):
    """1F1B: one-forward-one-backward with at most ``min(m, n)`` micro-batches
    in flight per stage (the memory property the reference's fork/join
    machinery exists to enable, ``pipeline.py:128-132``; torchgpipe lineage
    ``pipe.py:230-232``).

    Stage ``j`` runs ``min(m, n-j)`` warm-up forwards, then alternates
    backward/forward, then drains backwards:

    * FWD of (i, j) at cycle ``i + j``        for ``i <  n - j`` (warm-up)
    * FWD of (i, j) at cycle ``2i + j``       for ``i >= n - j`` (steady)
    * BWD of (i, j) at cycle ``2n - 1 - j + 2i``

    Same ``2(m+n-1)`` total slots — and hence the same bubble — as GPipe;
    the win is the activation-memory cap, not the bubble.
    """

    name: str = "1f1b"

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        return [list(c) for c in clock_cycles(m, n)]

    def op_tables(self, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        T = 2 * (m + n - 1)
        op = np.full((T, n), IDLE, np.int32)
        mbi = np.zeros((T, n), np.int32)
        for j in range(n):
            for i in range(m):
                tf = i + j if i < n - j else 2 * i + j
                _place(op, mbi, tf, j, FWD, i)
                _place(op, mbi, 2 * n - 1 - j + 2 * i, j, BWD, i)
        return op, mbi

    def stash_slots(self, m: int, n: int) -> int:
        """BWD of i precedes FWD of i + min(m, n) at every stage, so a
        ``min(m, n)``-slot ring buffer of stashed inputs never collides."""
        return min(m, n)


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule(Schedule):
    """Interleaved 1F1B: each device hosts ``v`` non-contiguous stage chunks.

    With v virtual stages per device the fill bubble shrinks by ~v
    (BASELINE.json config #4: 8-stage BERT-large, interleaved).

    Contract note: ``cycles(m, n)`` takes ``n`` = the TOTAL number of stages
    the executor holds (already virtual), same as every other schedule — the
    interleaving changes *placement* (``device_of``: virtual stage s lives on
    device ``s % n_devices``) and the per-device bubble model, not the
    wavefront over stages.
    """

    name: str = "interleaved"
    v: int = 2

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        return [list(c) for c in clock_cycles(m, n)]

    def virtual_stages(self, n_devices: int) -> int:
        return n_devices * self.v

    def device_of(self, virtual_stage: int, n_devices: int) -> int:
        return virtual_stage % n_devices

    def device_bubble(self, m: int, n_devices: int) -> float:
        """Per-device fill/drain bubble ≈ (d-1)/(m·v + d-1): v× smaller fill."""
        d = n_devices
        return (d - 1) / (m * self.v + d - 1)


@dataclasses.dataclass(frozen=True)
class InterleavedOneFOneBSchedule(Schedule):
    """Interleaved 1F1B: ``v`` virtual stages per device, forward AND
    backward as one static table (BASELINE config #4's schedule).

    Virtual stage ``s`` of ``S = v * d`` lives on device ``s % d`` — every
    boundary ``s -> s+1`` is one hop on the WRAPAROUND device ring, so one
    uniform ppermute moves all inter-group traffic. Tables come from a
    greedy constructor honoring the manual executor's transport contract:

    * FWD(i, s) at least one cycle after FWD(i, s-1) (park in stash);
    * BWD(i, s) EXACTLY one cycle after BWD(i, s+1) (cotangents ride the
      reverse ring unbuffered) — backward chains are rigid once seeded, so
      the constructor reserves whole chains at the earliest collision-free
      cycle and fills remaining slots with the deepest available forward;
    * per device one op per cycle.

    vs plain 1F1B of the same S virtual stages, the fill/drain shrinks
    (e.g. m=8, d=4, v=2: 42 cycles vs 46) — the interleave bubble win with
    1F1B's activation cap, where :class:`InterleavedSchedule` (AD executor)
    keeps GPipe's O(m) liveness.
    """

    name: str = "interleaved-1f1b"
    interleave: int = 2

    @property
    def v(self) -> int:
        return self.interleave

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        raise NotImplementedError(
            "interleaved-1f1b is a manual-executor schedule; it has no "
            "forward-only wavefront (use op_tables)")

    @functools.lru_cache(maxsize=64)
    def op_tables(self, m: int, d: int):
        """``(op[T, d], mb[T, d], grp[T, d])`` over devices (not stages).

        Cached: the greedy constructor is pure Python over the whole table
        and is consulted repeatedly (trace time, stash_slots, memory_plan,
        per-log-line bubble reporting); the dataclass is frozen/hashable.
        """
        v = self.interleave
        S = v * d
        max_T = 4 * (m * v + d) + 8
        op = np.full((max_T, d), IDLE, np.int32)
        mbi = np.zeros((max_T, d), np.int32)
        grp = np.zeros((max_T, d), np.int32)
        t_fwd = np.full((m, S), -1)
        t_bwd = np.full((m, S), -1)
        reserved: dict = {}

        def chain_free(t0):
            return all((t0 + (S - 1 - s), s % d) not in reserved
                       and t0 + (S - 1 - s) < max_T for s in range(S))

        def reserve_chain(t0, i):
            for s in range(S):
                reserved[(t0 + (S - 1 - s), s % d)] = (i, s)

        next_seed = 0
        for t in range(max_T):
            while (next_seed < m and 0 <= t_fwd[next_seed, S - 1] < t):
                t0 = t
                while not chain_free(t0):
                    t0 += 1
                reserve_chain(t0, next_seed)
                next_seed += 1
            for p in range(d):
                if (t, p) in reserved:
                    i, s = reserved[(t, p)]
                    op[t, p], mbi[t, p], grp[t, p] = BWD, i, s // d
                    t_bwd[i, s] = t
                    continue
                placed = False
                for g in range(v - 1, -1, -1):      # deepest group first
                    s = g * d + p
                    for i in range(m):
                        if t_fwd[i, s] >= 0:
                            continue
                        if s > 0 and not (0 <= t_fwd[i, s - 1] < t):
                            continue
                        op[t, p], mbi[t, p], grp[t, p] = FWD, i, g
                        t_fwd[i, s] = t
                        placed = True
                        break
                    if placed:
                        break
            if (t_bwd >= 0).all():
                T = t + 1
                return op[:T], mbi[:T], grp[:T]
        raise AssertionError(
            f"interleaved-1f1b table construction did not converge "
            f"(m={m}, d={d}, v={v})")

    def stash_slots(self, m: int, d: int) -> int:
        """Peak live stashed inputs per VIRTUAL stage, from the tables."""
        op, mbi, grp = self.op_tables(m, d)
        _, _, cap = _virtual_times(op, mbi, grp, m, d, self.interleave)
        return cap

    def num_cycles(self, m: int, d: int) -> int:
        return self.op_tables(m, d)[0].shape[0]

    def bubble(self, m: int, d: int) -> float:
        T = self.num_cycles(m, d)
        return (T * d - 2 * m * self.interleave * d) / (T * d)


def _virtual_times(op, mbi, grp, m, d, v):
    """(t_fwd[m, S], t_bwd[m, S], peak stash capacity) from device tables."""
    S = v * d
    T = op.shape[0]
    t_fwd = np.full((m, S), -1)
    t_bwd = np.full((m, S), -1)
    for t in range(T):
        for p in range(d):
            s = grp[t, p] * d + p
            i = mbi[t, p]
            if op[t, p] == FWD:
                assert t_fwd[i, s] == -1, (t, p)
                t_fwd[i, s] = t
            elif op[t, p] == BWD:
                assert t_bwd[i, s] == -1, (t, p)
                t_bwd[i, s] = t
    assert (t_fwd >= 0).all() and (t_bwd >= 0).all(), "missing ops"
    cap = 0
    for s in range(S):
        arrive = t_fwd[:, s] if s == 0 else t_fwd[:, s - 1] + 1
        free = t_bwd[:, s]
        # ring indexing i % cap needs the live set to be a contiguous i
        # range: arrivals and frees must each be monotone in i
        assert (np.diff(arrive) > 0).all(), f"non-FIFO arrivals at {s}"
        assert (np.diff(free) > 0).all(), f"non-FIFO frees at {s}"
        for t in range(T):
            cap = max(cap, int(np.sum((arrive <= t) & (t <= free))))
    return t_fwd, t_bwd, cap


def verify_interleaved_op_tables(op, mbi, grp, m: int, d: int,
                                 v: int) -> None:
    """Invariants for device-major interleaved tables (see
    :class:`InterleavedOneFOneBSchedule`): each (i, virtual stage) runs FWD
    and BWD exactly once on the right device, forward order is strict,
    backward chains step exactly one cycle per hop, and the FIFO property
    the stash ring indexing relies on holds."""
    S = v * d
    t_fwd, t_bwd, _ = _virtual_times(op, mbi, grp, m, d, v)
    for i in range(m):
        for s in range(S):
            assert t_bwd[i, s] > t_fwd[i, s], (i, s)
            if s + 1 < S:
                assert t_fwd[i, s] < t_fwd[i, s + 1], (i, s)
                assert t_bwd[i, s] == t_bwd[i, s + 1] + 1, (i, s)


def verify_op_tables(op: np.ndarray, mbi: np.ndarray, m: int, n: int,
                     stash_slots: Optional[int] = None,
                     comm_shift: int = 1,
                     wstash_slots: Optional[int] = None) -> None:
    """Check the :meth:`Schedule.op_tables` invariants (see docstring there).

    A table passing this check — *including* the stash-capacity check, so
    pass the schedule's ``stash_slots(m, n)`` — executes correctly on the
    manual executor; new schedules only need to emit valid tables.

    ``comm_shift`` selects the transport contract the table is proved
    against. ``1`` (default) is the serialized contract: a boundary value
    sent at cycle ``t`` is consumable at ``t + 1``, and the reverse ring is
    rigid (``BWD(i, j) == BWD(i, j+1) + 1`` exactly). ``>= 2`` is the
    overlapped (software-pipelined) contract of
    :func:`verify_shifted_op_tables`: sends fly while the next cycle
    computes, so every receive must land ``comm_shift`` cycles after its
    send and the reverse ring becomes an elastic receive FIFO.

    W-bearing (split-backward) tables are first-class here: a table with
    any ``WGRAD`` op is routed through the split-aware invariants — W
    strictly after its own B (W consumes B's parked cotangent), and the
    stash-capacity check accounts activations as freed by W, not B (B
    alone does not release the stage input; its W still needs the taps).
    ``wstash_slots`` then additionally bounds the B->W cotangent park.
    """
    if comm_shift > 1:
        verify_shifted_op_tables(
            op, mbi, None, m=m, d=n, v=1, hop=comm_shift,
            stash_slots=stash_slots,
            splits_backward=bool((np.asarray(op) == WGRAD).any()))
        return
    if (np.asarray(op) == WGRAD).any():
        verify_zb_op_tables(op, mbi, m, n, stash_slots=stash_slots,
                            wstash_slots=wstash_slots)
        return
    t_fwd = np.full((m, n), -1)
    t_bwd = np.full((m, n), -1)
    for t in range(op.shape[0]):
        for j in range(n):
            if op[t, j] == FWD:
                assert t_fwd[mbi[t, j], j] == -1, (t, j)
                t_fwd[mbi[t, j], j] = t
            elif op[t, j] == BWD:
                assert t_bwd[mbi[t, j], j] == -1, (t, j)
                t_bwd[mbi[t, j], j] = t
    assert (t_fwd >= 0).all() and (t_bwd >= 0).all(), "missing ops"
    for i in range(m):
        for j in range(n):
            assert t_bwd[i, j] > t_fwd[i, j], f"bwd before fwd at {(i, j)}"
            if j + 1 < n:
                # fwd must be strictly earlier upstream; bwd exactly one
                # cycle later downstream (ring transport, no grad buffering)
                assert t_fwd[i, j] < t_fwd[i, j + 1], (i, j)
                assert t_bwd[i, j] == t_bwd[i, j + 1] + 1, (i, j)
    if stash_slots is not None:
        # Slot i % S parks micro-batch i's input from its arrival (one cycle
        # after the upstream FWD; its own FWD cycle on stage 0) until its BWD
        # reads it — micro-batch i + S must not arrive before that read.
        S = stash_slots
        t_arrive = np.where(
            np.arange(n)[None, :] == 0, t_fwd,
            np.roll(t_fwd, 1, axis=1) + 1)
        for j in range(n):
            for i in range(m - S):
                assert t_arrive[i + S, j] > t_bwd[i, j], (
                    f"stash slot clobber: micro-batch {i + S} arrives at "
                    f"stage {j} (t={t_arrive[i + S, j]}) before micro-batch "
                    f"{i}'s backward reads the slot (t={t_bwd[i, j]}); "
                    f"stash_slots={S} is too small for this table")


@dataclasses.dataclass(frozen=True)
class ZeroBubbleSchedule(Schedule):
    """Zero-bubble pipeline schedule (ZB-H1 lineage, Qi et al. 2023 —
    beyond the reference, which only ships GPipe fill-drain).

    Backward splits into two table ops: **B** (``BWD``: input-gradient only
    — must ride the rigid one-hop-per-cycle reverse ring, exactly like the
    combined backward of :class:`OneFOneBSchedule`) and **W** (``WGRAD``:
    weight-gradient only — depends only on its own B, so it can be deferred
    into slots that would otherwise idle during fill and drain). With
    roughly equal F/B/W op costs the drain bubble fills completely: e.g.
    (m=8, n=4) per-op-slot bubble drops from 27.3% (1F1B counting B+W as
    two units in one slot) to 11.1% — ~2.4x less idle (the exact figures
    ``bubble()`` reports and ``test_zb_tables_verify_and_beat_1f1b_bubble``
    pins).

    Memory matches 1F1B's activation cap in steady state, plus the deferred
    window: stashed stage inputs live until their W (not their B) consumes
    them, and each deferred (i, j) parks one activation-sized cotangent
    from B to W (``wstash_slots``).

    Executor note (``parallel.scheduled``): with ``checkpoint='never'`` the
    retained autograd graph serves both B and W — B asks it for the
    stage-input cotangent only (``retain_graph=True``) and W for the
    parameter gradients only, so each walks the stage's backward once.
    Under recompute modes the graph only exists once the forward has been
    re-run at B, so the executor computes the FULL backward there and the W
    slots carry no compute — correct and recompute-once, but the
    bubble-filling premise is gone, and construction warns. Zero-bubble
    scheduling is designed for (and shines with) stored activations: pair
    with ``checkpoint='never'``.

    Measurement honesty: the win is the table's idle fraction, which pays
    off when per-cycle time is compute-dominated across devices. On one
    device there is no bubble to fill, and W's second walk of the backward
    is extra work; the bubble advantage is the verified table property.
    """

    name: str = "zb-h1"

    @property
    def splits_backward(self) -> bool:
        return True

    def cycles(self, m: int, n: int) -> List[List[Tuple[int, int]]]:
        raise NotImplementedError(
            "zb-h1 is a manual-executor schedule; it has no forward-only "
            "wavefront (use op_tables)")

    @functools.lru_cache(maxsize=64)
    def op_tables(self, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy constructor: reserve rigid B chains at the earliest
        collision-free seed, fill free slots with the deepest-dependency-
        ready forward, then with the oldest pending W; one op per (cycle,
        device)."""
        max_T = 6 * (m + n) + 8
        op = np.full((max_T, n), IDLE, np.int32)
        mbi = np.zeros((max_T, n), np.int32)
        t_fwd = np.full((m, n), -1)
        t_b = np.full((m, n), -1)
        t_w = np.full((m, n), -1)
        reserved: dict = {}

        def chain_free(t0):
            # B(i, j) at t0 + (n-1-j): seed at the last stage, one hop/cycle
            return all((t0 + (n - 1 - j), j) not in reserved
                       and t0 + (n - 1 - j) < max_T for j in range(n))

        def reserve_chain(t0, i):
            for j in range(n):
                reserved[(t0 + (n - 1 - j), j)] = i

        next_seed = 0
        for t in range(max_T):
            # seed B chains for micro-batches whose last-stage forward is done
            while next_seed < m and 0 <= t_fwd[next_seed, n - 1] < t:
                t0 = t
                while not chain_free(t0):
                    t0 += 1
                reserve_chain(t0, next_seed)
                next_seed += 1
            for j in range(n):
                if (t, j) in reserved:
                    i = reserved[(t, j)]
                    _place(op, mbi, t, j, BWD, i)
                    t_b[i, j] = t
                    continue
                # forward: lowest micro-batch with upstream done, capped so
                # stashed inputs stay 1F1B-bounded — an input lives until
                # its W here, so the cap counts F-done-W-pending
                placed = False
                in_flight = int(np.sum((t_fwd[:, j] >= 0) & (t_w[:, j] < 0)))
                if in_flight < self._in_flight_cap(m, n):
                    for i in range(m):
                        if t_fwd[i, j] >= 0:
                            continue
                        if j > 0 and not (0 <= t_fwd[i, j - 1] < t):
                            break  # FIFO per stage: earlier i must go first
                        _place(op, mbi, t, j, FWD, i)
                        t_fwd[i, j] = t
                        placed = True
                        break
                if placed:
                    continue
                # weight-grad: oldest micro-batch with B done, W pending
                for i in range(m):
                    if t_b[i, j] >= 0 and t_w[i, j] < 0 and t_b[i, j] < t:
                        _place(op, mbi, t, j, WGRAD, i)
                        t_w[i, j] = t
                        break
            if (t_w >= 0).all():
                return op[:t + 1], mbi[:t + 1]
        raise AssertionError(
            f"zb-h1 table construction did not converge (m={m}, n={n})")

    def _in_flight_cap(self, m: int, n: int) -> int:
        """Max forwards admitted per stage before their W retires (keeps
        stashed inputs 1F1B-bounded; the zb-h2 variant widens this)."""
        return min(m, n + 1)

    def _times(self, m: int, n: int):
        return _zb_times(*self.op_tables(m, n), m, n)

    def stash_slots(self, m: int, n: int) -> int:
        """Peak live stashed inputs per stage — live until W (not B)."""
        t_fwd, _, t_w = self._times(m, n)
        arrive = np.where(np.arange(n)[None, :] == 0, t_fwd,
                          np.roll(t_fwd, 1, axis=1) + 1)
        T = self.num_cycles(m, n)
        cap = 0
        for j in range(n):
            for t in range(T):
                cap = max(cap, int(np.sum((arrive[:, j] <= t)
                                          & (t <= t_w[:, j]))))
        return cap

    def wstash_slots(self, m: int, n: int) -> int:
        """Peak live deferred cotangents per stage (B -> W window)."""
        _, t_b, t_w = self._times(m, n)
        T = self.num_cycles(m, n)
        cap = 0
        for j in range(n):
            for t in range(T):
                cap = max(cap, int(np.sum((t_b[:, j] <= t)
                                          & (t <= t_w[:, j]))))
        return cap

    def num_cycles(self, m: int, n: int) -> int:
        return self.op_tables(m, n)[0].shape[0]

    def bubble(self, m: int, n: int) -> float:
        """Idle fraction of op slots: each (i, j) occupies THREE slots
        (F, B, W), so busy = 3mn of T*n."""
        T = self.num_cycles(m, n)
        return (T * n - 3 * m * n) / (T * n)


@dataclasses.dataclass(frozen=True)
class ZeroBubbleDeepSchedule(ZeroBubbleSchedule):
    """The zb-v-ish variant (ZB-H2 lineage, Qi et al. 2023): same greedy
    constructor and rigid B chains as :class:`ZeroBubbleSchedule`, but the
    per-stage in-flight cap widens from ``n + 1`` to ``2n - 1`` — extra
    forwards are admitted during warmup so the fill-side idle slots carry
    real F work, and their deferred Ws drain into the cooldown. The memory
    trade is explicit: ``stash_slots`` grows toward ``2n - 1`` stage
    inputs per device (vs 1F1B's ``n``), which is exactly the knob ZB-H2
    turns — trade activation memory for bubble. ``bubble()`` at (m=8,
    n=4) drops below zb-h1's 11.1% (the analytic model in
    ``obs/zb_model.py`` and ``test_zb_deep_*`` pin the ordering
    zb-h2 < zb-h1 < 1f1b)."""

    name: str = "zb-h2"

    def _in_flight_cap(self, m: int, n: int) -> int:
        return min(m, max(2 * n - 1, n + 1))


def _zb_times(op: np.ndarray, mbi: np.ndarray, m: int, n: int):
    """Reconstruct (t_fwd, t_b, t_w) from split-backward tables; asserts
    each (i, j) runs each op at most once. Shared by the slot-capacity math
    and the verifier so the op-code mapping cannot drift between them."""
    t_fwd = np.full((m, n), -1)
    t_b = np.full((m, n), -1)
    t_w = np.full((m, n), -1)
    for t in range(op.shape[0]):
        for j in range(n):
            tgt = {FWD: t_fwd, BWD: t_b, WGRAD: t_w}.get(int(op[t, j]))
            if tgt is None:
                continue
            assert tgt[mbi[t, j], j] == -1, (t, j)
            tgt[mbi[t, j], j] = t
    return t_fwd, t_b, t_w


def verify_zb_op_tables(op: np.ndarray, mbi: np.ndarray, m: int, n: int,
                        stash_slots: Optional[int] = None,
                        wstash_slots: Optional[int] = None) -> None:
    """Invariants for split-backward (B/W) tables: every (i, j) runs F, B
    and W exactly once; F order strict downstream; B chains step exactly one
    cycle per hop (unbuffered reverse ring); W strictly after its B; and the
    FIFO/capacity properties the executor's ring indexing relies on."""
    t_fwd, t_b, t_w = _zb_times(op, mbi, m, n)
    assert (t_fwd >= 0).all() and (t_b >= 0).all() and (t_w >= 0).all(), \
        "missing ops"
    for i in range(m):
        for j in range(n):
            assert t_b[i, j] > t_fwd[i, j], f"B before F at {(i, j)}"
            assert t_w[i, j] > t_b[i, j], f"W before B at {(i, j)}"
            if j + 1 < n:
                assert t_fwd[i, j] < t_fwd[i, j + 1], (i, j)
                assert t_b[i, j] == t_b[i, j + 1] + 1, (i, j)
    # FIFO per stage (ring slot indexing i % S needs monotone windows)
    for tt in (t_fwd, t_b, t_w):
        assert (np.diff(tt, axis=0) > 0).all(), "non-FIFO op order"
    arrive = np.where(np.arange(n)[None, :] == 0, t_fwd,
                      np.roll(t_fwd, 1, axis=1) + 1)
    if stash_slots is not None:
        S = stash_slots
        for j in range(n):
            for i in range(m - S):
                assert arrive[i + S, j] > t_w[i, j], \
                    f"stash slot clobber at stage {j}, mb {i}"
    if wstash_slots is not None:
        Wg = wstash_slots
        for j in range(n):
            for i in range(m - Wg):
                assert t_b[i + Wg, j] > t_w[i, j], \
                    f"wstash slot clobber at stage {j}, mb {i}"
    if stash_slots is not None and wstash_slots is not None:
        # Joint capacity: W freeing the stash is what keeps the combined
        # activation footprint (stashed inputs + parked cotangents) at
        # Sg + Wg activation-sized buffers. A table whose true joint peak
        # exceeded the declared slots would alias live values.
        joint = zb_joint_capacity(op, mbi, m, n)
        assert joint <= stash_slots + wstash_slots, (
            f"joint stash+park peak {joint} exceeds declared "
            f"stash_slots + wstash_slots = "
            f"{stash_slots} + {wstash_slots}")


def zb_joint_capacity(op: np.ndarray, mbi: np.ndarray, m: int,
                      n: int) -> int:
    """Peak simultaneous activation-sized live values per stage of a
    split-backward table: stashed stage inputs (live from arrival until
    their W — B alone does not free them, its W still reads the taps) plus
    parked B cotangents (live from B until W). This is the number the
    W op actually SHRINKS versus a hypothetical stash-to-last-read-at-B
    accounting with the full combined backward deferred: deferring only
    the weight-grad half parks one cotangent per in-flight micro-batch
    instead of holding a second full residual set."""
    t_fwd, t_b, t_w = _zb_times(op, mbi, m, n)
    arrive = np.where(np.arange(n)[None, :] == 0, t_fwd,
                      np.roll(t_fwd, 1, axis=1) + 1)
    T = op.shape[0]
    cap = 0
    for j in range(n):
        for t in range(T):
            live_stash = int(np.sum((arrive[:, j] <= t) & (t <= t_w[:, j])))
            live_park = int(np.sum((t_b[:, j] <= t) & (t < t_w[:, j])))
            cap = max(cap, live_stash + live_park)
    return cap


# ---------------------------------------------------------------------------
# Overlapped (software-pipelined) transport: comm slots shifted vs compute
# ---------------------------------------------------------------------------
#
# The serialized executors launch their boundary ppermutes at the END of each
# scan body, and the value is consumable one cycle later — comm sits on the
# critical path between producer and consumer cycles. Overlapped transport
# instead permutes the PREVIOUS cycle's packed boundary buffer at the START
# of a body (no data dependency on that body's compute), parks the arrival
# into a receive FIFO after the compute has read the old carry, and makes it
# readable one body later still. A value produced at cycle t is therefore
# first consumable at t + 2: every cross-stage edge costs ``hop`` (= 2)
# cycles, and a serialized table must be *re-timed* before it can drive the
# overlapped executor. The functions below are that retiming pass and its
# proof obligations.


def _times_by_code(op, mbi, grp, m, d, v):
    """``(t_fwd, t_bwd, t_w)[m, v*d]`` from op tables; ``grp=None`` reads a
    stage-major table (column p IS the stage, v == 1). Unscheduled ops stay
    ``-1``; each (op, i, s) may appear at most once."""
    S = v * d
    times = {FWD: np.full((m, S), -1), BWD: np.full((m, S), -1),
             WGRAD: np.full((m, S), -1)}
    for t in range(op.shape[0]):
        for p in range(op.shape[1]):
            code = int(op[t, p])
            if code == IDLE:
                continue
            s = (int(grp[t, p]) * d + p) if grp is not None else p
            i = int(mbi[t, p])
            assert times[code][i, s] == -1, (t, p)
            times[code][i, s] = t
    return times[FWD], times[BWD], times[WGRAD]


def shift_comm_tables(op, mbi, grp=None, *, m: int, d: int, v: int = 1,
                      hop: int = 2):
    """Re-time a verified serialized table to the overlapped-transport
    contract; returns ``(op, mb, grp)`` device tables.

    Ops are visited in (cycle, device) order — every dependency's producer
    has a strictly smaller original cycle, so one in-order pass suffices —
    and each is assigned the earliest cycle satisfying:

    * one op per device per cycle, in the ORIGINAL per-device order
      (order preservation makes the pass collision-free by construction and
      keeps each device's accumulation order, hence bitwise results,
      identical to the serialized run);
    * ``FWD(i, s) >= FWD(i, s-1) + hop`` — the activation parked from the
      packed forward buffer is readable ``hop`` cycles after its send;
    * ``BWD(i, s) >= BWD(i, s+1) + hop`` — the reverse ring becomes
      *elastic*: cotangents land in a grad-park FIFO instead of being
      consumed in place, so the rigid ``== + 1`` chain relaxes to an
      inequality;
    * ``BWD(i, s) > FWD(i, s)`` and ``WGRAD(i, s) > BWD(i, s)``.

    ``d == 1`` has no transport and returns the input unchanged (plus a
    zero ``grp`` if none was given).
    """
    grp_in = grp if grp is not None else np.zeros_like(op)
    if d <= 1 or hop <= 1:
        return op.copy(), mbi.copy(), grp_in.copy()
    S = v * d
    times = {FWD: np.full((m, S), -1), BWD: np.full((m, S), -1),
             WGRAD: np.full((m, S), -1)}
    last = np.full(op.shape[1], -1, np.int64)
    events = []
    for t in range(op.shape[0]):
        for p in range(op.shape[1]):
            code = int(op[t, p])
            if code == IDLE:
                continue
            i = int(mbi[t, p])
            g = int(grp_in[t, p])
            s = g * d + p
            lo = int(last[p]) + 1
            if code == FWD:
                if s > 0:
                    lo = max(lo, int(times[FWD][i, s - 1]) + hop)
            elif code == BWD:
                lo = max(lo, int(times[FWD][i, s]) + 1)
                if s + 1 < S:
                    lo = max(lo, int(times[BWD][i, s + 1]) + hop)
            else:  # WGRAD
                lo = max(lo, int(times[BWD][i, s]) + 1)
            times[code][i, s] = lo
            last[p] = lo
            events.append((lo, p, code, i, g))
    T2 = int(last.max()) + 1
    op2 = np.full((T2, op.shape[1]), IDLE, np.int32)
    mbi2 = np.zeros((T2, op.shape[1]), np.int32)
    grp2 = np.zeros((T2, op.shape[1]), np.int32)
    for t2, p, code, i, g in events:
        op2[t2, p], mbi2[t2, p], grp2[t2, p] = code, i, g
    return op2, mbi2, grp2


def _check_overlap_windows(arrive, read, K: int, what: str) -> None:
    """Slot-clobber proof under park-after-compute semantics: value ``a``
    parked at ``arrive[a]`` into slot ``a % K`` must survive through its
    last read ``read[a]`` (a read at cycle t sees parks <= t - 1, so a park
    AT the read cycle is safe). ``arrive < 0`` marks entries with no
    arrival (e.g. stage 0) and is skipped."""
    m = len(arrive)
    for a in range(m):
        if arrive[a] < 0:
            continue
        for b in range(m):
            if b == a or arrive[b] < 0 or a % K != b % K:
                continue
            assert not (arrive[a] <= arrive[b] <= read[a] - 1), (
                f"{what}: slot clobber — value {a} (parked t={arrive[a]}, "
                f"last read t={read[a]}) overwritten by value {b} at "
                f"t={arrive[b]} with {K} slots")


def overlap_fifo_capacity(arrive, read) -> int:
    """Smallest slot count K (slots ``i % K``) passing
    :func:`_check_overlap_windows` for the given arrival/last-read cycles.
    Makes no monotonicity assumption — GPipe's backward drains micro-batches
    in DECREASING order, so grad-park arrivals are not FIFO in i."""
    return overlap_joint_capacity([(arrive, read)], len(arrive))


def overlap_joint_capacity(windows, m: int) -> int:
    """Smallest K valid SIMULTANEOUSLY for every ``(arrive, read)`` window
    set in ``windows``. The executor uses one slot count across all virtual
    stages and park uses (slot ``g*K + i % K``), and clobber-freedom is not
    monotone in K (``i % K`` sharing reshuffles as K grows), so the joint
    minimum must be searched, not maxed over per-stage minima. ``K = m``
    always passes (every micro-batch gets its own slot)."""
    for K in range(1, m + 1):
        try:
            for arrive, read in windows:
                _check_overlap_windows(arrive, read, K, "probe")
        except AssertionError:
            continue
        return K
    return m


def verify_shifted_op_tables(op, mbi, grp=None, *, m: int, d: int,
                             v: int = 1, hop: int = 2,
                             splits_backward: bool = False,
                             stash_slots: Optional[int] = None,
                             grad_slots: Optional[int] = None,
                             wstash_slots: Optional[int] = None) -> None:
    """Prove an overlapped-transport table: every receive lands before its
    consumer reads it, for any of the four schedule families (gpipe, 1f1b,
    interleaved-1f1b via ``grp``/``v``, zb-h1 via ``splits_backward``).

    Timing model (see module comment): a boundary value produced at cycle t
    is permuted at t + 1 and parked after that body's compute, so its first
    legal read is t + 2 (= ``hop``). Checks:

    * each (i, s) runs FWD and BWD (and WGRAD iff ``splits_backward``)
      exactly once, on the right device (``s % d``), one op per device per
      cycle (table shape);
    * ``FWD(i, s+1) >= FWD(i, s) + hop`` and ``BWD(i, s) >= BWD(i, s+1) +
      hop`` — no consumer reads a value still in flight;
    * ``BWD > FWD`` and ``WGRAD > BWD`` per (i, s);
    * with capacities given, the park FIFOs never clobber a live value:
      activations (arrive ``FWD(i, s-1) + 1``, last read = the micro-batch's
      last op at s — conservative across recompute modes), grad park
      (arrive ``BWD(i, s+1) + 1``, read at ``BWD(i, s)``), and the local
      B→W cotangent stash for split-backward tables.
    """
    S = v * d
    t_f, t_b, t_w = _times_by_code(op, mbi, grp, m, d, v)
    assert (t_f >= 0).all() and (t_b >= 0).all(), "missing ops"
    if splits_backward:
        assert (t_w >= 0).all(), "missing W ops"
    for i in range(m):
        for s in range(S):
            assert t_b[i, s] > t_f[i, s], f"B before F at {(i, s)}"
            if splits_backward:
                assert t_w[i, s] > t_b[i, s], f"W before B at {(i, s)}"
            if s + 1 < S:
                assert t_f[i, s + 1] >= t_f[i, s] + hop, (
                    f"shifted comm slot violation: FWD({i},{s + 1}) at "
                    f"t={t_f[i, s + 1]} consumes an activation sent at "
                    f"t={t_f[i, s]} that is still in flight "
                    f"(hop={hop})")
                assert t_b[i, s] >= t_b[i, s + 1] + hop, (
                    f"shifted comm slot violation: BWD({i},{s}) at "
                    f"t={t_b[i, s]} consumes a gradient sent at "
                    f"t={t_b[i, s + 1]} that is still in flight "
                    f"(hop={hop})")
    read_last = np.maximum(t_f, np.maximum(t_b, t_w))
    for s in range(S):
        if stash_slots is not None and s > 0:
            _check_overlap_windows(t_f[:, s - 1] + 1, read_last[:, s],
                                   stash_slots, f"stash (stage {s})")
        if grad_slots is not None and s + 1 < S:
            _check_overlap_windows(t_b[:, s + 1] + 1, t_b[:, s],
                                   grad_slots, f"grad park (stage {s})")
        if wstash_slots is not None and splits_backward:
            _check_overlap_windows(t_b[:, s], t_w[:, s],
                                   wstash_slots, f"wstash (stage {s})")


# ---------------------------------------------------------------------------
# Phase compiler: warmup / steady-state / cooldown segmentation of op tables
# ---------------------------------------------------------------------------
#
# The scan-based executors interpret the op tables per cycle: every body
# carries a lax.switch over the op code plus sentinel-masked stores for the
# branches not taken. The phase compiler removes that interpreter overhead
# by compiling the table's STRUCTURE into the program: it re-times the
# serialized table so that at every cycle all devices run the SAME op code
# (cycle-uniformity — the only form of per-cycle specialization a single
# shard_map trace can express without dynamic dispatch), then segments the
# result into short warmup/cooldown ramps (unrolled straight-line, partial
# idles masked by data selects) and maximal dense periodic steady-state
# windows (a fixed-body lax.scan whose body is the period's concrete op
# sequence — no switch, no masked no-ops: every device is busy every cycle).
#
# Bitwise contract: the aligner may change how F and B ops INTERLEAVE on a
# device (the serialized 1F1B in-flight window is provably too small for
# the hop-2 transport latency — keeping its total order forces steady-state
# stalls), but it preserves each (stage, op-code) stream's order. F ops and
# B/W ops touch disjoint accumulators (loss/stats vs grads), so preserving
# per-code order per stage preserves every accumulation order — results
# stay bitwise identical to the interpreted executor on the original table.

#: Residue classes per op code used by the alignment retimer: scheduling
#: each code only on its own residue (mod the class modulus) makes steady
#: state cycle-uniform by construction. ``PHASE_KLASS_FB`` alternates
#: all-F / all-B cycles (period 2: 1f1b lineage); ``PHASE_KLASS_FBW``
#: rotates all-F / all-B / all-W (period 3: split-backward lineage).
PHASE_KLASS_FB = {FWD: (0, 2), BWD: (1, 2)}
PHASE_KLASS_FBW = {FWD: (0, 3), BWD: (1, 3), WGRAD: (2, 3)}


def align_phase_tables(op, mbi, grp=None, *, m: int, d: int, v: int = 1,
                       hop: int = 2, klass=None,
                       priority=(BWD, WGRAD, FWD)):
    """Re-time a serialized table for the overlapped-transport contract via
    time-stepped list scheduling; returns ``(op, mb, grp)`` device tables.

    Unlike :func:`shift_comm_tables` (which preserves each device's TOTAL
    op order and therefore inherits the serialized schedule's in-flight
    window — too small for hop-2 latency, leaving idle holes in steady
    state), this pass preserves only each device's PER-CODE op order (the
    bitwise-parity invariant, see module comment above) and re-derives the
    interleaving: at each cycle every device runs the highest-priority
    code whose residue class (``klass``) admits the cycle and whose queue
    head is dependency-ready under the hop-latency contract

    * ``FWD(i, s)  >= FWD(i, s-1) + hop``
    * ``BWD(i, s)  >= BWD(i, s+1) + hop`` and ``> FWD(i, s)``
    * ``WGRAD(i, s) > BWD(i, s)``

    Default ``priority`` drains backwards eagerly, which caps the live
    stash window at O(d·v·hop) without an explicit in-flight limit.
    """
    grp_in = grp if grp is not None else np.zeros_like(op)
    S = v * d
    q = {c: [[] for _ in range(d)] for c in (FWD, BWD, WGRAD)}
    for t in range(op.shape[0]):
        for p in range(op.shape[1]):
            c = int(op[t, p])
            if c == IDLE:
                continue
            q[c][p].append((int(mbi[t, p]), int(grp_in[t, p]) * d + p))
    times = {FWD: np.full((m, S), -1), BWD: np.full((m, S), -1),
             WGRAD: np.full((m, S), -1)}
    head = {c: [0] * d for c in (FWD, BWD, WGRAD)}
    events = []
    n_total = sum(len(q[c][p]) for c in q for p in range(d))
    n_done = 0
    max_T = (hop + 1) * (op.shape[0] + 4) + 8
    for t in range(max_T):
        if n_done == n_total:
            break
        for p in range(d):
            for c in priority:
                h = head[c][p]
                if h >= len(q[c][p]):
                    continue
                if klass is not None:
                    r, M = klass.get(c, (0, 1))
                    if (t % M) != r:
                        continue
                i, s = q[c][p][h]
                if c == FWD:
                    if s > 0 and not (0 <= times[FWD][i, s - 1] <= t - hop):
                        continue
                elif c == BWD:
                    if not (0 <= times[FWD][i, s] < t):
                        continue
                    if s + 1 < S and not (0 <= times[BWD][i, s + 1]
                                          <= t - hop):
                        continue
                else:
                    if not (0 <= times[BWD][i, s] < t):
                        continue
                times[c][i, s] = t
                head[c][p] = h + 1
                events.append((t, p, c, i, s // d))
                n_done += 1
                break
    if n_done != n_total:
        raise AssertionError(
            f"phase alignment did not converge ({n_done}/{n_total} ops "
            f"placed in {max_T} cycles; klass={klass})")
    T2 = max(e[0] for e in events) + 1
    op2 = np.full((T2, d), IDLE, np.int32)
    mb2 = np.zeros((T2, d), np.int32)
    gr2 = np.zeros((T2, d), np.int32)
    for t2, p, c, i, g in events:
        op2[t2, p], mb2[t2, p], gr2[t2, p] = c, i, g
    return op2, mb2, gr2


@dataclasses.dataclass(frozen=True)
class PhaseSegment:
    """One compiled phase: cycles ``[t0, t1)`` of the aligned table.

    ``kind == 'unroll'``: ramp cycles, lowered to straight-line code (each
    cycle's single op code is a trace-time constant; devices idle at a
    cycle are masked by data selects into sentinel slots). ``kind ==
    'scan'``: a dense periodic steady-state window — ``(t1 - t0) //
    period`` iterations of the fixed ``codes`` body, every device busy
    every cycle."""
    kind: str
    t0: int
    t1: int
    period: int = 0
    codes: Tuple[int, ...] = ()

    @property
    def cycles(self) -> int:
        return self.t1 - self.t0

    @property
    def iters(self) -> int:
        return (self.t1 - self.t0) // self.period if self.period else 0


@dataclasses.dataclass(frozen=True)
class PhaseProgram:
    """Accepted phase compilation: aligned tables + segmentation."""
    op: np.ndarray
    mbi: np.ndarray
    grp: np.ndarray
    segments: Tuple[PhaseSegment, ...]
    policy: str                    # which klass/priority candidate won
    cycle_codes: Tuple[int, ...]   # per-cycle uniform op code (IDLE ok)
    dense: Tuple[bool, ...]        # per-cycle: True = no device idles

    @property
    def cycles(self) -> int:
        return int(self.op.shape[0])

    @property
    def unrolled_cycles(self) -> int:
        return sum(s.cycles for s in self.segments if s.kind == "unroll")

    @property
    def scan_cycles(self) -> int:
        return sum(s.cycles for s in self.segments if s.kind == "scan")


@dataclasses.dataclass(frozen=True)
class PhaseVerdict:
    """Accept/reject result of :func:`compile_phases`. Rejected tables run
    on the interpreted executor (the caller falls back loudly)."""
    accepted: bool
    reason: str
    program: Optional[PhaseProgram] = None


def _phase_cycle_summary(op, d):
    """Per-cycle ``(code, dense)``: the single non-idle op code (None when
    codes are mixed — not phase-compilable) and whether no device idles."""
    out = []
    for t in range(op.shape[0]):
        codes = {int(op[t, p]) for p in range(d)}
        nonidle = codes - {IDLE}
        if len(nonidle) > 1:
            out.append((None, False))
        elif not nonidle:
            out.append((IDLE, False))
        else:
            out.append((nonidle.pop(), IDLE not in codes))
    return out


def segment_phases(op, d, *, min_reps: int = 2,
                   max_period: int = 6) -> Optional[Tuple[PhaseSegment, ...]]:
    """Segment an aligned table into unroll ramps and dense periodic scan
    windows. Returns None when any cycle mixes op codes across devices
    (no single shard_map trace can specialize it without dispatch)."""
    summary = _phase_cycle_summary(op, d)
    if any(c is None for c, _ in summary):
        return None
    T = len(summary)
    segments: List[PhaseSegment] = []
    t = 0
    pend_unroll = 0
    while t < T:
        if not summary[t][1]:
            pend_unroll += 1
            t += 1
            continue
        t1 = t
        while t1 < T and summary[t1][1]:
            t1 += 1
        codes = [summary[k][0] for k in range(t, t1)]
        best = None
        for P in range(1, min(max_period, len(codes)) + 1):
            if len(codes) // P < min_reps:
                break
            if all(codes[k] == codes[k % P] for k in range(len(codes))):
                best = P
                break
        if best is None:
            pend_unroll += t1 - t
            t = t1
            continue
        n_iters = len(codes) // best
        t_scan_end = t + n_iters * best
        if pend_unroll:
            segments.append(PhaseSegment("unroll", t - pend_unroll, t))
            pend_unroll = 0
        segments.append(PhaseSegment("scan", t, t_scan_end, period=best,
                                     codes=tuple(codes[:best])))
        pend_unroll = t1 - t_scan_end
        t = t1
    if pend_unroll:
        segments.append(PhaseSegment("unroll", T - pend_unroll, T))
    return tuple(segments)


def _per_code_stage_order(op, mbi, grp, d):
    """Per (virtual stage, code) micro-batch order — the accumulation
    orders that must survive alignment for bitwise parity."""
    order: dict = {}
    for t in range(op.shape[0]):
        for p in range(op.shape[1]):
            c = int(op[t, p])
            if c == IDLE:
                continue
            g = int(grp[t, p]) if grp is not None else 0
            order.setdefault((g * d + p, c), []).append(int(mbi[t, p]))
    return order


def compile_phases(op, mbi, grp=None, *, m: int, d: int, v: int = 1,
                   hop: int = 2, max_unroll: Optional[int] = None,
                   max_period: int = 6) -> PhaseVerdict:
    """Phase-compile a SERIALIZED op table (the universal schedule
    currency, see :func:`verify_op_tables`): try the alignment policies,
    verify each result against the overlapped-transport invariants
    (:func:`verify_shifted_op_tables` — the ``comm_shift`` contract) and
    the per-code order-preservation guarantee, segment it, and return the
    best accepted :class:`PhaseVerdict`.

    Acceptance requires the unrolled ramps to stay short (``max_unroll``,
    default ``8·d·v + 4·hop + 8`` — O(stages), so trace size does not grow
    with m) — a table with no usable steady window on a large m rejects
    rather than unrolling unboundedly. ``d == 1`` rejects (the static
    unroll path already specializes single-device tables at trace time)."""
    if d <= 1:
        return PhaseVerdict(False, "d == 1: no transport to phase "
                            "(static unroll already specializes)")
    if max_unroll is None:
        max_unroll = 8 * d * v + 4 * hop + 8
    splits = bool((np.asarray(op) == WGRAD).any())
    candidates = []
    if splits:
        candidates.append(("fbw3", PHASE_KLASS_FBW, (BWD, WGRAD, FWD)))
        candidates.append(("none", None, (BWD, WGRAD, FWD)))
    else:
        candidates.append(("fb2", PHASE_KLASS_FB, (BWD, WGRAD, FWD)))
        candidates.append(("none-ffirst", None, (FWD, BWD, WGRAD)))
        candidates.append(("none", None, (BWD, WGRAD, FWD)))
    want_order = _per_code_stage_order(op, mbi, grp, d)
    best = None
    reasons = []
    for name, klass, prio in candidates:
        try:
            op2, mb2, gr2 = align_phase_tables(
                op, mbi, grp, m=m, d=d, v=v, hop=hop, klass=klass,
                priority=prio)
            verify_shifted_op_tables(
                op2, mb2, gr2 if (grp is not None or v > 1) else None,
                m=m, d=d, v=v, hop=hop, splits_backward=splits)
            got_order = _per_code_stage_order(op2, mb2, gr2, d)
            if got_order != want_order:
                raise AssertionError("per-code stage order changed")
        except AssertionError as e:
            reasons.append(f"{name}: {e}")
            continue
        segments = segment_phases(op2, d, max_period=max_period)
        if segments is None:
            reasons.append(f"{name}: mixed-code cycles survive alignment")
            continue
        prog = PhaseProgram(
            op2, mb2, gr2, segments, name,
            tuple(c for c, _ in _phase_cycle_summary(op2, d)),
            tuple(dn for _, dn in _phase_cycle_summary(op2, d)))
        if prog.unrolled_cycles > max_unroll:
            reasons.append(
                f"{name}: {prog.unrolled_cycles} unrolled cycles exceed "
                f"the {max_unroll}-cycle ramp budget")
            continue
        score = (prog.scan_cycles / max(prog.cycles, 1), -prog.cycles)
        if best is None or score > best[0]:
            best = (score, prog)
    if best is None:
        return PhaseVerdict(False, "; ".join(reasons) or "no candidates")
    return PhaseVerdict(True, f"policy {best[1].policy}", best[1])


_SCHEDULES = {
    "gpipe": GPipeSchedule,
    "1f1b": OneFOneBSchedule,
    "interleaved": InterleavedSchedule,
    "interleaved-1f1b": InterleavedOneFOneBSchedule,
    "zb-h1": ZeroBubbleSchedule,
    "zb-h2": ZeroBubbleDeepSchedule,
}


def get_schedule(name: str, **kwargs) -> Schedule:
    if name not in _SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; options: {sorted(_SCHEDULES)}")
    return _SCHEDULES[name](**kwargs)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A verified degraded-topology plan produced by
    :func:`replan_stage_loss`: the survivor stage count, the re-cut
    layer balance (None when the caller gave no balance to re-cut),
    freshly emitted + verified op tables for the new width, and the
    phase-compiler verdict (advisory — a table that phase-rejects still
    executes on the generic path)."""

    n_stages: int
    balance: Optional[Tuple[int, ...]]
    op: np.ndarray
    mbi: np.ndarray
    phase: "PhaseVerdict"


def replan_stage_loss(m: int, n_stages: int, lost_stage: int, *,
                      schedule: str = "1f1b",
                      balance: Optional[List[int]] = None,
                      costs: Optional[List[float]] = None,
                      hop: int = 2) -> ElasticPlan:
    """Re-plan a pipeline after losing one stage: emit, verify, and
    phase-compile the op table for the surviving ``n_stages - 1`` width.

    This is the schedules-as-data payoff the elastic controller rides:
    the schedule family regenerates its table for ANY stage count, so
    recovery is a fresh emission plus the same proofs every table must
    pass (:func:`verify_op_tables` with the schedule's own stash/wstash
    capacities) — not a hand-patched topology. ``balance``/``costs``
    re-cut the layer assignment via
    :func:`~pipe_tpu_torch.core.balance.rebalance_stage_loss`. Raises
    ``ValueError`` when no survivor topology exists (n_stages < 2, a
    lost stage out of range, or an interleaved schedule — re-plan those
    as their v=1 base family first).
    """
    if n_stages < 2:
        raise ValueError(
            f"cannot re-plan stage loss with n_stages={n_stages}: "
            f"no survivor topology exists")
    if not 0 <= lost_stage < n_stages:
        raise ValueError(
            f"lost_stage={lost_stage} out of range for {n_stages} stages")
    sched = get_schedule(schedule)
    if sched.v != 1:
        raise ValueError(
            f"schedule {schedule!r} interleaves v={sched.v} virtual "
            f"stages; re-plan via its v=1 base family")
    n_new = n_stages - 1
    op, mbi = sched.op_tables(m, n_new)
    verify_op_tables(op, mbi, m, n_new,
                     stash_slots=sched.stash_slots(m, n_new),
                     wstash_slots=(sched.wstash_slots(m, n_new)
                                   if sched.splits_backward else None))
    new_balance = None
    if balance is not None:
        from .balance import rebalance_stage_loss
        new_balance = tuple(rebalance_stage_loss(balance, costs))
    phase = compile_phases(op, mbi, m=m, d=n_new, hop=hop)
    return ElasticPlan(n_stages=n_new, balance=new_balance,
                       op=op, mbi=mbi, phase=phase)
