"""Schedule-table executor on one device: forward, backward and loss of a
training step, walked op by op from a schedule's static tables.

Counterpart of ``pipe_tpu/parallel/scheduled.py``'s ``ScheduledPipeline``
with the mesh's stage axis replaced by ``n_stages`` stages on one device.
It is a table walk, not a translation of the ``shard_map``/``lax.scan``
machinery; the JAX one-device static program (``_device_program_static``)
reads closest to it. For each cycle ``t`` of ``schedule.op_tables(m, d)``
and each stage ``p`` in order (virtual stage ``g·d + p`` of an interleaved
table), the op runs:

* **FWD**: stage 0 runs ``pre_fn`` first. A micro-batch the checkpoint mode
  saves (all under ``never``, micro-batch m-1 under ``except_last``, none
  under ``always``) keeps its autograd graph until its B (and W); the others
  run under ``torch.no_grad()`` and keep only their stashed input. The last
  stage parks its output (detached) and adds ``sum(w · post_fn(...))`` to
  the loss without a graph: the post's vocab-scale residuals are never kept
  from F to B. A stage's output reaches the next stage's stash at the end of
  the cycle, in slot ``i % stash_slots``, as the value sent at cycle ``t``
  is consumable at ``t + 1`` in JAX; a slot still in use raises.
* **BWD**: a recompute micro-batch re-runs its stage from the stash with the
  same seeds, so its dropout masks replay bit for bit. The last stage first
  rebuilds the post's graph from the parked output and seeds it with
  ``1 / sum(w)``. The stage-input cotangent goes to stage ``s - 1``;
  parameter gradients accumulate into ``.grad``.
* **WGRAD** (split tables, ``zb-h1``): under ``checkpoint="never"`` B takes
  only the input cotangent from the retained graph (``retain_graph=True``)
  and parks its seed in slot ``i % wstash_slots``; W takes the parameter
  gradients from the same graph and seed (JAX's stored-vjp ``split_dce``
  path). In recompute modes the whole backward runs at B and W is idle.
* **IDLE** does nothing.

Dropout seeds fold as JAX folds its keys: ``(seed, i, s)``, then 0 for the
pre, 1 for the stage and 2 for the post, so one seed gives the same masks
under every schedule and checkpoint mode.

The skip lanes and stat lanes (ROADMAP A.2), the structural split, context
parallelism, tensor-parallel specs, overlapped transport and phase
compilation (A.8), and ``remat_policy`` are not ported: their fields raise
``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.memplan import MemoryPlanInputs, activation_slot_plan
from ..core.partition import StageCtx, fold_seed
from ..core.remat import validate_mode
from ..core.schedule import BWD, FWD, IDLE, WGRAD, get_schedule
from ..obs.telemetry import get_registry
from ..utils.platform import DEFAULT_DEVICE, resolve_device

__all__ = ["ScheduledPipeline"]

# (field, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("skip_lanes", "A.2, skip lanes of the table executor"),
    ("stat_spec", "A.2, stat lanes of the table executor"),
    ("split_stage", "A.8, the structural B/W split"),
    ("context_axis", "A.8, context parallelism"),
    ("stage_param_specs", "A.8, tensor-parallel stage params"),
    ("overlap_transport", "A.8, overlapped transport"),
    ("phase_compile", "A.8, the phase-compiled executor"),
    ("remat_policy", "A.11, remat_policy of the table executor"),
)


@dataclasses.dataclass
class _Entry:
    """A stash slot: the stage input (None on stage 0, whose input is the
    micro-batch itself) and, for a saved micro-batch, the stage output with
    its graph."""

    h_in: Optional[torch.Tensor]
    out: Optional[torch.Tensor] = None


class _Ring:
    """``slots`` entries per virtual stage, indexed ``i % slots``; writing a
    slot in use raises rather than clobbering it."""

    def __init__(self, n_virtual: int, slots: int, what: str):
        self.slots = slots
        self.what = what
        self.live = [[None] * max(slots, 1) for _ in range(n_virtual)]
        self.peak = 0

    def put(self, s: int, i: int, value) -> None:
        row = self.live[s]
        k = i % self.slots
        if row[k] is not None:
            raise RuntimeError(
                f"{self.what} slot clobber: micro-batch {i} arrives at stage "
                f"{s} while slot {k} of {self.slots} is still in use")
        row[k] = (i, value)
        self.peak = max(self.peak, sum(e is not None for e in row))

    def get(self, s: int, i: int, pop: bool = False):
        row = self.live[s]
        k = i % self.slots
        if row[k] is None or row[k][0] != i:
            raise RuntimeError(
                f"{self.what}: nothing for micro-batch {i} at stage {s} "
                f"(slot {k} of {self.slots}); the op table is out of order")
        value = row[k][1]
        if pop:
            row[k] = None
        return value


@dataclasses.dataclass
class _Step:
    """What one :meth:`ScheduledPipeline.loss_and_grad` walk carries from op
    to op: the rings, the cotangents in flight (``gbuf``, keyed ``(i, s)``),
    this cycle's stage outputs on their way to the next stash, and the
    loss."""

    m: int
    seed: Optional[int]
    split: bool
    inv_wsum: torch.Tensor
    stash: _Ring
    h_last: _Ring
    wstash: _Ring
    params: List[torch.Tensor]
    loss: torch.Tensor
    gbuf: Dict[Tuple[int, int], torch.Tensor] = dataclasses.field(
        default_factory=dict)
    arrivals: List[Tuple[int, int, torch.Tensor]] = dataclasses.field(
        default_factory=list)


def _index(x, i: int):
    if isinstance(x, dict):
        return {k: v[i] for k, v in x.items()}
    return x[i]


def _leading(x) -> int:
    leaf = next(iter(x.values())) if isinstance(x, dict) else x
    if not isinstance(leaf, torch.Tensor):
        raise TypeError("x must be a tensor or a dict of tensors")
    return int(leaf.shape[0])


def _to(x, device):
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return x.to(device)


@dataclasses.dataclass
class ScheduledPipeline:
    """Training executor: :meth:`loss_and_grad` through a schedule's op
    tables, ``n_stages`` stages on one device.

    Args:
      stage_fn: ``(s, h, ctx) -> h``, the body of virtual stage ``s``
        (activation shapes equal at every boundary).
      pre_fn: ``(x_mb, ctx) -> h``, run on virtual stage 0.
      post_fn: ``(h, x_mb, ctx) -> [rows]``, the per-row loss on the last
        virtual stage (``PipelinedLM.loss_post_fn``).
      n_stages: the stage count ``d`` (the mesh's stage axis in
        ``pipe_tpu``); an interleaved table runs ``v·d`` virtual stages.
      module: holds every parameter the three functions use; the gradients
        come back under its parameter names.
      checkpoint: ``always | except_last | never``, the exact
        per-micro-batch policy.
      schedule: a registered name or a ``Schedule`` with ``op_tables``.
      device: where the step runs (the card unless ``"cpu"`` is asked for).
    """

    stage_fn: Callable
    pre_fn: Callable
    post_fn: Callable
    n_stages: int
    module: nn.Module
    checkpoint: str = "except_last"
    schedule: Any = "1f1b"
    device: Any = DEFAULT_DEVICE
    context_axis: Optional[str] = None
    stage_param_specs: Optional[Any] = None
    split_stage: Optional[Any] = None
    remat_policy: Optional[Any] = None
    skip_lanes: Optional[Any] = None
    stat_spec: Optional[Any] = None
    overlap_transport: Optional[bool] = None
    phase_compile: Optional[bool] = None

    def __post_init__(self):
        validate_mode(self.checkpoint)
        for name, item in _NOT_PORTED:
            value = getattr(self, name)
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"ScheduledPipeline.{name}={value!r} is not ported to "
                    f"pipe_tpu_torch yet (ROADMAP.md: {item})")
        if not isinstance(self.n_stages, int) or self.n_stages < 1:
            raise ValueError(f"n_stages must be a positive integer, got "
                             f"{self.n_stages!r}")
        if isinstance(self.schedule, str):
            self.schedule = get_schedule(self.schedule)
        if not hasattr(self.schedule, "op_tables"):
            raise ValueError(f"schedule {self.schedule!r} has no op_tables")
        if (getattr(self.schedule, "splits_backward", False)
                and self.checkpoint != "never"):
            warnings.warn(
                f"schedule {self.schedule.name!r} splits backward into B/W "
                f"ops to fill bubble slots with weight-grad compute, but "
                f"checkpoint={self.checkpoint!r} recomputes the forward at "
                f"B and the full backward runs there — the W slots carry no "
                f"compute and the zero-bubble advantage is lost. Pair "
                f"zero-bubble schedules with checkpoint='never'.",
                stacklevel=2)
        self.device = resolve_device(self.device)
        self.v = self.schedule.v
        self.n_virtual = self.v * self.n_stages
        self.last_slots: Dict[str, int] = {}

    # --- tables ---

    def _tables(self, m: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        tables = self.schedule.op_tables(m, self.n_stages)
        op, mbi = tables[0], tables[1]
        grp = tables[2] if len(tables) > 2 else np.zeros_like(op)
        return op, mbi, grp

    def memory_plan(self, m: int) -> dict:
        """Per-stage buffer counts of the walk: ``activation_slot_plan``
        over its slot counts, with the cycle count and the (serialized)
        transport, as ``pipe_tpu``'s ``memory_plan`` reports them."""
        d = self.n_stages
        return {"cycles": int(self._tables(m)[0].shape[0]),
                **activation_slot_plan(MemoryPlanInputs(
                    v=self.v, stash_slots=self.schedule.stash_slots(m, d),
                    wstash_slots=self.schedule.wstash_slots(m, d),
                    checkpoint=self.checkpoint)),
                "transport": "serialized"}

    def stage_passes(self, m: int) -> Dict[str, int]:
        """Stage-body passes one :meth:`loss_and_grad` runs, read from the
        tables: ``forward`` counts every FWD and every recompute at B;
        ``backward`` every walk of a stage's backward graph — one per BWD,
        and under the ``never`` split one per W plus one per B off stage 0
        (stage 0's B has no input cotangent to take: its input is the
        micro-batch). A layer with a kernel in its forward and backward
        launches it this many times per stage it sits in."""
        op, mbi, grp = self._tables(m)
        split = bool((op == WGRAD).any()) and self.checkpoint == "never"
        n_fwd, n_bwd = int((op == FWD).sum()), int((op == BWD).sum())
        if split:
            b_stage0 = int(((op[:, 0] == BWD) & (grp[:, 0] == 0)).sum())
            return {"forward": n_fwd,
                    "backward": n_bwd - b_stage0 + int((op == WGRAD).sum())}
        recompute = sum(not self._keeps_graph(int(i), m)
                        for i in mbi[op == BWD])
        return {"forward": n_fwd + recompute, "backward": n_bwd}

    def _keeps_graph(self, i: int, m: int) -> bool:
        """The exact per-micro-batch policy: ``never`` keeps every
        micro-batch's graph from F to B, ``except_last`` only m-1's,
        ``always`` none (they recompute at B)."""
        return (self.checkpoint == "never"
                or (self.checkpoint == "except_last" and i == m - 1))

    # --- the ops ---

    def _seeds(self, seed: Optional[int], i: int, s: int):
        """ctx seeds of (pre, stage, post) for micro-batch ``i`` at virtual
        stage ``s``: JAX's ``fold_in(fold_in(key, i), s)`` then 0, 1, 2."""
        if seed is None:
            return None, None, None
        kis = fold_seed(fold_seed(seed, i), s)
        return tuple(fold_seed(kis, k) for k in range(3))

    def _stage(self, s: int, h_in, x_mb, seeds, train: bool, i: int):
        """Pre (stage 0) then stage ``s``; returns the stage output."""
        if s == 0:
            h_in = self.pre_fn(x_mb, StageCtx(seed=seeds[0], train=train,
                                              microbatch=i))
        return self.stage_fn(s, h_in, StageCtx(seed=seeds[1], train=train,
                                                microbatch=i, stage=s))

    def _post(self, h, x_mb, w_mb, seeds, i: int) -> torch.Tensor:
        """The unnormalized loss contribution ``sum(w · per_row)``."""
        per_row = self.post_fn(h, x_mb, StageCtx(
            seed=seeds[2], train=True, microbatch=i, stage=self.n_virtual - 1))
        return (w_mb * per_row).sum().float()

    # --- the step ---

    def _fwd_op(self, st: _Step, i: int, s: int, x_mb, w_mb) -> None:
        seeds = self._seeds(st.seed, i, s)
        if s == 0:
            st.stash.put(0, i, _Entry(None))
        entry = st.stash.get(s, i)
        save = self._keeps_graph(i, st.m)
        with torch.set_grad_enabled(save):
            if save and s > 0:
                entry.h_in.requires_grad_(True)
            out = self._stage(s, entry.h_in, x_mb, seeds, True, i)
        if save:
            entry.out = out
        if s < self.n_virtual - 1:
            st.arrivals.append((s + 1, i, out.detach()))
            return
        with torch.no_grad(), torch.profiler.record_function(
                f"table:post-F{i}"):
            st.loss = st.loss + self._post(out.detach(), x_mb, w_mb, seeds, i)
        st.h_last.put(0, i, out.detach())

    def _bwd_op(self, st: _Step, i: int, s: int, x_mb, w_mb) -> None:
        seeds = self._seeds(st.seed, i, s)
        entry = st.stash.get(s, i, pop=not st.split)
        if s == self.n_virtual - 1:
            # the post's graph, rebuilt from the parked output
            with torch.profiler.record_function(f"table:post-B{i}"):
                hl = st.h_last.get(0, i, pop=True).requires_grad_(True)
                with torch.enable_grad():
                    c = self._post(hl, x_mb, w_mb, seeds, i)
                c.backward(st.inv_wsum)
            seed_h = hl.grad
        else:
            seed_h = st.gbuf.pop((i, s))
        out = entry.out
        if out is None:                                 # recompute
            with torch.enable_grad():
                if s > 0:
                    entry.h_in.requires_grad_(True)
                out = self._stage(s, entry.h_in, x_mb, seeds, True, i)
        if st.split:
            if s > 0:
                st.gbuf[(i, s - 1)], = torch.autograd.grad(
                    out, entry.h_in, seed_h, retain_graph=True)
            st.wstash.put(s, i, seed_h)
        else:
            out.backward(seed_h)
            if s > 0:
                st.gbuf[(i, s - 1)] = entry.h_in.grad

    def _w_op(self, st: _Step, i: int, s: int, x_mb, w_mb) -> None:
        entry = st.stash.get(s, i, pop=True)
        torch.autograd.backward(entry.out, st.wstash.get(s, i, pop=True),
                                inputs=st.params)

    def loss_and_grad(self, x, w, *, seed: Optional[int] = 0):
        """One step through the tables: returns ``(loss, grads)``.

        ``x``: a tensor or a dict of tensors ``[m, rows, ...]``
        (micro-batched, e.g. by ``core.microbatch.stack_scatter``); ``w``:
        ``[m, rows]`` row weights, 0 for padding rows. The loss is
        ``sum(w · per_row) / sum(w)``. Parameter gradients accumulate into
        ``.grad`` as ``backward()`` does (zero them first), and ``grads`` is
        ``{name: grad}`` over ``module``'s parameters. ``seed`` drives
        dropout (None: none)."""
        m = _leading(x)
        x = _to(x, self.device)
        w = w.to(self.device, torch.float32)
        if tuple(w.shape[:1]) != (m,):
            raise ValueError(f"w must be [m={m}, rows], got {tuple(w.shape)}")
        op, mbi, grp = self._tables(m)
        d, S = self.n_stages, self.n_virtual
        get_registry().gauge("scheduled.cycles").set(int(op.shape[0]))
        split = bool((op == WGRAD).any()) and self.checkpoint == "never"
        Sg = self.schedule.stash_slots(m, d)
        st = _Step(
            m=m, seed=seed, split=split, inv_wsum=1.0 / w.sum(),
            stash=_Ring(S, Sg, "stash"), h_last=_Ring(1, Sg, "h_last"),
            wstash=_Ring(S, self.schedule.wstash_slots(m, d) if split else 1,
                         "wstash"),
            params=[p for p in self.module.parameters() if p.requires_grad],
            loss=torch.zeros((), device=self.device))
        run = {FWD: self._fwd_op, BWD: self._bwd_op, WGRAD: self._w_op}
        for t in range(op.shape[0]):
            for p in range(d):
                code = int(op[t, p])
                if code == IDLE or (code == WGRAD and not split):
                    continue
                i, s = int(mbi[t, p]), int(grp[t, p]) * d + p
                with torch.profiler.record_function(
                        f"table:{'FBW'[code - 1]}{i}-stage{s}"):
                    run[code](st, i, s, _index(x, i), w[i])
            for s, i, h in st.arrivals:
                st.stash.put(s, i, _Entry(h))
            st.arrivals.clear()
        if st.gbuf or any(e is not None for row in st.stash.live for e in row):
            raise RuntimeError(
                f"schedule {self.schedule.name!r} left state unconsumed at "
                f"m={m}: its table misses a BWD or WGRAD op")
        self.last_slots = {"stash": st.stash.peak, "h_last": st.h_last.peak,
                           "wstash": st.wstash.peak if split else 0}
        grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for name, p in self.module.named_parameters()}
        return (st.loss * st.inv_wsum).detach(), grads

    def forward(self, x, *, seed: Optional[int] = 0,
                train: bool = False) -> torch.Tensor:
        """The tables' FWD ops only (BWD and WGRAD masked to IDLE): the last
        virtual stage's outputs ``[m, rows, ...]``, no post applied. Runs
        under the caller's grad mode."""
        m = _leading(x)
        x = _to(x, self.device)
        op, mbi, grp = self._tables(m)
        d, S = self.n_stages, self.n_virtual
        stash = _Ring(S, self.schedule.stash_slots(m, d), "stash")
        outs: List[Optional[torch.Tensor]] = [None] * m
        for t in range(op.shape[0]):
            arrivals = []
            for p in range(d):
                if int(op[t, p]) != FWD:
                    continue
                i, s = int(mbi[t, p]), int(grp[t, p]) * d + p
                h_in = stash.get(s, i, pop=True) if s > 0 else None
                out = self._stage(s, h_in, _index(x, i),
                                  self._seeds(seed, i, s), train, i)
                if s == S - 1:
                    outs[i] = out
                else:
                    arrivals.append((s + 1, i, out))
            for s, i, h in arrivals:
                stash.put(s, i, h)
        return torch.stack(outs)
