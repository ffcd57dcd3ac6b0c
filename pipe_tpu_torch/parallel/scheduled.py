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
  from F to B. Under a ``remat_policy`` (modes other than ``never``) a
  recompute micro-batch runs its F under the policy's selective
  ``torch.utils.checkpoint`` and keeps that graph until its B: only what
  the policy saves (the matrix products' outputs under ``dots_saveable``)
  is stored, and the backward re-runs the rest of the stage in place. A
  stage's output reaches the next stage's stash at the end of the cycle,
  in slot ``i % stash_slots``, as the value sent at cycle ``t`` is
  consumable at ``t + 1`` in JAX; a slot still in use raises.
* **BWD**: a recompute micro-batch re-runs its stage from the stash with the
  same seeds, so its dropout masks replay bit for bit (under a policy the
  checkpoint's own recompute does it, with the same seeds). The last stage
  first rebuilds the post's graph from the parked output and seeds it with
  ``1 / sum(w)``. The stage-input cotangent goes to stage ``s - 1``;
  parameter gradients accumulate into ``.grad``.
* **WGRAD** (split tables, ``zb-h1``): under ``checkpoint="never"``, with
  ``split_stage`` set (:class:`SplitBackwardStage`, or ``"auto"``:
  ``core.remat.split_backward_stage``), the structural split: FWD runs the
  tapped body (weights enter its products detached), B takes the input
  cotangent and the cotangents at the products' outputs in one
  ``torch.autograd.grad`` and parks them in slot ``i % wstash_slots``, and
  W turns them and the taps into weight gradients, with nothing but the
  weight-gradient products (JAX's ``SplitBackwardStage`` path). Stage 0's B
  runs too (W needs its cotangents), and the pre's and post's parameters
  get their gradients at B. Without ``split_stage`` the stored-graph split:
  B takes only the input cotangent from the retained graph
  (``retain_graph=True``) and parks its seed; W takes the parameter
  gradients from the same graph and seed, walking the data-side backward
  again (JAX's stored-vjp path). In recompute modes the whole backward runs
  at B and W is idle.
* **IDLE** does nothing.

**Skip lanes** (:class:`SkipLanes`, the cross-stage ``@skippable`` carries):
the stage contract becomes ``stage_fn(s, h, ctx, pops) -> (h, stashes)``,
tuples over lanes. At FWD(i, src) the lane's stash value, detached, enters a
per-lane FIFO park at the end of the cycle, in slot ``i % Kf``; FWD(i, dst)
reads it, as a leaf that requires grad when the micro-batch keeps its graph.
A recompute micro-batch re-reads the slot at BWD(i, dst), so the slot lives
until then (JAX's ``reread`` window), unless a ``remat_policy`` is set: the
pops then ride the checkpointed F and the slot is free after FWD(i, dst).
BWD(i, dst) parks the pop's gradient in a reverse park of depth ``Kg``;
BWD(i, src) then runs the backward of the stage output and the stash output
together, seeded with the cotangent and that gradient: the reference's
``PortalOrange``/``PortalBlue`` pair. ``Kf``
and ``Kg`` are the smallest FIFO depths with no live-window collision
(:meth:`ScheduledPipeline._skip_tables`, JAX's host-side plan); a park slot
still in use raises. **Stat lanes** (``stat_spec``, deferred BatchNorm):
the stage appends a stats output, ``(h, stats)`` or ``(h, stashes,
stats)``; stats add up over the FWD ops only (a recompute's are dropped) and
:meth:`ScheduledPipeline.loss_and_grad` returns ``(loss, grads, stats)``.
A boundary ``h`` may be a tuple of tensors (a ``Pipe`` partition handing on
several values); the rings detach it leaf by leaf.

Dropout seeds fold as JAX folds its keys: ``(seed, i, s)``, then 0 for the
pre, 1 for the stage and 2 for the post, so one seed gives the same masks
under every schedule and checkpoint mode.

**Over a mesh** (``mesh=``, a :class:`~pipe_tpu_torch.parallel.mesh.Mesh`
of ``n_stages`` x ``n_data`` ranks) each rank walks only its own column
``p`` of the tables (its ``v`` groups under interleaving) and holds only the
parameters of its stages; the others may sit on the ``meta`` device. What
the one-device walk writes at the end of a cycle into another stage's rings
(a stage output into the next stage's stash, a cotangent for the stage
before, a lane value into its forward park, a pop gradient into its reverse
park) goes to the rank that owns that stage instead, as one packed message
per peer per cycle (``parallel/buffers.py``, its layout in the message's
first words), with ``dist.batch_isend_irecv`` (``Mesh.exchange``): both ends
read who sends what at cycle ``t`` from the same tables. ``x`` and ``w`` are
the global batch, as JAX's executor takes them: each data rank runs rows
``data * r / n_data ..`` of every micro-batch (``StageCtx.rows``; dropout
masks are the one-device step's, ROADMAP.md C.16) and its data group is the
``StageCtx.data_axis`` of batch statistics. ``sum(w)`` is taken once on the
host, as JAX hoists it. After the walk the parameter gradients are summed
over the data group (one flat buffer per dtype), the loss over the world
and the stats over the data group, as JAX's psums over ``DATA_AXIS`` do.

Context parallelism, tensor-parallel specs, overlapped transport and phase
compilation (A.8) are not ported: their fields raise ``NotImplementedError``
when set.
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
from ..core.remat import apply_remat, resolve_policy, validate_mode
from ..core.schedule import BWD, FWD, IDLE, WGRAD, get_schedule
from ..obs.telemetry import get_registry
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .buffers import pack_words, unpack_words

__all__ = ["ScheduledPipeline", "SkipLanes", "SplitBackwardStage"]

# (field, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("context_axis", "A.8, context parallelism"),
    ("stage_param_specs", "A.8, tensor-parallel stage params"),
    ("overlap_transport", "A.8, overlapped transport"),
    ("phase_compile", "A.8, the phase-compiled executor"),
)


@dataclasses.dataclass(frozen=True)
class SkipLanes:
    """Cross-stage ``@skippable`` carries through the table executor.

    ``pairs[l] = (src, dst)``: virtual stage indices, ``src < dst``.
    ``specs[l]``: the lane's value (a tensor, or anything with a ``dtype``)
    as a description; the executor reads only its dtype, to refuse integer
    lanes, and may be given ``()`` (the one-device executor learns shapes
    from the values). With lanes the stage contract is
    ``stage_fn(s, h, ctx, pops) -> (h, stashes)``: ``pops`` holds the value
    of each lane that ends at ``s`` (None at the others), and a stage returns
    a value for each lane it stashes (the others' entries are ignored: JAX's
    zeros or None). Counterpart of ``pipe_tpu``'s ``SkipLanes``; its direct
    ``ppermute`` hop is here the end-of-cycle write into the park.
    """

    pairs: tuple
    specs: tuple


@dataclasses.dataclass(frozen=True)
class SplitBackwardStage:
    """Structural B/W split of a stage body (zero-bubble's real contract):
    B takes input cotangents only, W weight gradients only. Counterpart of
    ``pipe_tpu``'s ``SplitBackwardStage``, in torch's idiom.

    * ``tapped_fn(s, h, ctx) -> (h_out, ys, taps)``: stage ``s``'s forward
      with every parameter entering its weight products detached, so the
      graph from ``h`` to ``h_out`` holds no weight path; ``ys`` are those
      products' outputs (float tensors in that graph), ``taps`` whatever W
      needs (the products' data inputs);
    * B (the executor): ``torch.autograd.grad`` of ``h_out`` at ``h`` and
      ``ys``, which gives the input cotangent and ``g_ys``, the cotangents at
      the products' outputs (None where none reached);
    * ``wgrad_fn(s, taps, g_ys) -> [(tensor, gradient)]``: the W op, nothing
      but the weight-gradient products; the executor accumulates each
      gradient into the parameters behind its tensor (a parameter, or a
      value computed from parameters with its graph) by autograd.

    Pair with ``checkpoint='never'`` and a ``splits_backward`` schedule
    (zb-h1); the executor refuses other combinations. The taps ride the
    stash slots (FWD to W) and ``g_ys`` the W park, both activation-sized.
    ``split_stage="auto"`` derives one from any stage body
    (``core.remat.split_backward_stage``).
    """

    tapped_fn: Callable
    wgrad_fn: Callable


def _leaves(h) -> tuple:
    return tuple(h) if isinstance(h, (tuple, list)) else (h,)


def _like(h, leaves):
    return tuple(leaves) if isinstance(h, (tuple, list)) else leaves[0]


def _differentiable(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point()
                                            or t.is_complex())


def _detached(h):
    """``h`` (a tensor or a tuple of values) with each tensor detached."""
    return _like(h, [t.detach() if isinstance(t, torch.Tensor) else t
                     for t in _leaves(h)])


def _require_grad(h):
    """Make each float leaf of ``h`` (detached leaves) require grad."""
    for t in _leaves(h):
        if _differentiable(t):
            t.requires_grad_(True)
    return h


def _or_zeros(g, t):
    return g if g is not None else torch.zeros_like(t)


def _grads_of(h):
    """The ``.grad`` of each float leaf of ``h`` (zeros where unused)."""
    return _like(h, [_or_zeros(t.grad, t) if _differentiable(t) else None
                     for t in _leaves(h)])


def _backward(outs, seeds, inputs=None) -> None:
    """``torch.autograd.backward`` over the (output, seed) pairs whose output
    is part of a graph and whose seed is given."""
    pairs = [(o, g) for o, g in zip(outs, seeds)
             if g is not None and isinstance(o, torch.Tensor)
             and o.requires_grad]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs],
                                inputs=inputs)


def _tree_add(a, b):
    """Add two stats trees; dicts merge by key (a stage reports only its own
    entries)."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, dict):
        return {**a, **b, **{k: _tree_add(a[k], b[k]) for k in a if k in b}}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def _check_lane_dtype(dtype) -> None:
    if not (dtype.is_floating_point or dtype.is_complex):
        raise NotImplementedError(
            f"skip lane values must be float (got "
            f"{str(dtype).removeprefix('torch.')}): integer lanes "
            "would need the float0 cotangent plumbing the h carrier has "
            "(_ring_to_seed/_vjp_to_ring) on the reverse skip ring too")


@dataclasses.dataclass
class _Entry:
    """A stash slot: the stage input (None on stage 0, whose input is the
    micro-batch itself) and, for a saved micro-batch, the stage output and
    stash outputs with their graph and the pops fed in as leaves. Under the
    structural split, the gradient edges of the tapped products' outputs
    (``edges``, for B) and their taps (for W); ``h_in`` is then the pre's
    output on stage 0."""

    h_in: Any
    out: Any = None
    stashes: Optional[tuple] = None
    pops: Optional[tuple] = None
    edges: Optional[list] = None
    taps: Any = None


class _Ring:
    """``slots`` entries per row (a virtual stage, or a skip lane), indexed
    ``i % slots``; writing a slot in use raises rather than clobbering it."""

    def __init__(self, n_rows: int, slots: int, what: str,
                 where: str = "stage"):
        self.slots = slots
        self.what = what
        self.where = where
        self.live = [[None] * max(slots, 1) for _ in range(n_rows)]
        self.peak = 0

    def put(self, s: int, i: int, value) -> None:
        row = self.live[s]
        k = i % self.slots
        if row[k] is not None:
            raise RuntimeError(
                f"{self.what} slot clobber: micro-batch {i} arrives at "
                f"{self.where} {s} while slot {k} of {self.slots} is still "
                f"in use")
        row[k] = (i, value)
        self.peak = max(self.peak, sum(e is not None for e in row))

    def get(self, s: int, i: int, pop: bool = False):
        row = self.live[s]
        k = i % self.slots
        if row[k] is None or row[k][0] != i:
            raise RuntimeError(
                f"{self.what}: nothing for micro-batch {i} at {self.where} "
                f"{s} (slot {k} of {self.slots}); the op table is out of "
                f"order")
        value = row[k][1]
        if pop:
            row[k] = None
        return value

    def empty(self) -> bool:
        return all(e is None for row in self.live for e in row)


@dataclasses.dataclass
class _Step:
    """What one :meth:`ScheduledPipeline.loss_and_grad` walk carries from op
    to op: the rings and parks, the cotangents in flight (``gbuf``, keyed
    ``(i, s)``), this cycle's arrivals (stage outputs on their way to the
    next stash, lane values and pop gradients on their way to their parks),
    the stats and the loss."""

    m: int
    seed: Optional[int]
    split: bool
    inv_wsum: torch.Tensor
    stash: _Ring
    h_last: _Ring
    wstash: _Ring
    params: List[torch.Tensor]
    loss: torch.Tensor
    fpark: List[_Ring] = dataclasses.field(default_factory=list)
    gpark: List[_Ring] = dataclasses.field(default_factory=list)
    stats: Any = None
    gbuf: Dict[Tuple[int, int], Any] = dataclasses.field(
        default_factory=dict)
    arrivals: List[Tuple[_Ring, int, int, Any]] = dataclasses.field(
        default_factory=list)
    outbox: Dict[int, list] = dataclasses.field(default_factory=dict)


# --- messages between ranks ---

_KINDS = ("h", "g", "f", "r")   # stash, cotangent, lane park, reverse park
_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8)


def _encode(items, device) -> torch.Tensor:
    """One cycle's items for one peer as one ``int32`` word vector: the
    layout (``[n_layout, n_items, per item: kind, target, micro-batch,
    is_tuple, n_leaves, per leaf: dtype code (-1: None), ndim, dims]``) and
    then the tensors' words (``pack_words``)."""
    layout: List[int] = [len(items)]
    tensors = []
    for kind, target, i, value in items:
        vals = _leaves(value)
        layout += [_KINDS.index(kind), target, i,
                   int(isinstance(value, (tuple, list))), len(vals)]
        for v in vals:
            if v is None:
                layout.append(-1)
                continue
            if not isinstance(v, torch.Tensor):
                raise TypeError(
                    f"a stage boundary crossing ranks carries tensors only, "
                    f"got {type(v).__name__}")
            layout += [_DTYPES.index(v.dtype), v.dim(), *v.shape]
            tensors.append(v)
    head = torch.tensor([len(layout)] + layout, dtype=torch.int32,
                        device=device)
    return torch.cat([head, pack_words(tensors).to(device)])


def _decode(vec: torch.Tensor) -> list:
    """Inverse of :func:`_encode`: ``[(kind, target, i, value)]``."""
    n = int(vec[0])
    lay = iter(vec[1:1 + n].tolist())
    n_items = next(lay)
    heads, specs = [], []
    for _ in range(n_items):
        kind, target, i, is_tuple, n_leaves = (next(lay) for _ in range(5))
        codes = []
        for _ in range(n_leaves):
            code = next(lay)
            if code >= 0:
                shape = [next(lay) for _ in range(next(lay))]
                specs.append(torch.empty(shape, dtype=_DTYPES[code],
                                         device="meta"))
            codes.append(code)
        heads.append((_KINDS[kind], target, i, is_tuple, codes))
    got = iter(unpack_words(vec[1 + n:], specs))
    items = []
    for kind, target, i, is_tuple, codes in heads:
        vals = [next(got) if c >= 0 else None for c in codes]
        items.append((kind, target, i, tuple(vals) if is_tuple else vals[0]))
    return items


def _index(x, i: int):
    if isinstance(x, dict):
        return {k: v[i] for k, v in x.items()}
    return x[i]


def _leading(x) -> int:
    leaf = next(iter(x.values())) if isinstance(x, dict) else x
    if not isinstance(leaf, torch.Tensor):
        raise TypeError("x must be a tensor or a dict of tensors")
    return int(leaf.shape[0])


def _leading_rows(x) -> int:
    leaf = next(iter(x.values())) if isinstance(x, dict) else x
    return int(leaf.shape[1])


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
        (activation shapes equal at every boundary); with ``skip_lanes``
        ``(s, h, ctx, pops) -> (h, stashes)``, and with ``stat_spec`` a
        stats output appended (:class:`SkipLanes`, module docstring).
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
      skip_lanes: :class:`SkipLanes`, the cross-stage skips.
      stat_spec: set (to any value, e.g. a description of the stats) when
        the stages return stats, detached at source (``DeferredBatchNorm``'s
        are); the port reads only whether it is set.
      remat_policy: a ``core.remat.checkpoint_policies`` member or its name,
        for the recompute micro-batches (module docstring); inert, with a
        warning, under ``never``.
      mesh: a ``parallel.mesh.Mesh`` of ``n_stages`` stages: this rank walks
        its column of the tables (module docstring) on ``mesh.device``.
      split_stage: None, ``"auto"`` or a :class:`SplitBackwardStage`, the
        structural B/W split of a split table under ``never`` (module
        docstring); None keeps the stored-graph split there.
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
    skip_lanes: Optional[SkipLanes] = None
    stat_spec: Optional[Any] = None
    overlap_transport: Optional[bool] = None
    phase_compile: Optional[bool] = None
    mesh: Optional[Any] = None

    def __post_init__(self):
        validate_mode(self.checkpoint)
        self.remat_policy = resolve_policy(self.remat_policy)
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
        splits = getattr(self.schedule, "splits_backward", False)
        self._check_split(splits)
        if self.skip_lanes is not None and not self.skip_lanes.pairs:
            self.skip_lanes = None          # empty lanes = no skips
        if self.skip_lanes is not None:
            if splits:
                raise NotImplementedError(
                    "skip lanes do not compose with split-backward "
                    "schedules (zb-h1): the W op's params-only grads "
                    "cannot seed the reverse skip ring")
            if self.n_stages < 2:
                raise ValueError(
                    "cross-stage skip lanes need a >=2-device stage axis")
            S = self.schedule.v * self.n_stages
            for (src, dst) in self.skip_lanes.pairs:
                if not (0 <= src < dst < S):
                    raise ValueError(
                        f"skip lane ({src}, {dst}) out of range for "
                        f"{S} stages (need 0 <= src < dst < {S})")
            for spec in self.skip_lanes.specs:
                if hasattr(spec, "dtype"):
                    _check_lane_dtype(spec.dtype)
        if self.stat_spec is not None and self.split_stage is not None:
            raise ValueError(
                "split_stage's tapped/wgrad fns have no stats output; "
                "stat lanes need plain stage bodies")
        if self.stat_spec is not None and splits:
            raise NotImplementedError(
                "stat lanes do not compose with split-backward "
                "schedules (zb-h1): the W op's seed has no stats slot")
        if self.remat_policy is not None and self.checkpoint == "never":
            warnings.warn(
                "remat_policy is inert under checkpoint='never': every "
                "micro-batch stores its full residual set and nothing is "
                "recomputed. Use 'always' or 'except_last' to engage the "
                "policy.", stacklevel=2)
        if splits and self.checkpoint != "never":
            warnings.warn(
                f"schedule {self.schedule.name!r} splits backward into B/W "
                f"ops to fill bubble slots with weight-grad compute, but "
                f"checkpoint={self.checkpoint!r} recomputes the forward at "
                f"B and the full backward runs there — the W slots carry no "
                f"compute and the zero-bubble advantage is lost. Pair "
                f"zero-bubble schedules with checkpoint='never'.",
                stacklevel=2)
        if self.mesh is not None:
            if self.mesh.n_stages != self.n_stages:
                raise ValueError(
                    f"a mesh of {self.mesh.n_stages} stages for an executor "
                    f"of {self.n_stages}")
            self.device = self.mesh.device
        else:
            self.device = resolve_device(self.device)
        self._rows = None
        self.v = self.schedule.v
        self.n_virtual = self.v * self.n_stages
        self.last_slots: Dict[str, int] = {}
        pairs = self.skip_lanes.pairs if self.skip_lanes is not None else ()
        self._pops_at = [[l for l, (_, dst) in enumerate(pairs) if dst == s]
                         for s in range(self.n_virtual)]
        self._stashes_at = [[l for l, (src, _) in enumerate(pairs)
                             if src == s] for s in range(self.n_virtual)]

    def _check_split(self, splits: bool) -> None:
        """``split_stage``: ``"auto"`` derived from the stage body, then
        ``pipe_tpu``'s guards, in its order, types and words."""
        if isinstance(self.split_stage, str):
            if self.split_stage != "auto":
                raise ValueError(
                    f"split_stage must be a SplitBackwardStage or 'auto', "
                    f"got {self.split_stage!r}")
            from ..core.remat import split_backward_stage
            self.split_stage = split_backward_stage(self.stage_fn,
                                                    self.module)
        if self.split_stage is None:
            return
        if not splits:
            raise ValueError(
                "split_stage requires a splits_backward schedule "
                "(zb-h1): B/W table ops are where the split executes")
        if self.checkpoint != "never":
            raise ValueError(
                "split_stage requires checkpoint='never': the stored "
                "params-constant vjp IS the activation store")
        if self.remat_policy is not None:
            raise ValueError(
                "split_stage already defines its storage (full "
                "residuals + taps); remat_policy would be silently "
                "inert — drop one of the two")

    # --- tables ---

    def _tables(self, m: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        tables = self.schedule.op_tables(m, self.n_stages)
        op, mbi = tables[0], tables[1]
        grp = tables[2] if len(tables) > 2 else np.zeros_like(op)
        return op, mbi, grp

    def memory_plan(self, m: int) -> dict:
        """Per-stage buffer counts of the walk: ``activation_slot_plan``
        over its slot counts, with the cycle count and the (serialized)
        transport, and the skip parks' slots, as ``pipe_tpu``'s
        ``memory_plan`` reports them."""
        d = self.n_stages
        op, mbi, grp = self._tables(m)
        plan = {"cycles": int(op.shape[0]),
                **activation_slot_plan(MemoryPlanInputs(
                    v=self.v, stash_slots=self.schedule.stash_slots(m, d),
                    wstash_slots=self.schedule.wstash_slots(m, d),
                    checkpoint=self.checkpoint,
                    has_remat_policy=self.remat_policy is not None,
                    split_stage=self.split_stage is not None)),
                "transport": "serialized"}
        if self.skip_lanes is not None:
            kf, kg = self._skip_tables(m, op, mbi, grp)
            plan["skip_lanes"] = len(self.skip_lanes.pairs)
            plan["skip_fwd_park_slots"] = sum(kf)
            plan["skip_bwd_park_slots"] = sum(kg)
        return plan

    def _skip_tables(self, m: int, op, mbi, grp, *, fwd_only: bool = False
                     ) -> Tuple[List[int], List[int]]:
        """Host-side skip-lane plan from the op tables: per lane ``(src,
        dst)`` the FIFO depths ``Kf`` (forward park at ``dst``) and ``Kg``
        (reverse park at ``src``), the smallest with no collision of
        overlapping live windows under slot ``i % K``. A stash arrives the
        cycle after FWD(i, src) and lives until FWD(i, dst), or BWD(i, dst)
        for a micro-batch that re-runs its stage from the stash there (it
        needs its pops again: a recompute without a policy); a pop
        gradient arrives the cycle after BWD(i, dst) and lives until
        BWD(i, src). A table that uses a value before it arrives raises.
        ``fwd_only`` plans the FWD-masked tables of :meth:`forward` (no
        re-read, no reverse park). Counterpart of ``pipe_tpu``'s
        ``_skip_tables`` without its overlapped-transport branch."""
        d, S = self.n_stages, self.n_virtual
        fwd_c = np.full((m, S), -1, np.int64)
        bwd_c = np.full((m, S), -1, np.int64)
        for t in range(op.shape[0]):
            for p in range(d):
                s = grp[t, p] * d + p
                if op[t, p] == FWD:
                    fwd_c[mbi[t, p], s] = t
                elif op[t, p] == BWD:
                    bwd_c[mbi[t, p], s] = t

        def fifo_depth(windows):
            for K in range(1, m + 1):
                if all(windows[i][1] < windows[i2][0]
                       for i in range(m) for i2 in range(i + K, m, K)):
                    return K
            return m

        kf, kg = [], []
        for (src, dst) in self.skip_lanes.pairs:
            wf, wg = [], []
            for i in range(m):
                arr_f, use_f = fwd_c[i, src] + 1, fwd_c[i, dst]
                if not (0 <= fwd_c[i, src] and arr_f <= use_f):
                    raise ValueError(
                        f"skip lane ({src},{dst}): stash for micro-batch "
                        f"{i} arrives at cycle {arr_f} after its FWD "
                        f"{use_f} — the schedule violates the direct-hop "
                        f"timing assumption")
                reread = not fwd_only and self._reruns_at_b(i, m)
                wf.append((arr_f, bwd_c[i, dst] if reread else use_f))
                if fwd_only:
                    continue
                arr_g, use_g = bwd_c[i, dst] + 1, bwd_c[i, src]
                if not (0 <= bwd_c[i, dst] and arr_g <= use_g):
                    raise ValueError(
                        f"skip lane ({src},{dst}): cotangent for "
                        f"micro-batch {i} arrives at cycle {arr_g} after "
                        f"its BWD {use_g} — the schedule violates the "
                        f"direct-hop timing assumption")
                wg.append((arr_g, use_g))
            kf.append(fifo_depth(wf))
            if not fwd_only:
                kg.append(fifo_depth(wg))
        return kf, kg

    def stage_passes(self, m: int, column: Optional[int] = None
                     ) -> Dict[str, int]:
        """Stage-body passes one :meth:`loss_and_grad` runs, read from the
        tables: ``forward`` counts every FWD and every recompute at B;
        ``backward`` every walk of a stage's backward graph — one per BWD
        (the structural split walks it at B only: its W runs the weight
        products alone), and under the stored-graph split one per W plus
        one per B off stage 0 (stage 0's B has no input cotangent to take:
        its input is the micro-batch). A layer with a kernel in its forward
        and backward launches it this many times per stage it sits in (the
        totals divide evenly by the stage count when no table is split).
        ``column``: the passes of that stage column only (a mesh rank's)."""
        op, mbi, grp = self._tables(m)
        if column is not None:
            op, mbi, grp = (a[:, column:column + 1] for a in (op, mbi, grp))
        split = bool((op == WGRAD).any()) and self.checkpoint == "never"
        n_fwd, n_bwd = int((op == FWD).sum()), int((op == BWD).sum())
        if split and self.split_stage is None:
            b_stage0 = (int(((op[:, 0] == BWD) & (grp[:, 0] == 0)).sum())
                        if column in (None, 0) else 0)
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

    def _reruns_at_b(self, i: int, m: int) -> bool:
        """Whether micro-batch ``i`` re-runs its stages from the stash at B:
        a recompute micro-batch without a ``remat_policy`` (under one it keeps
        the policy's checkpointed graph from F instead)."""
        return self.remat_policy is None and not self._keeps_graph(i, m)

    # --- the ops ---

    def _seeds(self, seed: Optional[int], i: int, s: int):
        """ctx seeds of (pre, stage, post) for micro-batch ``i`` at virtual
        stage ``s``: JAX's ``fold_in(fold_in(key, i), s)`` then 0, 1, 2."""
        if seed is None:
            return None, None, None
        kis = fold_seed(fold_seed(seed, i), s)
        return tuple(fold_seed(kis, k) for k in range(3))

    def _stage(self, s: int, h_in, x_mb, seeds, train: bool, i: int,
               pops=None):
        """Pre (stage 0) then stage ``s``; returns ``(h, stashes, stats)``
        (None for the extras not configured)."""
        if s == 0:
            h_in = self.pre_fn(x_mb, self._ctx(seeds[0], train, i, 0))
        ctx = self._ctx(seeds[1], train, i, s)
        if self.skip_lanes is None:
            out = self.stage_fn(s, h_in, ctx)
        else:
            out = self.stage_fn(s, h_in, ctx, pops)
        return self._split_out(out)

    def _ctx(self, seed, train: bool, i: int, s: int) -> StageCtx:
        """The task's ctx; on a mesh of several data ranks it carries the
        data group and this rank's rows of the micro-batch."""
        if self._rows is None:
            return StageCtx(seed=seed, train=train, microbatch=i, stage=s)
        return StageCtx(seed=seed, train=train, microbatch=i, stage=s,
                        data_axis=self.mesh, rows=self._rows)

    def _split_out(self, out):
        """Destructure a stage output into ``(h, stashes, stats)`` per the
        configured extras (None for the absent ones)."""
        if self.skip_lanes is not None and self.stat_spec is not None:
            return tuple(out)
        if self.skip_lanes is not None:
            h, sk = out
            return h, sk, None
        if self.stat_spec is not None:
            h, st = out
            return h, None, st
        return out, None, None

    def _pops(self, st: _Step, s: int, i: int, *, leaf: bool, last: bool):
        """The pops of stage ``s`` for micro-batch ``i`` from the forward
        parks (None for lanes that do not end at ``s``), as leaves that
        require grad when ``leaf``; ``last`` releases their slots."""
        if self.skip_lanes is None:
            return None
        pops = [None] * len(self.skip_lanes.pairs)
        for l in self._pops_at[s]:
            v = st.fpark[l].get(0, i, pop=last)
            pops[l] = v.detach().requires_grad_(True) if leaf else v
        return tuple(pops)

    def _park_stashes(self, st: _Step, s: int, i: int, stashes) -> None:
        for l in self._stashes_at[s]:
            v = stashes[l]
            _check_lane_dtype(v.dtype)
            self._route(st, "f", l, i, v.detach())

    def _post(self, h, x_mb, w_mb, seeds, i: int) -> torch.Tensor:
        """The unnormalized loss contribution ``sum(w · per_row)``."""
        per_row = self.post_fn(h, x_mb, self._ctx(seeds[2], True, i,
                                                  self.n_virtual - 1))
        return (w_mb * per_row).sum().float()

    # --- the step ---

    def _tapped(self, entry: _Entry, s: int, x_mb, seeds, i: int):
        """The structural split's FWD: the pre on stage 0 (with its graph,
        for B), then the tapped body; keeps the products' gradient edges and
        taps in ``entry`` and returns the stage output."""
        with torch.enable_grad():
            if s == 0:
                entry.h_in = self.pre_fn(x_mb, self._ctx(seeds[0], True, i, 0))
            else:
                _require_grad(entry.h_in)
            out, ys, entry.taps = self.split_stage.tapped_fn(
                s, entry.h_in, self._ctx(seeds[1], True, i, s))
        entry.out = out
        entry.edges = [torch.autograd.graph.get_gradient_edge(y) for y in ys]
        return out

    def _fwd_op(self, st: _Step, i: int, s: int, x_mb, w_mb) -> None:
        seeds = self._seeds(st.seed, i, s)
        if s == 0:
            st.stash.put(0, i, _Entry(None))
        entry = st.stash.get(s, i)
        if self.split_stage is not None:
            self._fwd_out(st, i, s, x_mb, w_mb, seeds,
                          self._tapped(entry, s, x_mb, seeds, i))
            return
        save = not self._reruns_at_b(i, st.m)
        policy = save and not self._keeps_graph(i, st.m)
        pops = self._pops(st, s, i, leaf=save, last=save)
        with torch.set_grad_enabled(save):
            if save and s > 0:
                _require_grad(entry.h_in)
            stage = apply_remat(self._stage, enabled=policy,
                                policy=self.remat_policy)
            out, stashes, stats = stage(s, entry.h_in, x_mb, seeds, True, i,
                                        pops)
        if stats is not None:
            st.stats = _tree_add(st.stats, stats)
        if stashes is not None:
            self._park_stashes(st, s, i, stashes)
        if save:
            entry.out, entry.stashes, entry.pops = out, stashes, pops
        self._fwd_out(st, i, s, x_mb, w_mb, seeds, out)

    def _fwd_out(self, st: _Step, i: int, s: int, x_mb, w_mb, seeds,
                 out) -> None:
        """A stage output's way on: to the next stage's stash, or on the
        last stage into the loss (no graph) and the ``h_last`` park."""
        if s < self.n_virtual - 1:
            self._route(st, "h", s + 1, i, _detached(out))
            return
        with torch.no_grad(), torch.profiler.record_function(
                f"table:post-F{i}"):
            st.loss = st.loss + self._post(_detached(out), x_mb, w_mb,
                                           seeds, i)
        st.h_last.put(0, i, _detached(out))

    def _bwd_op(self, st: _Step, i: int, s: int, x_mb, w_mb) -> None:
        seeds = self._seeds(st.seed, i, s)
        entry = st.stash.get(s, i, pop=not st.split)
        if s == self.n_virtual - 1:
            # the post's graph, rebuilt from the parked output
            with torch.profiler.record_function(f"table:post-B{i}"):
                hl = _require_grad(st.h_last.get(0, i, pop=True))
                with torch.enable_grad():
                    c = self._post(hl, x_mb, w_mb, seeds, i)
                c.backward(st.inv_wsum)
            seed_h = _grads_of(hl)
        else:
            seed_h = st.gbuf.pop((i, s))
        if self.split_stage is not None:
            self._split_b(st, entry, i, s, seed_h)
            return
        out, stashes, pops = entry.out, entry.stashes, entry.pops
        if out is None:                                 # recompute
            pops = self._pops(st, s, i, leaf=True, last=True)
            with torch.enable_grad():
                if s > 0:
                    _require_grad(entry.h_in)
                out, stashes, _ = self._stage(s, entry.h_in, x_mb, seeds,
                                              True, i, pops)
        outs, seeds_out = list(_leaves(out)), list(_leaves(seed_h))
        for l in self._stashes_at[s]:
            outs.append(stashes[l])
            seeds_out.append(st.gpark[l].get(0, i, pop=True))
        if st.split:
            if s > 0:
                ins = [t for t in _leaves(entry.h_in) if _differentiable(t)]
                pairs = [(o, g) for o, g in zip(outs, seeds_out)
                         if g is not None and o.requires_grad]
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], ins, [g for _, g in pairs],
                    retain_graph=True, allow_unused=True) if ins else ())
                self._route(st, "g", s - 1, i, _like(entry.h_in, [
                    _or_zeros(next(got), t) if _differentiable(t) else None
                    for t in _leaves(entry.h_in)]))
            st.wstash.put(s, i, seed_h)
        else:
            _backward(outs, seeds_out)
            if s > 0:
                self._route(st, "g", s - 1, i, _grads_of(entry.h_in))
        for l in self._pops_at[s]:
            self._route(st, "r", l, i, _or_zeros(pops[l].grad, pops[l]))

    def _split_b(self, st: _Step, entry: _Entry, i: int, s: int,
                 seed_h) -> None:
        """The structural split's B: one ``autograd.grad`` of the stage
        output at its input and at the products' outputs. The input
        cotangent goes to stage ``s - 1`` (on stage 0 through the pre's
        backward, into its parameters); the products' cotangents park for
        W. The graph is freed here; the taps stay in the stash until W."""
        ins = [t for t in _leaves(entry.h_in)
               if isinstance(t, torch.Tensor) and t.requires_grad]
        pairs = [(o, g) for o, g in zip(_leaves(entry.out), _leaves(seed_h))
                 if g is not None and isinstance(o, torch.Tensor)
                 and o.requires_grad]
        wanted = ins + entry.edges
        got = (torch.autograd.grad([o for o, _ in pairs], wanted,
                                   [g for _, g in pairs], allow_unused=True)
               if pairs and wanted else [None] * len(wanted))
        g_in = dict(zip(map(id, ins), got))
        if s > 0:
            self._route(st, "g", s - 1, i, _like(entry.h_in, [
                _or_zeros(g_in.get(id(t)), t) if _differentiable(t) else None
                for t in _leaves(entry.h_in)]))
        else:
            _backward(ins, got[:len(ins)])
        st.wstash.put(s, i, list(got[len(ins):]))
        entry.h_in = entry.out = entry.edges = None

    def _w_op(self, st: _Step, i: int, s: int, x_mb, w_mb) -> None:
        entry = st.stash.get(s, i, pop=True)
        seed = st.wstash.get(s, i, pop=True)
        if self.split_stage is None:
            _backward(_leaves(entry.out), _leaves(seed), inputs=st.params)
            return
        pairs = self.split_stage.wgrad_fn(s, entry.taps, seed)
        _backward([t for t, _ in pairs], [g for _, g in pairs])

    # --- the transport ---

    def _owner(self, kind: str, target: int) -> int:
        """The virtual stage a routed value is for."""
        if kind in ("h", "g"):
            return target
        src, dst = self.skip_lanes.pairs[target]
        return dst if kind == "f" else src

    def _route(self, st: _Step, kind: str, target: int, i: int,
               value) -> None:
        """An op's write for another stage: ``kind`` ``"h"`` (stage
        ``target``'s stash), ``"g"`` (stage ``target``'s cotangent),
        ``"f"``/``"r"`` (lane ``target``'s forward/reverse park). Delivered
        here when this rank holds that stage, else to its rank's outbox."""
        col = self._owner(kind, target) % self.n_stages
        if self.mesh is None or col == self.mesh.stage:
            self._deliver(st, kind, target, i, value)
        else:
            st.outbox.setdefault(self.mesh.rank_of(col), []).append(
                (kind, target, i, value))

    @staticmethod
    def _deliver(st: _Step, kind: str, target: int, i: int, value) -> None:
        if kind == "g":
            st.gbuf[(i, target)] = value
        elif kind == "h":
            st.arrivals.append((st.stash, target, i, value))
        else:
            park = st.fpark if kind == "f" else st.gpark
            st.arrivals.append((park[target], 0, i, value))

    def _senders(self, t: int, op, grp, fwd_only: bool) -> List[int]:
        """The ranks that send to this one at the end of cycle ``t``: every
        other column whose op writes into a stage of this rank."""
        d, me = self.n_stages, self.mesh.stage
        pairs = self.skip_lanes.pairs if self.skip_lanes is not None else ()
        peers = []
        for q in range(d):
            code, s = int(op[t, q]), int(grp[t, q]) * d + q
            if q == me:
                continue
            if code == FWD:
                dests = [s + 1] if s < self.n_virtual - 1 else []
                dests += [dst for src, dst in pairs if src == s]
            elif code == BWD and not fwd_only:
                dests = [s - 1] if s > 0 else []
                dests += [src for src, dst in pairs if dst == s]
            else:
                continue
            if any(x % d == me for x in dests):
                peers.append(self.mesh.rank_of(q))
        return peers

    def _exchange(self, st: _Step, t: int, op, grp,
                  fwd_only: bool = False) -> None:
        """End of cycle ``t`` on a mesh: one packed message to each peer
        this rank wrote for, one from each peer that wrote for it."""
        if self.mesh is None:
            return
        sends = {peer: _encode(items, self.device)
                 for peer, items in st.outbox.items()}
        st.outbox = {}
        got = self.mesh.exchange(sends, self._senders(t, op, grp, fwd_only),
                                 tag=2 * t)
        for peer in sorted(got):
            for kind, target, i, value in _decode(got[peer]):
                self._deliver(st, kind, target, i, value)

    def _columns(self) -> range:
        d = self.n_stages
        return (range(d) if self.mesh is None
                else range(self.mesh.stage, self.mesh.stage + 1))

    def _local_params(self) -> List[Tuple[str, torch.Tensor]]:
        """``module``'s parameters this rank holds (not on ``meta``)."""
        return [(n, p) for n, p in self.module.named_parameters()
                if p.device.type != "meta"]

    def _shard_rows(self, x, w=None):
        """On a mesh, this data rank's rows of ``x`` (and ``w``), with the
        ctx's ``(offset, total)``; unchanged without one."""
        self._rows = None
        if self.mesh is None or self.mesh.n_data == 1:
            return x, w
        from ..runtime.distributed import host_local_batch, rows_of
        total = _leading_rows(x)
        self._rows = tuple(rows_of(self.mesh, total))
        return (host_local_batch(self.mesh, x),
                None if w is None else host_local_batch(self.mesh, w))

    def _reduce_grads(self, params: List[torch.Tensor]) -> None:
        """Sum the gradients over the data group: one flat buffer per
        dtype, one all-reduce each."""
        if self.mesh is None or self.mesh.n_data == 1:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.mesh.all_reduce(flat, "data")
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def _reduce_stats(self, stats):
        """Stats summed over the data group (one flat buffer)."""
        if stats is None or self.mesh is None or self.mesh.n_data == 1:
            return stats
        leaves: List[torch.Tensor] = []

        def walk(a):
            if isinstance(a, dict):
                for v in a.values():
                    walk(v)
            elif isinstance(a, (tuple, list)):
                for v in a:
                    walk(v)
            elif isinstance(a, torch.Tensor):
                leaves.append(a)

        walk(stats)
        if not leaves:
            return stats
        flat = torch.cat([l.reshape(-1).float() for l in leaves])
        self.mesh.all_reduce(flat, "data")
        off = 0
        for l in leaves:
            l.copy_(flat[off:off + l.numel()].view_as(l))
            off += l.numel()
        return stats

    def _parks(self, m: int, op, mbi, grp, *, fwd_only: bool = False):
        if self.skip_lanes is None:
            return [], []
        kf, kg = self._skip_tables(m, op, mbi, grp, fwd_only=fwd_only)
        return ([_Ring(1, k, f"skip lane {l} park", "lane")
                 for l, k in enumerate(kf)],
                [_Ring(1, k, f"skip lane {l} reverse park", "lane")
                 for l, k in enumerate(kg)])

    def loss_and_grad(self, x, w, *, seed: Optional[int] = 0):
        """One step through the tables: returns ``(loss, grads)``, and
        ``(loss, grads, stats)`` with ``stat_spec``.

        ``x``: a tensor or a dict of tensors ``[m, rows, ...]``
        (micro-batched, e.g. by ``core.microbatch.stack_scatter``); ``w``:
        ``[m, rows]`` row weights, 0 for padding rows. The loss is
        ``sum(w · per_row) / sum(w)``. Parameter gradients accumulate into
        ``.grad`` as ``backward()`` does (zero them first), and ``grads`` is
        ``{name: grad}`` over ``module``'s parameters. ``seed`` drives
        dropout (None: none). ``stats`` is the sum of every FWD op's stats
        output. On a mesh ``x`` and ``w`` are the global batch, ``grads``
        this rank's parameters' (summed over the data group), and the loss
        and stats the whole batch's on every rank."""
        m = _leading(x)
        x = _to(x, self.device)
        w = w.to(self.device, torch.float32)
        if tuple(w.shape[:1]) != (m,):
            raise ValueError(f"w must be [m={m}, rows], got {tuple(w.shape)}")
        inv_wsum = 1.0 / w.sum()          # the global sum, once
        x, w = self._shard_rows(x, w)
        op, mbi, grp = self._tables(m)
        d, S = self.n_stages, self.n_virtual
        get_registry().gauge("scheduled.cycles").set(int(op.shape[0]))
        split = bool((op == WGRAD).any()) and self.checkpoint == "never"
        Sg = self.schedule.stash_slots(m, d)
        fpark, gpark = self._parks(m, op, mbi, grp)
        local = [p for _, p in self._local_params() if p.requires_grad]
        st = _Step(
            m=m, seed=seed, split=split, inv_wsum=inv_wsum,
            stash=_Ring(S, Sg, "stash"), h_last=_Ring(1, Sg, "h_last"),
            wstash=_Ring(S, self.schedule.wstash_slots(m, d) if split else 1,
                         "wstash"),
            params=local, loss=torch.zeros((), device=self.device),
            fpark=fpark, gpark=gpark)
        run = {FWD: self._fwd_op, BWD: self._bwd_op, WGRAD: self._w_op}
        for t in range(op.shape[0]):
            for p in self._columns():
                code = int(op[t, p])
                if code == IDLE or (code == WGRAD and not split):
                    continue
                i, s = int(mbi[t, p]), int(grp[t, p]) * d + p
                with torch.profiler.record_function(
                        f"table:{'FBW'[code - 1]}{i}-stage{s}"):
                    run[code](st, i, s, _index(x, i), w[i])
            self._exchange(st, t, op, grp)
            for ring, s, i, h in st.arrivals:
                ring.put(s, i, _Entry(h) if ring is st.stash else h)
            st.arrivals.clear()
        if st.gbuf or not all(r.empty() for r in (st.stash, *fpark, *gpark)):
            raise RuntimeError(
                f"schedule {self.schedule.name!r} left state unconsumed at "
                f"m={m}: its table misses a BWD or WGRAD op")
        self.last_slots = {"stash": st.stash.peak, "h_last": st.h_last.peak,
                           "wstash": st.wstash.peak if split else 0}
        if self.skip_lanes is not None:
            self.last_slots["skip_fwd_park"] = sum(r.peak for r in fpark)
            self.last_slots["skip_bwd_park"] = sum(r.peak for r in gpark)
        self._reduce_grads(local)
        grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for name, p in self._local_params()}
        total = st.loss.detach()
        if self.mesh is not None:
            self.mesh.all_reduce(total, "world")
        loss = total * st.inv_wsum
        if self.stat_spec is not None:
            return loss, grads, self._reduce_stats(st.stats)
        return loss, grads

    def forward(self, x, *, seed: Optional[int] = 0, train: bool = False):
        """The tables' FWD ops only (BWD and WGRAD masked to IDLE): the last
        virtual stage's outputs ``[m, rows, ...]`` (a tuple of them for a
        tuple boundary), no post applied, and ``(outputs, stats)`` with
        ``stat_spec``: every micro-batch runs once per stage, so stats
        count once. Skips ride the forward parks, no reverse. Runs under
        the caller's grad mode. On a mesh ``x`` is the global batch and the
        outputs are this data rank's rows, on the ranks of the last virtual
        stage (None on the others); the stats are the whole batch's."""
        m = _leading(x)
        x = _to(x, self.device)
        x, _ = self._shard_rows(x)
        op, mbi, grp = self._tables(m)
        d, S = self.n_stages, self.n_virtual
        fpark, _ = self._parks(m, op, mbi, grp, fwd_only=True)
        st = _Step(m=m, seed=seed, split=False, inv_wsum=None,
                   stash=_Ring(S, self.schedule.stash_slots(m, d), "stash"),
                   h_last=None, wstash=None, params=[], loss=None,
                   fpark=fpark)
        outs: List[Any] = [None] * m
        for t in range(op.shape[0]):
            for p in self._columns():
                if int(op[t, p]) != FWD:
                    continue
                i, s = int(mbi[t, p]), int(grp[t, p]) * d + p
                h_in = st.stash.get(s, i, pop=True) if s > 0 else None
                pops = self._pops(st, s, i, leaf=False, last=True)
                out, stashes, stats = self._stage(
                    s, h_in, _index(x, i), self._seeds(seed, i, s), train,
                    i, pops)
                if stats is not None:
                    st.stats = _tree_add(st.stats, stats)
                if stashes is not None:
                    self._park_stashes(st, s, i, stashes)
                if s == S - 1:
                    outs[i] = out
                else:
                    self._route(st, "h", s + 1, i, out)
            self._exchange(st, t, op, grp, fwd_only=True)
            for ring, s, i, h in st.arrivals:
                ring.put(s, i, h)
            st.arrivals.clear()
        if outs[0] is None:                  # the last stage is elsewhere
            res = None
        elif isinstance(outs[0], (tuple, list)):
            res = tuple(torch.stack(col) for col in zip(*outs))
        else:
            res = torch.stack(outs)
        if self.stat_spec is not None:
            return res, self._reduce_stats(st.stats)
        return res
