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

**Overlapped transport** (``overlap_transport``, ``pipe_tpu``'s tri-state)
walks the tables of ``core.schedule.shift_comm_tables``, in which every
consumer runs at least two cycles after its producer: what a cycle routes to
another rank goes out at the start of the next cycle
(:meth:`~pipe_tpu_torch.parallel.mesh.Mesh.post`, one round: both ends read
the payload's length from the tables and the boundary's layout) and is waited
for and parked after that cycle's compute (``Mesh.wait``), so the backend's
threads carry it while the stream computes. Cotangents park in a grad park
of ``Gg`` slots until their BWD; a skip lane of ``H`` hops parks ``max(H,
1)`` cycles after its value was made, as ``pipe_tpu``'s relay. The slot
counts (``Sg``, ``Gg``, ``Wg``) come from the shifted tables as
``pipe_tpu``'s ``_overlap_plans`` derives them, proved by
``verify_shifted_op_tables`` before the first cycle. A boundary's layout
(dtypes and shapes) is learned from its first crossing in an executor, which
goes as :meth:`Mesh.exchange` sends it (a length, then the layout and the
words); every later crossing of it is the one round. Each rank keeps its op
order, so losses, gradients and stats are the serialized walk's bit for bit.
``None``: on for a mesh of CUDA ranks with more than one stage, off for CPU
ranks, at one stage and without a mesh (``True`` walks the shifted tables
on one device too).

**Phase compilation** (``phase_compile``) walks the tables of
``core.schedule.compile_phases``, which re-times them so that every cycle
runs one op code on every rank: the ramps cycle by cycle (a rank idle in a
ramp cycle skips it, where ``pipe_tpu`` computes on garbage and masks it,
ROADMAP.md C.23), the steady state as repeated periods of one concrete op
sequence, with the overlapped transport's plans. Each (stage, op code)
stream keeps its order, so results are the interpreted walk's bit for bit.
``None``: on for a mesh of CUDA ranks with more than one stage when the
compiler accepts the table; a table it rejects under ``True`` warns naming
the compiler's reason and runs interpreted, as ``pipe_tpu``'s. The
counters ``scheduled.phase.compiled`` and ``scheduled.phase.rejected`` and
the gauges ``scheduled.phase.active``, ``scheduled.phase.scan_cycles``,
``scheduled.phase.unrolled_cycles`` and ``scheduled.transport.overlap`` are
``pipe_tpu``'s.

**Context parallelism** (``context_axis="context"``, over a mesh made with
``n_context``): dim ``context_dim`` of every input leaf with more dims than
that (the sequence of ``[m, rows, seq]`` tokens and targets) is sharded over
the rank's context line beside its rows over data, so the stage bodies see
sequence shards and attend over the line (``models/long_context_lm.py``).
A stage's context line runs one column of the tables in one order, so its
context collectives (inside the ops) never cross its stage messages
(between them, over the column). The post must return a context-invariant
value (a per-row loss averaged over the line); its copies on the line count
once in the loss. Replicated parameters' gradients are summed over the
stage's whole ``(data, context)`` plane in one all-reduce, as JAX's
``_grad_reduce_axes``.

**Tensor parallelism** (``stage_param_specs``, over a mesh made with
``n_model``): one stage's per-leaf ``PartitionSpec``s (a list of per-layer
trees, ``TPPipelinedLM.stage_param_specs``), checked at construction
against each stage's blocks (``module.stage_blocks(s)``, their parameters
as nested dicts) with ``pipe_tpu``'s words; then every leaf sharded over
the model axis is cut to this rank's block (``parallel.mesh.shard_params``)
and the blocks all-reduce over the rank's model line inside the ops. A
model line runs one column of the tables in one order, so its collectives
never cross its stage messages, serialized, overlapped or phase-compiled.
Gradients are never summed over the model axis (``pipe_tpu``'s
``_grad_reduce_axes``): every leaf's, sharded or replicated, is summed
over the stage's ``(data[, context])`` plane at the rank's model index, and
:meth:`ScheduledPipeline.gather_model_grads` gathers a rank's sharded
leaves over its line into whole ones. The loss's copies on a model line
count once. ``split_stage`` refuses specs, as ``pipe_tpu``'s does.
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
from ..core.schedule import (BWD, FWD, IDLE, WGRAD, _times_by_code,
                             compile_phases, get_schedule,
                             overlap_joint_capacity, shift_comm_tables,
                             verify_shifted_op_tables)
from ..obs.telemetry import get_registry
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .buffers import pack_words, packed_words, unpack_words
from .mesh import (flat_specs, gather_model_shards, param_tree,
                   shard_params, tree_structure)

__all__ = ["ScheduledPipeline", "SkipLanes", "SplitBackwardStage"]


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
    # overlapped transport: the cycle being walked, the grad park, and the
    # values on their way, each with the cycle after whose compute it parks
    overlap: bool = False
    t: int = 0
    gradpark: Optional[_Ring] = None
    pending: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class _WalkPlan:
    """The tables one :meth:`ScheduledPipeline.loss_and_grad` walks and
    their slot counts: the schedule's (``serialized``), the comm-shifted
    ones (``overlapped``) or a phase program's (``phase-compiled``, with
    ``program``); ``grad_slots`` is the grad park's, 0 when serialized."""

    op: np.ndarray
    mbi: np.ndarray
    grp: np.ndarray
    stash_slots: int
    grad_slots: int
    wstash_slots: int
    transport: str
    program: Any = None

    @property
    def overlap(self) -> bool:
        return self.transport != "serialized"


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


def _item_key(item) -> tuple:
    """The order of a message's items on both ends: kind, target,
    micro-batch."""
    return _KINDS.index(item[0]), item[1], item[2]


def _layout_of(value) -> tuple:
    """A boundary value's layout: whether it is a tuple, and per leaf its
    dtype and shape (None for a None leaf)."""
    return (isinstance(value, (tuple, list)),
            tuple(None if v is None else (v.dtype, tuple(v.shape))
                  for v in _leaves(value)))


def _specs(layout) -> list:
    """A layout's tensor leaves as ``meta`` tensors (shapes and dtypes)."""
    return [torch.empty(shape, dtype=dtype, device="meta")
            for dtype, shape in (l for l in layout[1] if l is not None)]


def _unpack_items(vec: torch.Tensor, keys, layouts) -> list:
    """The values of ``keys`` (``(kind, target, i)``, in message order) from
    one message of packed words, each laid out as ``layouts`` holds it for
    its ``(kind, target)``."""
    plans = [layouts[(kind, target)] for kind, target, _ in keys]
    got = iter(unpack_words(vec, [t for lay in plans for t in _specs(lay)]))
    out = []
    for is_tuple, leaves in plans:
        vals = [None if l is None else next(got) for l in leaves]
        out.append(tuple(vals) if is_tuple else vals[0])
    return out


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


def _context_block(x, mesh, dim: int):
    """Block ``mesh.context`` of ``mesh.n_context`` along ``dim`` of each
    leaf with more than ``dim`` dims (JAX's ``P(..., context)`` in-spec)."""
    if isinstance(x, dict):
        return {k: _context_block(v, mesh, dim) for k, v in x.items()}
    if x.dim() <= dim:
        return x
    n = mesh.context_size
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not shard "
                         f"over {n} context ranks")
    per = x.shape[dim] // n
    return x.narrow(dim, mesh.context * per, per)


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
      overlap_transport, phase_compile: None (auto), True or False: the
        overlapped transport and the phase-compiled walk (module
        docstring).
      context_axis, context_dim: ``"context"`` over a mesh with that axis
        shards dim ``context_dim`` of the input leaves over it (module
        docstring).
      stage_param_specs: one stage's per-leaf ``PartitionSpec``s, a list
        of per-layer trees (tensor parallelism, module docstring); the
        module must give ``stage_blocks(s)``.
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
    context_dim: int = 2

    def __post_init__(self):
        validate_mode(self.checkpoint)
        self.remat_policy = resolve_policy(self.remat_policy)
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
        if self.context_axis and self.context_axis not in (
                self.mesh.axis_names if self.mesh is not None else ()):
            raise ValueError(
                f"mesh has no {self.context_axis!r} axis for context_axis")
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
        self._param_specs = (self._bind_param_specs()
                             if self.stage_param_specs is not None else {})
        self.last_slots: Dict[str, int] = {}
        # per-m phase verdicts (the rejection warns once per m) and walk
        # plans; the boundary layouts the overlapped transport learned
        # (received, and sent) for the batch signature ``_signature``
        self._phase_cache: Dict[int, Any] = {}
        self._plans: Dict[int, _WalkPlan] = {}
        self._layouts: Dict[Tuple[str, int], tuple] = {}
        self._sent: Dict[Tuple[str, int], tuple] = {}
        self._signature = None
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
        if self.stage_param_specs is not None:
            raise ValueError(
                "split_stage does not compose with stage_param_specs "
                "(tensor-parallel sharded stage params): the tapped/"
                "wgrad fns are written for unsharded math and would "
                "silently drop the cross-shard psums")
        if self.remat_policy is not None:
            raise ValueError(
                "split_stage already defines its storage (full "
                "residuals + taps); remat_policy would be silently "
                "inert — drop one of the two")

    # --- tensor-parallel specs ---

    def _bind_param_specs(self) -> Dict[str, Any]:
        """Check ``stage_param_specs`` against every stage's blocks
        (``pipe_tpu``'s structure error), cut this rank's stages' sharded
        leaves to its model block, and return ``{parameter name: spec}``
        over every stage."""
        stage_blocks = getattr(self.module, "stage_blocks", None)
        if stage_blocks is None:
            raise ValueError(
                "stage_param_specs needs a module whose stage_blocks(s) "
                "gives each stage's blocks (a PipelinedTransformer)")
        specs = self.stage_param_specs
        mine = set(self._columns())
        placed = []
        for s in range(self.n_virtual):
            blocks = list(stage_blocks(s))
            params = [param_tree(b) for b in blocks]
            got, want = tree_structure(specs), tree_structure(params)
            if got != want:
                raise ValueError(
                    f"stage_param_specs structure {got} does not match the "
                    f"stacked stage params {want}")
            for blk, spec_tree in zip(blocks, specs):
                local = flat_specs(spec_tree)
                if s % self.n_stages in mine:
                    shard_params(blk, local, self.mesh)
                placed.append((blk, local))
        names = {id(p): n for n, p in self.module.named_parameters()}
        return {names[id(blk.get_parameter(leaf))]: spec
                for blk, local in placed for leaf, spec in local.items()}

    def gather_model_grads(self, grads: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
        """A rank's :meth:`loss_and_grad` gradients with every leaf sharded
        over the model axis gathered over its model line into the whole
        leaf (every rank of the line calls it); unchanged without specs or
        a model axis."""
        if not self._param_specs or self.mesh is None:
            return dict(grads)
        return gather_model_shards(self.mesh, grads, self._param_specs)

    # --- tables ---

    def _raw_tables(self, m: int):
        """The schedule's tables as it gives them: ``(op, mbi, grp)``, grp
        None for a table without groups."""
        tables = self.schedule.op_tables(m, self.n_stages)
        return tables[0], tables[1], (tables[2] if len(tables) > 2
                                      else None)

    def _tables(self, m: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        op, mbi, grp = self._raw_tables(m)
        return op, mbi, (grp if grp is not None else np.zeros_like(op))

    def memory_plan(self, m: int) -> dict:
        """Per-stage buffer counts of the walk: ``activation_slot_plan``
        over the active transport's slot counts (under overlapped transport
        and phase compilation those of the re-timed tables, with the grad
        park), the cycle count and the transport, the phase program's
        segments, and the skip parks' slots, as ``pipe_tpu``'s
        ``memory_plan`` reports them."""
        plan = self._walk_plan(m)
        out = {"cycles": int(plan.op.shape[0]),
               **activation_slot_plan(MemoryPlanInputs(
                   v=self.v, stash_slots=plan.stash_slots,
                   wstash_slots=plan.wstash_slots,
                   checkpoint=self.checkpoint,
                   has_remat_policy=self.remat_policy is not None,
                   split_stage=self.split_stage is not None,
                   overlap=plan.overlap, grad_park_slots=plan.grad_slots)),
               "transport": plan.transport}
        prog = plan.program
        if prog is not None:
            out["phase_segments"] = tuple((g.kind, g.t0, g.t1, g.period)
                                          for g in prog.segments)
            out["phase_unrolled_cycles"] = prog.unrolled_cycles
            out["phase_scan_cycles"] = prog.scan_cycles
        if self.skip_lanes is not None:
            kf, kg = self._skip_tables(m, plan.op, plan.mbi, plan.grp,
                                       overlap=plan.overlap)
            out["skip_lanes"] = len(self.skip_lanes.pairs)
            out["skip_fwd_park_slots"] = sum(kf)
            out["skip_bwd_park_slots"] = sum(kg)
        return out

    def _on_card_mesh(self) -> bool:
        """Whether this walk runs over a mesh of CUDA ranks: where the auto
        settings turn overlapped transport and phase compilation on, as
        ``pipe_tpu`` turns them on for accelerator meshes."""
        return self.mesh is not None and self.mesh.device.type == "cuda"

    def _overlap_enabled(self) -> bool:
        """The ``overlap_transport`` tri-state: always off at one stage
        (there is no boundary transport to shift), else as set, else on for
        a mesh of CUDA ranks only."""
        if self.n_stages <= 1:
            return False
        if self.overlap_transport is not None:
            return bool(self.overlap_transport)
        return self._on_card_mesh()

    def _phase_verdict(self, m: int):
        """Phase-compile this walk's table at ``m`` (cached per m). On
        rejection: count it and, when phase compilation was asked for
        explicitly, warn once naming the compiler's reason."""
        if m not in self._phase_cache:
            op0, mb0, grp0 = self._raw_tables(m)
            verdict = compile_phases(op0, mb0, grp0, m=m, d=self.n_stages,
                                     v=self.v)
            if verdict.accepted:
                get_registry().counter("scheduled.phase.compiled").inc()
            else:
                get_registry().counter("scheduled.phase.rejected").inc()
                if self.phase_compile:
                    warnings.warn(
                        f"phase_compile=True but the phase compiler "
                        f"rejected the {self.schedule.name!r} op table at "
                        f"m={m} ({verdict.reason}); falling back to the "
                        f"interpreted table executor", stacklevel=5)
            self._phase_cache[m] = verdict
        return self._phase_cache[m]

    def _phase_program(self, m: int):
        """The ``phase_compile`` tri-state as an accepted ``PhaseProgram``,
        or None for the interpreted walk (off, one stage, auto off the
        card's meshes, or a table the compiler rejected)."""
        if self.n_stages <= 1 or self.phase_compile is False:
            return None
        if self.phase_compile is None and not self._on_card_mesh():
            return None
        verdict = self._phase_verdict(m)
        return verdict.program if verdict.accepted else None

    def _walk_plan(self, m: int) -> _WalkPlan:
        """The tables and slot counts of a step of ``m`` micro-batches under
        the active transport (cached per m)."""
        plan = self._plans.get(m)
        if plan is not None:
            return plan
        d = self.n_stages
        prog = self._phase_program(m)
        if prog is not None:
            plan = self._overlap_plan(prog.op, prog.mbi, prog.grp, m,
                                      has_grp=self.v > 1,
                                      transport="phase-compiled",
                                      program=prog)
        elif self._overlap_enabled():
            op0, mb0, grp0 = self._raw_tables(m)
            op, mbi, grp = shift_comm_tables(op0, mb0, grp0, m=m, d=d,
                                             v=self.v)
            plan = self._overlap_plan(op, mbi, grp, m,
                                      has_grp=grp0 is not None,
                                      transport="overlapped")
        else:
            op, mbi, grp = self._tables(m)
            plan = _WalkPlan(op, mbi, grp, self.schedule.stash_slots(m, d),
                             0, self.schedule.wstash_slots(m, d),
                             "serialized")
        self._plans[m] = plan
        return plan

    def _overlap_plan(self, op, mbi, grp, m: int, *, has_grp: bool,
                      transport: str, program=None) -> _WalkPlan:
        """Slot counts of hop-2 tables (comm-shifted or phase-aligned), as
        ``pipe_tpu``'s ``_overlap_plans`` derives them: one joint ``Sg`` for
        the arriving stash, the saved graphs and the ``h_last`` park, ``Gg``
        for the grad park, ``Wg`` for the W park of a split table under
        never; then ``verify_shifted_op_tables`` proves the tables and those
        counts."""
        d, v = self.n_stages, self.v
        S = v * d
        t_f, t_b, t_w = _times_by_code(op, mbi, grp, m, d, v)
        read_last = np.maximum(t_f, np.maximum(t_b, t_w))
        wins = [(t_f[:, s - 1] + 1, read_last[:, s]) for s in range(1, S)]
        wins += [(t_f[:, s], read_last[:, s]) for s in range(S)]
        wins += [(t_f[:, S - 1], t_b[:, S - 1])]        # h_last park
        Sg = overlap_joint_capacity(wins, m)
        gw = [(t_b[:, s + 1] + 1, t_b[:, s]) for s in range(S - 1)]
        Gg = overlap_joint_capacity(gw, m) if gw else 1
        has_w = bool((op == WGRAD).any())
        split = has_w and self.checkpoint == "never"
        Wg = (overlap_joint_capacity(
            [(t_b[:, s], t_w[:, s]) for s in range(S)], m) if split else 0)
        verify_shifted_op_tables(
            op, mbi, grp if has_grp else None, m=m, d=d, v=v,
            splits_backward=has_w, stash_slots=Sg, grad_slots=Gg,
            wstash_slots=Wg if split else None)
        return _WalkPlan(op, mbi, grp, Sg, Gg, Wg, transport, program)

    @staticmethod
    def _cycle_codes(plan: _WalkPlan):
        """``(t, code)`` per cycle of the walk: code None reads each
        column's op from the table (serialized and overlapped walks, a phase
        program's ramps); the cycles of a steady-state period carry its
        concrete op code, every rank busy."""
        prog = plan.program
        if prog is None:
            for t in range(plan.op.shape[0]):
                yield t, None
            return
        for seg in prog.segments:
            if seg.kind != "scan":
                for t in range(seg.t0, seg.t1):
                    yield t, None
                continue
            for k in range(seg.iters):
                for j, code in enumerate(seg.codes):
                    yield seg.t0 + k * seg.period + j, code

    def _lane_hops(self) -> Tuple[int, ...]:
        """Hops of each skip lane around the stage ring: ``(dst % d - src %
        d) % d``. Under overlapped transport a lane's value parks ``max(H,
        1)`` cycles after it was made, as ``pipe_tpu``'s relay carries it
        one hop a cycle (a 0-hop lane stays on its rank, one cycle)."""
        d = self.n_stages
        return tuple(((dst % d) - (src % d)) % d
                     for (src, dst) in self.skip_lanes.pairs)

    def _lag(self, kind: str, target: int) -> int:
        """Cycles from making a routed value to parking it under
        overlapped transport: 1 for a boundary or a cotangent, a lane's
        ``max(H, 1)``."""
        if kind in ("h", "g"):
            return 1
        return max(self._lane_hops()[target], 1)

    def _skip_tables(self, m: int, op, mbi, grp, *, fwd_only: bool = False,
                     overlap: bool = False) -> Tuple[List[int], List[int]]:
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
        re-read, no reverse park). ``overlap`` plans the re-timed tables: a
        value parks ``max(H, 1)`` cycles after it was made (H the lane's
        hops) and after that cycle's compute, so its consumer must come
        strictly later. Counterpart of ``pipe_tpu``'s ``_skip_tables``."""
        d, S = self.n_stages, self.n_virtual
        hops = self._lane_hops() if overlap else None
        slack = 1 if overlap else 0            # park after compute: strict
        timing = "relay" if overlap else "direct-hop"
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
        for lane, (src, dst) in enumerate(self.skip_lanes.pairs):
            lag = max(hops[lane], 1) if overlap else 1
            wf, wg = [], []
            for i in range(m):
                arr_f, use_f = fwd_c[i, src] + lag, fwd_c[i, dst]
                if not (0 <= fwd_c[i, src] and arr_f + slack <= use_f):
                    raise ValueError(
                        f"skip lane ({src},{dst}): stash for micro-batch "
                        f"{i} arrives at cycle {arr_f} after its FWD "
                        f"{use_f} — the schedule violates the {timing} "
                        f"timing assumption")
                reread = not fwd_only and self._reruns_at_b(i, m)
                wf.append((arr_f, bwd_c[i, dst] if reread else use_f))
                if fwd_only:
                    continue
                arr_g, use_g = bwd_c[i, dst] + lag, bwd_c[i, src]
                if not (0 <= bwd_c[i, dst] and arr_g + slack <= use_g):
                    raise ValueError(
                        f"skip lane ({src},{dst}): cotangent for "
                        f"micro-batch {i} arrives at cycle {arr_g} after "
                        f"its BWD {use_g} — the schedule violates the "
                        f"{timing} timing assumption")
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
        elif st.gradpark is not None:
            seed_h = st.gradpark.get(s, i, pop=True)
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
        if self.mesh is not None and col != self.mesh.stage:
            st.outbox.setdefault(self.mesh.rank_of(col), []).append(
                (kind, target, i, value))
        elif st.overlap:
            st.pending.append((st.t + self._lag(kind, target), kind, target,
                               i, value))
        else:
            self._deliver(st, kind, target, i, value)

    @staticmethod
    def _deliver(st: _Step, kind: str, target: int, i: int, value) -> None:
        if kind == "g":
            st.gbuf[(i, target)] = value
        elif kind == "h":
            st.arrivals.append((st.stash, target, i, value))
        else:
            park = st.fpark if kind == "f" else st.gpark
            st.arrivals.append((park[target], 0, i, value))

    @staticmethod
    def _park(st: _Step, kind: str, target: int, i: int, value) -> None:
        """Overlapped transport: a value into its ring after its arrival
        cycle's compute (a cotangent into the grad park)."""
        if kind == "g":
            st.gradpark.put(target, i, value)
        elif kind == "h":
            st.stash.put(target, i, _Entry(value))
        else:
            park = st.fpark if kind == "f" else st.gpark
            park[target].put(0, i, value)

    def _park_due(self, st: _Step, t: int) -> None:
        """End of cycle ``t`` under overlapped transport: park every value
        due now, in message order."""
        due = [e for e in st.pending if e[0] <= t]
        if any(e[0] < t for e in due):
            raise RuntimeError("overlapped transport: a value missed its "
                               "park cycle")
        st.pending = [e for e in st.pending if e[0] > t]
        for _, kind, target, i, value in sorted(
                due, key=lambda e: _item_key(e[1:])):
            self._park(st, kind, target, i, value)

    def _expected(self, t: int, op, mbi, grp, fwd_only: bool = False
                  ) -> Dict[int, list]:
        """What each other rank routes to this one in cycle ``t``:
        ``{rank: [(kind, target, i)]}`` in message order, read from the
        tables as both ends read them (``fwd_only``: the FWD ops alone, as
        :meth:`forward` runs them)."""
        d, me, S = self.n_stages, self.mesh.stage, self.n_virtual
        pairs = self.skip_lanes.pairs if self.skip_lanes is not None else ()
        out: Dict[int, list] = {}
        for q in range(d):
            if q == me:
                continue
            code, i = int(op[t, q]), int(mbi[t, q])
            s = int(grp[t, q]) * d + q
            keys = []
            if code == FWD:
                if s < S - 1 and (s + 1) % d == me:
                    keys.append(("h", s + 1, i))
                keys += [("f", l, i) for l, (src, dst) in enumerate(pairs)
                         if src == s and dst % d == me]
            elif code == BWD and not fwd_only:
                if s > 0 and (s - 1) % d == me:
                    keys.append(("g", s - 1, i))
                keys += [("r", l, i) for l, (src, dst) in enumerate(pairs)
                         if dst == s and src % d == me]
            if keys:
                out[self.mesh.rank_of(q)] = sorted(keys, key=_item_key)
        return out

    def _learn_signature(self, x, w) -> None:
        """Forget the learned boundary layouts when the batch's shapes or
        dtypes change (every rank sees the same global batch)."""
        leaves = list(x.values()) if isinstance(x, dict) else [x]
        sig = tuple((tuple(t.shape), t.dtype) for t in (*leaves, w))
        if sig != self._signature:
            self._signature = sig
            self._layouts.clear()
            self._sent.clear()

    def _send(self, st: _Step, t: int, plan: _WalkPlan):
        """Start of cycle ``t`` on a mesh under overlapped transport: what
        this rank routed in cycle ``t - 1`` goes to each peer as one message
        of packed words, and a receive is posted for each peer that routed
        to this rank then, both read from the tables. A pair's first
        crossing of a boundary goes through :meth:`Mesh.exchange`, its
        layout in the message (then learned on both ends); the rest is one
        :meth:`Mesh.post` round whose lengths both ends know."""
        if self.mesh is None:
            return None
        outbox, st.outbox = st.outbox, {}
        expect = (self._expected(t - 1, plan.op, plan.mbi, plan.grp)
                  if t > 0 else {})
        sends = {peer: sorted(items, key=_item_key)
                 for peer, items in outbox.items()}
        slow_out = {peer: items for peer, items in sends.items()
                    if any((k, g) not in self._sent for k, g, _, _ in items)}
        slow_in = [peer for peer, keys in expect.items()
                   if any((k, g) not in self._layouts for k, g, _ in keys)]
        if slow_out or slow_in:
            got = self.mesh.exchange(
                {peer: _encode(items, self.device)
                 for peer, items in slow_out.items()},
                slow_in, tag=4 * t)
            for items in slow_out.values():
                for kind, target, _, value in items:
                    self._sent[(kind, target)] = _layout_of(value)
            for peer in sorted(got):
                items = _decode(got[peer])
                if [it[:3] for it in items] != expect[peer]:
                    raise RuntimeError(
                        f"overlapped transport: rank {peer} sent "
                        f"{[it[:3] for it in items]} at cycle {t - 1}, the "
                        f"tables say {expect[peer]}")
                for kind, target, i, value in items:
                    self._layouts[(kind, target)] = _layout_of(value)
                    st.pending.append((t - 1 + self._lag(kind, target),
                                       kind, target, i, value))
        fast_out = {}
        for peer, items in sends.items():
            if peer in slow_out:
                continue
            for kind, target, _, value in items:
                if _layout_of(value) != self._sent[(kind, target)]:
                    raise RuntimeError(
                        f"overlapped transport: the layout of {kind!r} for "
                        f"{target} changed within one batch signature")
            fast_out[peer] = pack_words(
                [v for it in items for v in _leaves(it[3])
                 if v is not None]).to(self.device)
        fast_in = {peer: keys for peer, keys in expect.items()
                   if peer not in slow_in}
        words = {peer: sum(packed_words(_specs(self._layouts[(k, g)]))
                           for k, g, _ in keys)
                 for peer, keys in fast_in.items()}
        return (self.mesh.post(fast_out, words, tag=4 * t + 2), fast_in,
                t - 1)

    def _land(self, st: _Step, handle) -> None:
        """End of a cycle's compute under overlapped transport: wait for
        what :meth:`_send` started and put each received value on its way
        to its park."""
        if handle is None:
            return
        posted, keys, t_made = handle
        got = self.mesh.wait(posted)
        for peer in sorted(got):
            values = _unpack_items(got[peer], keys[peer], self._layouts)
            for (kind, target, i), value in zip(keys[peer], values):
                st.pending.append((t_made + self._lag(kind, target), kind,
                                   target, i, value))

    def _exchange(self, st: _Step, t: int, op, mbi, grp,
                  fwd_only: bool = False) -> None:
        """End of cycle ``t`` on a mesh: one packed message to each peer
        this rank wrote for, one from each peer that wrote for it."""
        if self.mesh is None:
            return
        sends = {peer: _encode(items, self.device)
                 for peer, items in st.outbox.items()}
        st.outbox = {}
        got = self.mesh.exchange(
            sends, list(self._expected(t, op, mbi, grp, fwd_only)),
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
        ctx's ``(offset, total)``, and with ``context_axis`` this context
        rank's block of dim ``context_dim`` of each leaf that has it;
        unchanged without one."""
        self._rows = None
        if self.mesh is None:
            return x, w
        if self.mesh.n_data > 1:
            from ..runtime.distributed import host_local_batch, rows_of
            total = _leading_rows(x)
            self._rows = tuple(rows_of(self.mesh, total))
            x = host_local_batch(self.mesh, x)
            w = None if w is None else host_local_batch(self.mesh, w)
        if self.context_axis:
            x = _context_block(x, self.mesh, self.context_dim)
        return x, w

    def _grad_axes(self):
        """The axes gradients sum over: data, and context with the axis."""
        return ("data", "context") if self.context_axis else "data"

    def _reduce_grads(self, params: List[torch.Tensor]) -> None:
        """Sum the gradients over the data group (the stage's ``(data,
        context)`` plane with ``context_axis``): one flat buffer per dtype,
        one all-reduce each."""
        if self.mesh is None or self.mesh.group_size(self._grad_axes()) == 1:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.mesh.all_reduce(flat, self._grad_axes())
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

    def _parks(self, m: int, op, mbi, grp, *, fwd_only: bool = False,
               overlap: bool = False):
        if self.skip_lanes is None:
            return [], []
        kf, kg = self._skip_tables(m, op, mbi, grp, fwd_only=fwd_only,
                                   overlap=overlap)
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
        plan = self._walk_plan(m)
        op, mbi, grp = plan.op, plan.mbi, plan.grp
        d, S = self.n_stages, self.n_virtual
        reg = get_registry()
        reg.gauge("scheduled.cycles").set(int(op.shape[0]))
        reg.gauge("scheduled.transport.overlap").set(int(plan.overlap))
        reg.gauge("scheduled.phase.active").set(int(plan.program is not None))
        if plan.program is not None:
            reg.gauge("scheduled.phase.scan_cycles").set(
                plan.program.scan_cycles)
            reg.gauge("scheduled.phase.unrolled_cycles").set(
                plan.program.unrolled_cycles)
        split = bool((op == WGRAD).any()) and self.checkpoint == "never"
        Sg = plan.stash_slots
        fpark, gpark = self._parks(m, op, mbi, grp, overlap=plan.overlap)
        local = [p for _, p in self._local_params() if p.requires_grad]
        st = _Step(
            m=m, seed=seed, split=split, inv_wsum=inv_wsum,
            stash=_Ring(S, Sg, "stash"), h_last=_Ring(1, Sg, "h_last"),
            wstash=_Ring(S, plan.wstash_slots if split else 1, "wstash"),
            params=local, loss=torch.zeros((), device=self.device),
            fpark=fpark, gpark=gpark, overlap=plan.overlap,
            gradpark=(_Ring(S, plan.grad_slots, "grad park")
                      if plan.overlap else None))
        if plan.overlap:
            self._learn_signature(x, w)
        run = {FWD: self._fwd_op, BWD: self._bwd_op, WGRAD: self._w_op}
        for t, concrete in self._cycle_codes(plan):
            st.t = t
            handle = self._send(st, t, plan) if plan.overlap else None
            for p in self._columns():
                code = int(op[t, p]) if concrete is None else concrete
                if code == IDLE or (code == WGRAD and not split):
                    continue
                i, s = int(mbi[t, p]), int(grp[t, p]) * d + p
                with torch.profiler.record_function(
                        f"table:{'FBW'[code - 1]}{i}-stage{s}"):
                    run[code](st, i, s, _index(x, i), w[i])
            if plan.overlap:
                self._land(st, handle)
                self._park_due(st, t)
                continue
            self._exchange(st, t, op, mbi, grp)
            for ring, s, i, h in st.arrivals:
                ring.put(s, i, _Entry(h) if ring is st.stash else h)
            st.arrivals.clear()
        rings = (st.stash, *fpark, *gpark) + ((st.gradpark,) if plan.overlap
                                               else ())
        if (st.gbuf or st.outbox or st.pending
                or not all(r.empty() for r in rings)):
            raise RuntimeError(
                f"schedule {self.schedule.name!r} left state unconsumed at "
                f"m={m}: its table misses a BWD or WGRAD op")
        self.last_slots = {"stash": st.stash.peak, "h_last": st.h_last.peak,
                           "wstash": st.wstash.peak if split else 0}
        if plan.overlap:
            self.last_slots["grad_park"] = st.gradpark.peak
        if self.skip_lanes is not None:
            self.last_slots["skip_fwd_park"] = sum(r.peak for r in fpark)
            self.last_slots["skip_bwd_park"] = sum(r.peak for r in gpark)
        self._reduce_grads(local)
        grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for name, p in self._local_params()}
        total = st.loss.detach()
        if self.mesh is not None:
            self.mesh.all_reduce(total, "world")
            # each context rank and each model rank holds a copy
            copies = ((self.mesh.context_size if self.context_axis else 1)
                      * self.mesh.model_size)
            if copies > 1:
                total = total / copies
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
            self._exchange(st, t, op, mbi, grp, fwd_only=True)
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
