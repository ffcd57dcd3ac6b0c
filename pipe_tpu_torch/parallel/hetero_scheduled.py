"""A ``Pipe``'s partitions trained through the schedule tables on one device.

Counterpart of ``pipe_tpu/parallel/hetero_scheduled.py``'s
``HeteroScheduledPipeline`` (its ``loss_and_grad`` and ``forward``), with
the mesh's stage axis replaced by the partitions on one device, as
``parallel/scheduled.py`` replaces it for ``ScheduledPipeline``. On one
device almost all of the JAX class falls away: the packed per-dtype
carriers, the ``lax.switch`` over stage branches and the stage-sharded
param rows exist to make stages uniform across a mesh. What is left:

* virtual stage ``s`` runs ``partitions[s]`` on the boundary values (a
  tuple; stage 0 gets the micro-batch's tensors, with the non-tensor and
  ``NoChunk`` inputs at their positions), under a local skip tracker fed
  with its pops (JAX's branch, without the carrier);
* the cross-stage pairs of the skip layout are the executor's skip lanes
  (a same-stage pair stays inside the stage, as ``SkipLayout.stashes_of``
  says), and the ``DeferredBatchNorm`` layers' sums its stat lanes;
* ``post_fn`` is the user's ``loss_fn(*outputs, targets_mb) -> [rows]``.

Dropout seeds fold as the emulator's: stage ``s`` of micro-batch ``i`` gets
``ctx.fold(i, s)`` of the step's seed, so one seed gives the ``Pipe``
emulator's masks under every table.

``remat_policy`` goes to the tables as ``pipe_tpu``'s
``_train_remat_policy`` passes it: dropped under ``never``, where every
micro-batch keeps its graph and the policy would be inert.

Dropped against ``pipe_tpu``: the packing, the stage-sharded rows
(``shard_params``), the uniform-partition fast path, overlapped transport
and phase compilation (ROADMAP.md: A.8).
``Pipe(mesh=...)``, which owns this executor in ``pipe_tpu``, still raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core import microbatch as mb
from ..core.partition import StageCtx
from ..core.remat import resolve_policy
from ..core.schedule import Schedule, get_schedule
from ..extras.norm import (BatchNorm, DeferredBatchNorm,
                           commit_batchnorm_stats)
from ..extras.skip import SkipTracker
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .scheduled import ScheduledPipeline, SkipLanes

__all__ = ["HeteroScheduledPipeline"]


class HeteroScheduledPipeline:
    """Training executor running ``Pipe`` partitions through op tables.

    Args:
      partitions: one ``Sequential`` per virtual stage (``v * n_stages`` of
        them for an interleaved table), e.g. ``Pipe.partitions``.
      skip_layout: ``inspect_skip_layout(partitions)`` (``Pipe.skip_layout``).
      chunks: micro-batches per step.
      checkpoint: ``always | except_last | never``, exact per micro-batch.
      schedule: a registered name or a ``Schedule`` with ``op_tables``.
      device: where the step runs (the card unless ``"cpu"`` is asked for).
      remat_policy: a ``core.remat.checkpoint_policies`` member or its name
        (``Pipe.remat_policy``), for the recompute micro-batches.
    """

    def __init__(self, partitions: Sequence[nn.Module], skip_layout,
                 chunks: int, checkpoint: str = "except_last",
                 schedule: Any = "1f1b", device=DEFAULT_DEVICE,
                 remat_policy=None):
        self.schedule: Schedule = (get_schedule(schedule)
                                   if isinstance(schedule, str) else schedule)
        self.v = self.schedule.v
        self.S = len(partitions)
        if self.S % self.v:
            raise ValueError(
                f"{self.S} partitions for schedule {self.schedule.name!r} "
                f"(needs v*d = a multiple of {self.v})")
        self.d = self.S // self.v
        self.partitions = list(partitions)
        self.module = nn.ModuleList(self.partitions)
        self.layout = skip_layout
        self.chunks = chunks
        self.checkpoint = checkpoint
        self.remat_policy = resolve_policy(remat_policy)
        self.device = resolve_device(device)
        # stable lane order for cross-stage skips
        self.lane_keys: List[Tuple[Any, str, int, int]] = []
        if skip_layout is not None:
            for (src, dst), names in skip_layout.by_src_dst:
                if src != dst:
                    for ns, name in names:
                        self.lane_keys.append((ns, name, src, dst))
        self.lane_pairs = tuple((src, dst)
                                for _, _, src, dst in self.lane_keys)
        layers = [l for part in self.partitions for l in part]
        self.has_bn = any(isinstance(l, DeferredBatchNorm) for l in layers)
        self.has_batch_stats = any(isinstance(l, BatchNorm) for l in layers)
        # the executor the step runs, built once: its bodies read the
        # per-call state below
        self._call: Dict[str, Any] = {}
        self._exec = ScheduledPipeline(
            self._stage_fn, self._pre_fn, self._post_fn, n_stages=self.d,
            module=self.module, checkpoint=checkpoint,
            schedule=self.schedule, device=self.device,
            # pipe_tpu's _train_remat_policy: inert under never, dropped
            remat_policy=(self.remat_policy if checkpoint != "never"
                          else None),
            skip_lanes=(SkipLanes(self.lane_pairs, ())
                        if self.lane_pairs else None),
            stat_spec="deferred_stats" if self.has_bn else None)

    # --- what the tables imply ---

    def memory_plan(self, m: Optional[int] = None) -> dict:
        """The table walk's buffer counts, skip parks included."""
        return self._exec.memory_plan(m if m is not None else self.chunks)

    @property
    def last_slots(self) -> Dict[str, int]:
        """Peak slots of the last step's rings and skip parks."""
        return self._exec.last_slots

    def stage_passes(self, m: Optional[int] = None) -> Dict[str, int]:
        """Stage-body passes of one step (``ScheduledPipeline.stage_passes``)."""
        return self._exec.stage_passes(m if m is not None else self.chunks)

    # --- the executor's bodies ---

    def _pre_fn(self, x_mb, ctx):
        return tuple(x_mb[f"in{p}"] for p in self._call["dyn_pos"])

    def _stage_fn(self, s: int, h, ctx: StageCtx, pops=None):
        call = self._call
        vals: List[Any] = list(h)
        if s == 0:
            it = iter(vals)
            vals = [call["closed"][p] if p in call["closed"] else next(it)
                    for p in range(call["n_inputs"])]
        seed = call["seed"]
        ctx = StageCtx(seed=seed, train=ctx.train, microbatch=ctx.microbatch,
                       stage=s).fold(ctx.microbatch, s)
        part = self.partitions[s]
        if not self.lane_keys and not self.has_bn:
            return self._as_tuple(part(*vals, ctx=ctx))
        local = SkipTracker(self.layout)
        for l, (ns, name, src, dst) in enumerate(self.lane_keys):
            if dst == s:
                local.save(ctx.microbatch, ns, name, pops[l])
        with local.scope(ctx.microbatch, s):
            out = self._as_tuple(part(*vals, ctx=ctx))
        ret: List[Any] = [out]
        if self.lane_keys:
            ret.append(tuple(
                local.load(ctx.microbatch, ns, name) if src == s else None
                for ns, name, src, dst in self.lane_keys))
        if self.has_bn:
            ret.append(dict(local.accum))
        return tuple(ret)

    def _post_fn(self, h, x_mb, ctx):
        args = list(h)
        if "tgt" in x_mb:
            args.append(x_mb["tgt"])
        per_row = self._call["loss_fn"](*args)
        if per_row.dim() != 1:
            raise ValueError(
                f"loss_fn must return per-row losses [rows]; got "
                f"shape {tuple(per_row.shape)}")
        return per_row

    @staticmethod
    def _as_tuple(out) -> tuple:
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    # --- lowering shared by forward and loss_and_grad ---

    def _lower(self, inputs, *, check_batch_stats: bool):
        """Classify and scatter the inputs: ``(x, true_rows)`` with ``x``
        the executor's dict of stacked tensors, and the per-call state."""
        mb.check(*inputs)
        closed, dyn = {}, {}
        for p, x in enumerate(inputs):
            if isinstance(x, mb.NoChunk):
                closed[p] = x.value
            elif mb.is_array(x):
                dyn[f"in{p}"] = x.to(self.device)
            else:
                closed[p] = x
        if not dyn:
            raise TypeError("the executor needs at least one array input")
        stacked, true_rows = mb.stack_scatter(dyn, self.chunks)
        if check_batch_stats and self.has_batch_stats \
                and true_rows % self.chunks:
            raise ValueError(
                f"BatchNorm needs the batch ({true_rows} rows) to divide "
                f"evenly into chunks*data ({self.chunks}*1): padded "
                "rows would contaminate the batch statistics")
        self._call.update(closed=closed, n_inputs=len(inputs),
                          dyn_pos=[p for p in range(len(inputs))
                                   if p not in closed])
        return stacked, true_rows

    def loss_and_grad(self, *inputs, targets: Any = None,
                      loss_fn: Callable, seed: Optional[int] = 0):
        """One pipelined training step: ``(loss, grads)``.

        ``loss_fn(*outputs, targets_mb) -> [rows]`` maps one micro-batch's
        final-partition outputs (what ``Pipe.forward`` returns) plus the
        matching micro-batch of ``targets`` (a tensor) to per-row losses;
        the loss is their mean over the real rows (padding rows weigh 0).
        Without ``targets``, ``loss_fn(*outputs)``. Gradients accumulate
        into ``.grad`` (zero them first); ``grads`` is ``{name: grad}`` over
        ``self.module`` (the partitions). A deferred-BatchNorm model's
        running stats are committed once, in place. ``seed`` drives dropout
        (None: none)."""
        x, true_rows = self._lower(inputs, check_batch_stats=True)
        w = mb.valid_row_mask(x, true_rows)
        if targets is not None:
            tgt, t_rows = mb.stack_scatter(targets.to(self.device),
                                           self.chunks)
            if t_rows != true_rows:
                raise ValueError(
                    f"targets batch {t_rows} != inputs batch {true_rows}")
            x["tgt"] = tgt
        self._call.update(seed=seed, loss_fn=loss_fn)
        try:
            res = self._exec.loss_and_grad(x, w, seed=None)
        finally:
            self._call.clear()
        if not self.has_bn:
            return res
        loss, grads, stats = res
        commit_batchnorm_stats(self.partitions, stats)
        return loss, grads

    def forward(self, *inputs, seed: Optional[int] = None,
                train: bool = False):
        """Forward outputs through the op tables with BWD rows masked to
        IDLE: the gathered final-partition outputs (a tensor, or a tuple
        for a multi-value boundary), as ``Pipe.forward`` returns them. A
        train forward of a deferred-BatchNorm model commits its stats once,
        in place. Runs under the caller's grad mode."""
        x, true_rows = self._lower(inputs, check_batch_stats=train)
        self._call.update(seed=seed)
        try:
            res = self._exec.forward(x, seed=None, train=train)
        finally:
            self._call.clear()
        outs, stats = res if self.has_bn else (res, None)
        if stats is not None and train:
            commit_batchnorm_stats(self.partitions, stats)
        gathered = tuple(o.reshape((-1,) + tuple(o.shape[2:]))[:true_rows]
                         for o in outs)
        return gathered if len(gathered) > 1 else gathered[0]
