"""The user API: ``Pipe`` wraps a ``Sequential`` and runs it pipelined.

Counterpart of ``pipe_tpu/pipe.py``:

* ``Pipe(module, chunks, checkpoint, ...)`` with the same fail-fast
  validation (chunks type and sign, checkpoint mode, ``Sequential`` only,
  duplicate children);
* ``split_balance`` partitioning into per-stage sub-``Sequential``s;
* the container protocol ``__len__``/``__getitem__``/``__iter__``;
* ``forward(*inputs, train=False, seed=None)`` = check, scatter, run the
  schedule's wavefront (``schedule.cycles``), gather;
* ``@skippable`` layers: ``verify_skippables`` and the static
  ``skip_layout`` at construction, a skip tracker threaded through the
  emulator's tasks;
* ``remat_policy``: a ``core.remat.checkpoint_policies`` member (or its
  name) for the micro-batches the checkpoint mode recomputes, set at
  construction or per call (``forward(..., remat_policy=)``, which wins);
  ``HeteroScheduledPipeline(..., remat_policy=pipe.remat_policy)`` takes it
  for the tables;
* ``plan=``: a planner ``Plan`` (or the path of a saved one,
  ``core/planner.py``) fixes chunks, checkpoint, schedule and balance, with
  ``pipe_tpu``'s conflict errors. A plan with ``split_stage`` set prescribes
  the structural B/W split: ``Pipe`` warns, with ``pipe_tpu``'s words, and
  its tables run the stored-graph split (``pipe_tpu``'s runs its stored-vjp
  one); the ``Trainer`` and ``ScheduledPipeline(split_stage=)`` run the
  structural split;
* ``deferred_batch_norm=True``: plain ``BatchNorm`` layers become
  ``DeferredBatchNorm``, and a train forward commits one running-stats
  update per mini-batch, in place on their buffers (``pipe_tpu`` returns
  ``(out, new_params)``; here the weights live in the modules).

``Pipe`` is an ``nn.Module``: the partitions (and their weights) are its
submodules, on ``device``. Every registered schedule is accepted, as by
``pipe_tpu``'s ``Pipe`` without a mesh; the table-only schedules
(``interleaved-1f1b``, ``zb-h1``, ``zb-h2``) raise from ``cycles`` at the
first forward, with ``pipe_tpu``'s message. Training through the op tables
is ``parallel/scheduled.py`` (and ``parallel/hetero_scheduled.py`` for a
``Pipe``'s partitions).

``mesh=`` (a ``parallel.mesh.Mesh``, one process per position) runs the
partitions over the ranks: this rank keeps its partitions (virtual stages
``g * d + p`` of its stage ``p``) on ``mesh.device`` and the others on the
``meta`` device. The forward (``__call__``) is the GPipe wavefront over
the ranks (``parallel/hetero.py``; the op tables with BWD masked for an
interleaved schedule) and returns the whole batch's outputs on every rank;
:meth:`Pipe.loss_and_grad` trains through the schedule's tables
(``HeteroScheduledPipeline`` over the mesh), returning this rank's packed
gradient rows; :meth:`Pipe.shard_params`, :meth:`Pipe.unshard_params`,
:meth:`Pipe.init_sharded` and :meth:`Pipe.memory_plan` are ``pipe_tpu``'s.
A train forward over a mesh has no backward across ranks: training goes
through ``loss_and_grad``.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import torch
from torch import nn

from .core import microbatch as mb
from .core.partition import (BalanceError, Stage, fold_seed, split_balance,
                             verify_splitting, verify_stages)
from .core.remat import resolve_policy, validate_mode
from .core.schedule import Schedule, get_schedule
from .extras.norm import (DeferredBatchNorm, commit_batchnorm_stats,
                          convert_deferred_batch_norm)
from .extras.skip import SkipTracker, inspect_skip_layout, verify_skippables
from .ops.layers import Sequential
from .parallel import emulator
from .utils.platform import DEFAULT_DEVICE, resolve_device

__all__ = ["Pipe", "NoChunk", "BalanceError"]

NoChunk = mb.NoChunk


class Pipe(nn.Module):
    """Synchronous pipeline over a ``Sequential`` of layers, run by the
    serial clock-cycle emulator on one device."""

    def __init__(self,
                 module: Sequential,
                 chunks: int = 1,
                 checkpoint: str = "except_last",
                 *,
                 n_stages: Optional[int] = None,
                 balance: Optional[Sequence[int]] = None,
                 schedule: str = "gpipe",
                 mesh=None,
                 plan=None,
                 deferred_batch_norm: bool = False,
                 remat_policy=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        # --- auto-planner front door (core/planner.py): the plan fixes
        # chunks/schedule/balance/n_stages and the checkpoint mode it was
        # scored under; config it already decides cannot also be passed.
        if plan is not None:
            from .core.planner import Plan
            if isinstance(plan, str):
                plan = Plan.load(plan)
            if (chunks != 1 or balance is not None or n_stages is not None
                    or schedule != "gpipe"):
                raise ValueError(
                    "Pipe(plan=...) already fixes chunks, schedule, "
                    "balance and n_stages — drop the hand-passed values "
                    "(or drop the plan)")
            if checkpoint != "except_last" \
                    and checkpoint != plan.checkpoint:
                raise ValueError(
                    f"checkpoint={checkpoint!r} conflicts with the plan's "
                    f"{plan.checkpoint!r} (the plan was scored under its "
                    f"own checkpoint mode)")
            chunks = plan.m
            checkpoint = plan.checkpoint
            schedule = plan.schedule_obj()
            balance = list(plan.balance)
            n_stages = len(balance)
            if plan.split_stage:
                warnings.warn(
                    "this plan prescribes the structural B/W split "
                    "(split_stage=True); the Pipe front door's "
                    "heterogeneous executor runs split-backward tables "
                    "via the stored-vjp path instead — drive "
                    "ScheduledPipeline (or Trainer) with the plan to "
                    "engage the split", stacklevel=2)
        self.plan = plan
        # --- fail-fast validation ---
        if not isinstance(chunks, int) or isinstance(chunks, bool):
            raise TypeError("chunks must be an integer")
        if chunks <= 0:
            raise ValueError("number of chunks must be positive")
        validate_mode(checkpoint)
        self.remat_policy = resolve_policy(remat_policy)
        if not isinstance(module, Sequential):
            raise TypeError("module must be a pipe_tpu_torch Sequential")
        seen = set()
        for layer in module:
            if id(layer) in seen:
                raise ValueError("module with duplicate children is not supported")
            seen.add(id(layer))
        sched_obj = (get_schedule(schedule) if isinstance(schedule, str)
                     else schedule)
        if deferred_batch_norm and getattr(sched_obj, "splits_backward",
                                           False):
            raise NotImplementedError(
                "deferred_batch_norm does not compose with "
                "split-backward schedules (zb-h1): the W op's vjp seed "
                "has no stats slot — pick 'gpipe' or '1f1b'")
        if deferred_batch_norm:
            module = convert_deferred_batch_norm(module, chunks)
        self.deferred_batch_norm = deferred_batch_norm

        if mesh is not None:
            from .parallel.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(
                    f"mesh must be a pipe_tpu_torch Mesh (parallel.mesh."
                    f"make_mesh over an initialized world), got "
                    f"{type(mesh).__name__}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.chunks = chunks
        self.checkpoint = checkpoint
        if balance is not None and n_stages is None:
            n_stages = len(balance)
        if n_stages is None:
            n_stages = 1
        self.balance = split_balance(len(module), n_stages, balance)
        self.n_stages = n_stages

        parts: List[Sequential] = []
        offset = 0
        for width in self.balance:
            parts.append(module[offset:offset + width])
            offset += width
        self.partitions = nn.ModuleList(parts)
        verify_stages(self.partitions)
        verify_splitting(self.partitions)
        self._schedule: Schedule = sched_obj
        if mesh is None:
            self.partitions.to(self.device)

        # Skip wiring: the fail-fast check and the static stash->pop layout.
        verify_skippables(module)
        self.skip_layout = inspect_skip_layout(self.partitions)
        self._has_bn = any(isinstance(l, DeferredBatchNorm) for l in self)
        self._needs_tracker = self.skip_layout.num_skips > 0 or self._has_bn
        self._executor = self._train_executor = None
        if mesh is not None:
            self._build_mesh_executors(remat_policy)

    # --- over a mesh ---

    def _build_mesh_executors(self, remat_policy) -> None:
        from .parallel.hetero_scheduled import HeteroScheduledPipeline
        from .parallel.mesh import localize

        mesh, v = self.mesh, self._schedule.v
        if self.n_stages != v * mesh.n_stages:
            raise ValueError(
                f"{self.n_stages} partitions at interleave {v} need "
                f"{self.n_stages // v if self.n_stages % v == 0 else '?'} "
                f"stage ranks; the mesh has {mesh.n_stages}")
        local = [s for s in range(self.n_stages)
                 if s % mesh.n_stages == mesh.stage]
        localize(self.partitions, [self.partitions[s] for s in local],
                 self.device)
        self._train_executor = HeteroScheduledPipeline(
            self.partitions, self.skip_layout, self.chunks, self.checkpoint,
            self._schedule, remat_policy=remat_policy, mesh=mesh)
        if v == 1:
            from .parallel.hetero import HeteroSpmdPipeline
            self._executor = HeteroSpmdPipeline(
                self.partitions, self.skip_layout, self.chunks,
                self.checkpoint, mesh=mesh, remat_policy=remat_policy)

    def _need_mesh(self, what: str):
        if self._train_executor is None:
            raise ValueError(f"{what} requires Pipe(mesh=...)")
        return self._train_executor

    def shard_params(self, state_dicts=None):
        """This rank's packed rows ``{dtype: [v, cap]}`` of its partitions'
        parameters (``pipe_tpu``'s stage-sharded layout,
        ``core/packing.py``). ``state_dicts``: one per partition (each
        partition's ``state_dict`` names), of which this rank loads its
        own first. Requires ``mesh=``."""
        return self._need_mesh("shard_params").shard_params(state_dicts)

    def unshard_params(self, packed):
        """Every partition's ``{name: numpy array}`` from the ranks' packed
        rows (parameters or gradients), on every rank of this pipeline.
        Requires ``mesh=``."""
        return self._need_mesh("unshard_params").unshard_params(packed)

    unshard_grads = unshard_params

    def init_sharded(self, seed: int):
        """Draw this rank's partitions afresh, partition ``j`` from
        ``fold_seed(seed, j)`` (``pipe_tpu`` folds the stage into its key),
        each layer by its own initializer, on the rank's device only; returns
        :meth:`shard_params`. Requires ``mesh=``."""
        ex = self._need_mesh("init_sharded")
        for s in ex.local_stages():
            gen = torch.Generator(device=self.device).manual_seed(
                fold_seed(seed, s))
            init_weights(self.partitions[s], gen)
        return ex.shard_params()

    def loss_and_grad(self, *inputs, targets=None, loss_fn,
                      seed: Optional[int] = 0):
        """One pipelined training step through the schedule's tables over
        the mesh: ``(loss, grads)``, the loss the whole batch's on every
        rank and ``grads`` this rank's packed rows (:meth:`shard_params`'
        layout) summed over the data group; the ``.grad`` of this rank's
        parameters hold them too. ``loss_fn(*outputs, targets_mb) ->
        [rows]``. A deferred-BatchNorm model commits the whole batch's
        stats in place (``pipe_tpu`` returns ``new_params`` instead).
        Requires ``mesh=``."""
        return self._need_mesh("loss_and_grad").loss_and_grad(
            *inputs, targets=targets, loss_fn=loss_fn, seed=seed)

    def memory_plan(self, chunks: Optional[int] = None) -> dict:
        """The training executor's per-stage buffer counts. Requires
        ``mesh=``."""
        return self._need_mesh("memory_plan").memory_plan(chunks)

    # --- container protocol ---

    def __len__(self) -> int:
        """Total number of layers across all partitions."""
        return sum(len(p) for p in self.partitions)

    def __getitem__(self, index: int) -> nn.Module:
        layers: List[nn.Module] = []
        for p in self.partitions:
            layers.extend(p)
        return layers[index]

    def __iter__(self):
        for p in self.partitions:
            yield from p

    # --- forward ---

    def forward(self, *inputs, train: bool = False, seed: Optional[int] = None,
                remat_policy=None):
        """Scatter the batch into ``chunks`` micro-batches, run the
        schedule's wavefront over the stages, gather. ``seed`` drives
        dropout when ``train``; checkpointing engages only in training,
        selectively under ``remat_policy`` (this call's, else the
        ``Pipe``'s). A train forward commits the deferred-BatchNorm stats of
        the whole mini-batch once, in place."""
        if self._train_executor is not None:
            if self._executor is not None:
                return self._executor(*inputs, seed=seed, train=train)
            if remat_policy is not None:
                raise NotImplementedError(
                    "the interleaved (v > 1) forward executor does not "
                    "apply remat_policy — differentiate via loss_and_grad "
                    "(the training path owns checkpointing)")
            return self._train_executor.forward(*inputs, seed=seed,
                                                train=train)
        if remat_policy is None:
            remat_policy = self.remat_policy
        mb.check(*inputs)
        batches = mb.scatter(inputs, self.chunks)
        stages = [Stage(p, name=f"stage{j}")
                  for j, p in enumerate(self.partitions)]
        tracker = (SkipTracker(self.skip_layout) if self._needs_tracker
                   else None)
        batches = emulator.run(stages, batches, schedule=self._schedule,
                               checkpoint=self.checkpoint, train=train,
                               seed=seed, remat_policy=remat_policy,
                               skip_tracker=tracker)
        out = mb.gather(batches)
        if self._has_bn and train:
            commit_batchnorm_stats(self.partitions, tracker.accum)
        return out


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw ``module``'s weights afresh from ``generator``, in place, each
    layer by the rule its constructor uses: ``Linear`` uniform in
    ``±1/sqrt(in)`` (attention biases then zero), ``Embedding`` N(0, 1),
    ``LayerNorm`` and ``BatchNorm`` ones and zeros (running stats reset)."""
    import math

    from .extras.norm import BatchNorm
    from .ops.layers import Embedding, LayerNorm, Linear, MultiHeadAttention

    with torch.no_grad():
        if isinstance(module, Linear):
            bound = 1.0 / math.sqrt(module.in_features)
            for p in (module.weight, module.bias):
                if p is not None:
                    p.uniform_(-bound, bound, generator=generator)
        elif isinstance(module, MultiHeadAttention):
            for lin in (module.wq, module.wk, module.wv, module.wo):
                init_weights(lin, generator)
                lin.bias.zero_()
        elif isinstance(module, Embedding):
            module.weight.normal_(generator=generator)
        elif isinstance(module, (LayerNorm, BatchNorm)):
            for p in module.parameters():
                p.fill_(1.0 if p is getattr(module, "weight", None)
                        or p is getattr(module, "scale", None) else 0.0)
            if isinstance(module, BatchNorm):
                module.mean.zero_()
                module.var.fill_(1.0)
        else:
            own = [n for n, p in module._parameters.items() if p is not None]
            if own:
                raise TypeError(f"no initializer known for "
                                f"{type(module).__name__} ({own})")
            for child in module.children():
                init_weights(child, generator)
