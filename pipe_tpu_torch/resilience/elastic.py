"""Elastic degraded-mode training: survive stage loss, re-plan, resume.

Counterpart of ``pipe_tpu/resilience/elastic.py``, the top rung of the
recovery ladder: skip-step drops one poisoned update, rewind restores a
known-good snapshot, and this module survives the fault class neither can,
a pipeline stage that dies and stays dead. Three cooperating pieces:

* :class:`BuddyStore` -- buddy replication. On a healthy-step cadence,
  every stage's shard (its partition's model tensors, the embedding on
  stage 0 and the decoder on the last among them, with both Adam moments of
  its parameters) is copied into pinned host memory and one copy is held
  under its ring neighbour ``(j+1) % n``, pinned by per-stage sha256
  digests (:func:`~pipe_tpu_torch.train.state.stage_shard_manifest`). On
  one device that is bookkeeping; over a mesh each rank sends its shard
  one hop round its pipeline's stage ring (:meth:`Mesh.ring_shift`) and
  keeps its own capture beside its predecessor's, so the survivor before a
  dead stage, whose copy died with it, restores its own (ROADMAP.md C.20).

* :class:`ElasticController` -- detection. The elastic step carries a
  per-stage gradient heartbeat in the guard's carry; the controller reads
  it on the host cadence and raises :class:`StageLost` once a stage stays
  silent ``dead_after`` accepted steps.

* :func:`replan_after_loss` -- recovery. Re-cut the layers over the
  ``n-1`` survivors, re-emit and re-verify the op table for the new width
  (:func:`~pipe_tpu_torch.core.schedule.replan_stage_loss`), rebuild the
  trainer (on the same device, or on :func:`~pipe_tpu_torch.parallel.mesh
  .survivor_mesh`, whose dead ranks retire), restore from the buddy copies,
  regroup the stages (:func:`restack_state`: the layers keep their bytes,
  their keys move; ``build_sequential`` draws every layer in one order
  whatever the stage count, so the regrouped state is the state a run born
  with ``n-1`` stages would hold) and resume mid-epoch at the snapshot step.

:func:`train_elastic` drives the whole ladder: train, ``StageLost``,
re-plan, resume, bounded by ``max_replans``, aborting loudly
(:class:`~.recover.TrainingAborted`) when no survivor topology exists.
``TrainerConfig.elastic=None`` (the default) builds none of this, and the
step is the guarded (or plain) one, launch for launch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..obs.events import RECOVERY

__all__ = ["ElasticConfig", "StageLost", "BuddyStore", "ElasticController",
           "restack_state", "replan_after_loss", "train_elastic"]

# message tags: a capture's shard and digest (ring_shift), then the
# restore's messages, one tag per old stage
_TAG = 7100


class StageLost(RuntimeError):
    """A pipeline stage is persistently silent: escalate to re-plan."""

    def __init__(self, stage: int, detected_step: int,
                 snapshot_step: Optional[int]):
        super().__init__(
            f"pipeline stage {stage} persistently silent at step "
            f"{detected_step} (last buddy snapshot: "
            f"{'step ' + str(snapshot_step) if snapshot_step is not None else 'none'})")
        self.stage = stage
        self.detected_step = detected_step
        self.snapshot_step = snapshot_step


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic-training knobs (``TrainerConfig.elastic``; None, the
    default, keeps the step the guarded one and builds no buddy store)."""

    # buddy-replication cadence (accepted steps between captures; a
    # capture is skipped while any anomaly or silent streak is live)
    snapshot_every: int = 10
    # consecutive guard-accepted steps a stage's gradient heartbeat must
    # stay at exactly zero before the controller declares it dead
    dead_after: int = 2
    # host cadence for reading the heartbeat vector
    check_every: int = 1
    # verify every buddy capture bitwise against the source shards
    verify_replication: bool = True
    # how many stage losses one run may survive before aborting
    max_replans: int = 1
    # optional directory receiving a fsync'd buddy manifest JSON per
    # capture (train.state.write_buddy_manifest) for post-crash audit
    snapshot_dir: Optional[str] = None

    def __post_init__(self):
        if self.snapshot_every < 1 or self.dead_after < 1 \
                or self.check_every < 1:
            raise ValueError(
                "snapshot_every, dead_after and check_every must all "
                "be >= 1")
        if self.max_replans < 0:
            raise ValueError(
                f"max_replans must be >= 0, got {self.max_replans}")


def _align(n: int) -> int:
    return -(-n // 16) * 16


def _sized(layout):
    """``layout`` (``Trainer._shard_layout``) with each entry's byte
    offset in a packed buffer (16-byte aligned), and the buffer's size."""
    out, off = [], 0
    for name, layer, shape, dtype in layout:
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        out.append((name, layer, tuple(shape), dtype, off, nbytes))
        off += _align(nbytes)
    return out, off


def _views(sized, buf: torch.Tensor) -> List[torch.Tensor]:
    """The entries of a packed host buffer, as views of their dtype and
    shape."""
    return [buf[off:off + nbytes].view(dtype).view(shape)
            for _, _, shape, dtype, off, nbytes in sized]


def _host_buffer(nbytes: int, pin: bool) -> torch.Tensor:
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=pin)


class BuddyStore:
    """Distributed in-memory checkpoint of a :class:`Trainer`: each stage's
    shard, held by its ring buddy in pinned host memory and pinned by
    per-stage sha256 digests. One store per trainer
    (``Trainer.elastic_store``), so the snapshot survives the
    :class:`StageLost` raise."""

    def __init__(self, trainer, *, verify: bool = True, registry=None,
                 events=None, snapshot_dir: Optional[str] = None):
        self.trainer = trainer
        self.mesh = trainer.mesh
        self.n = int(trainer.cfg.n_stages)
        self.verify = verify
        self.registry = registry
        self.events = events
        self.snapshot_dir = snapshot_dir
        self.snapshots = 0
        self.last_capture: Dict[str, float] = {}
        self._pin = trainer.device.type == "cuda"
        self._step: Optional[int] = None
        self._state_step = 0
        self._adam_steps = 0
        self._sized: Dict[int, tuple] = {}
        self._held: Dict[int, torch.Tensor] = {}
        self._manifest: Dict[str, str] = {}

    @property
    def step(self) -> Optional[int]:
        """Global batch index of the captured snapshot (None = none)."""
        return self._step

    @property
    def has_snapshot(self) -> bool:
        return self._step is not None

    def holder(self, stage: int) -> int:
        """The stage whose rank holds ``stage``'s buddy copy."""
        return (stage + 1) % self.n

    def _layout(self, stage: int):
        if stage not in self._sized:
            self._sized[stage] = _sized(self.trainer._shard_layout(stage))
        return self._sized[stage]

    def _buffer(self, stage: int) -> torch.Tensor:
        if stage not in self._held:
            self._held[stage] = _host_buffer(self._layout(stage)[1],
                                             self._pin)
        return self._held[stage]

    def _digest(self, stage: int) -> str:
        from ..train.state import stage_shard_manifest

        return stage_shard_manifest(
            {stage: _views(self._layout(stage)[0],
                           self._held[stage])})[str(stage)]

    def capture(self, state, step: int) -> None:
        """Copy every stage shard of ``state`` (the trainer's live state)
        into host memory and hand it to its buddy: on one device every
        stage's; over a mesh this rank's, one hop round the ring, the
        predecessor's copy received (collective over the pipeline). With
        ``verify`` each copy is re-hashed against its source, so a
        diverged copy fails loudly at capture, never at restore."""
        from ..train.state import stage_shard_manifest, write_buddy_manifest

        t0 = time.perf_counter()
        tr = self.trainer
        tr._adopt(state)
        shards, adam_steps = tr._stage_shards()
        nbytes = 0
        for stage, tensors in shards.items():
            buf = self._buffer(stage)
            for view, t in zip(_views(self._layout(stage)[0], buf), tensors):
                view.copy_(t)
            nbytes += self._layout(stage)[1]
        if self.mesh is None:
            manifest = {str(j): self._digest(j) for j in shards}
            if self.verify:
                src = stage_shard_manifest(shards)
                for j in shards:
                    if manifest[str(j)] != src[str(j)]:
                        raise RuntimeError(
                            f"buddy copy of stage {j}'s shard diverged from "
                            f"the source at capture (step {step}) — the "
                            f"replication ring is corrupting data")
        else:
            manifest = self._ring_hop(step)
        self._manifest = manifest
        self._step = int(step)
        self._state_step = int(state.step)
        self._adam_steps = int(adam_steps)
        self.snapshots += 1
        self.last_capture = {"bytes": nbytes,
                             "seconds": time.perf_counter() - t0}
        if self.registry is not None:
            self.registry.counter("resilience.elastic.snapshots").inc()
        if self.events is not None:
            self.events.event(RECOVERY, action="buddy_capture", step=step,
                              stages=self.n, verified=self.verify)
        if self.snapshot_dir is not None:
            every = self._all_digests(manifest)
            if every is not None:
                write_buddy_manifest(self.snapshot_dir, int(step), every,
                                     self.n)

    def _ring_hop(self, step: int) -> Dict[str, str]:
        """This rank's capture to the next stage's rank, with its digest;
        the previous stage's received and, with ``verify``, re-hashed
        against the digest its sender computed. Returns the digests of the
        two copies this rank holds."""
        mesh = self.mesh
        own, prev = mesh.stage, (mesh.stage - 1) % self.n
        mine = self._digest(own)
        got = torch.zeros(32, dtype=torch.uint8)
        mesh.ring_shift(
            [self._held[own],
             torch.frombuffer(bytearray(bytes.fromhex(mine)),
                              dtype=torch.uint8)],
            [self._buffer(prev), got], tag=_TAG)
        theirs = self._digest(prev)
        if self.verify and theirs != bytes(got.tolist()).hex():
            raise RuntimeError(
                f"buddy copy of stage {prev}'s shard diverged from the "
                f"source at capture (step {step}) — the replication ring is "
                f"corrupting data")
        return {str(own): mine, str(prev): theirs}

    def _all_digests(self, manifest) -> Optional[Dict[str, str]]:
        """Every stage's digest, on the rank that writes the manifest file
        (None on the others; collective over the pipeline on a mesh)."""
        if self.mesh is None:
            return manifest
        mesh = self.mesh
        mine = torch.frombuffer(bytearray(bytes.fromhex(
            manifest[str(mesh.stage)])), dtype=torch.uint8)
        every = mesh.all_gather(mine, "stage")
        if mesh.rank != mesh.lead:
            return None
        return {str(j): bytes(d.tolist()).hex() for j, d in enumerate(every)}

    def _check(self) -> None:
        """Re-hash every copy this process holds against the capture's
        digests."""
        if not self.has_snapshot:
            raise RuntimeError("no buddy snapshot captured yet")
        for j in self._held:
            if self._digest(j) != self._manifest[str(j)]:
                raise RuntimeError(
                    f"buddy shard for stage {j} failed its manifest pin at "
                    f"restore (snapshot step {self._step}) — refusing to "
                    f"resume on corrupt state")

    def _entries(self, stage: int, layers=None) -> Dict[str, torch.Tensor]:
        """Copies of the held shard of ``stage`` (of its ``layers`` only, by
        layer in the partition), by entry name."""
        sized = self._layout(stage)[0]
        return {e[0]: v.clone() for e, v in
                zip(sized, _views(sized, self._held[stage]))
                if layers is None or e[1] in layers}

    def restore_state(self, mesh=None, lost_stage: Optional[int] = None):
        """The state at the snapshot step, re-verified against the capture
        digests, as a one-device trainer's :class:`TrainState`
        (``torch.optim.Adam``'s state over the whole model) on the host:
        feed it to :func:`restack_state`.

        On one device the whole state. Over a mesh (``mesh`` the survivor
        mesh, ``lost_stage`` the dead stage) only what this survivor's new
        stage holds after the re-plan, exchanged between the survivors:
        stage ``j``'s layers come from its own rank's capture, the dead
        stage's from its buddy (collective over the survivors)."""
        self._check()
        tr = self.trainer
        if self.mesh is None:
            entries: Dict[str, torch.Tensor] = {}
            for j in range(self.n):
                entries.update(self._entries(j))
        else:
            entries = self._exchange(mesh, lost_stage)
        if self.registry is not None:
            self.registry.counter("resilience.elastic.restores").inc()
        if self.events is not None:
            self.events.event(RECOVERY, action="buddy_restore",
                              step=self._step, stages=self.n)
        return tr._state_from_shards(entries, self._adam_steps,
                                     self._state_step)

    def _exchange(self, new, lost: int) -> Dict[str, torch.Tensor]:
        """Move the snapshot's layers to the survivors that hold them after
        the re-plan, within each data column: one message per (source,
        destination) pair, its layout derived from the model on both
        sides, so no length goes first."""
        import torch.distributed as dist

        from ..models.transformer_lm import pipelined_lm_balance

        old = self.mesh
        n, n_layers = self.n, self.trainer.model_cfg.n_layers
        old_off = np.cumsum([0] + pipelined_lm_balance(n_layers, n))
        new_off = np.cumsum([0] + pipelined_lm_balance(n_layers, n - 1))

        def pieces(stage):
            """(source rank, old stage, its layers) for new stage ``stage``
            of this column: every old stage it overlaps."""
            out = []
            for j in range(n):
                lo = max(old_off[j], new_off[stage])
                hi = min(old_off[j + 1], new_off[stage + 1])
                if lo < hi:
                    src = old.rank_of(j if j != lost else self.holder(lost))
                    out.append((src, j, set(range(lo - old_off[j],
                                                  hi - old_off[j]))))
            return out

        def chosen(j, layers):
            return [e for e in self._layout(j)[0] if e[1] in layers]

        entries: Dict[str, torch.Tensor] = {}
        ops, inbox = [], []
        for src, j, layers in pieces(new.stage):
            if src == old.rank:
                entries.update(self._entries(j, layers))
                continue
            sel = chosen(j, layers)
            buf = _host_buffer(sum(_align(e[5]) for e in sel), False)
            inbox.append((sel, buf))
            ops.append(dist.P2POp(dist.irecv, buf, src,
                                  group=new.world_group, tag=_TAG + 2 + j))
        for stage in range(n - 1):
            dst = new.rank_of(stage)
            for src, j, layers in pieces(stage):
                if src != old.rank or dst == old.rank:
                    continue
                sel = chosen(j, layers)
                buf = _host_buffer(sum(_align(e[5]) for e in sel), False)
                held = self._held[j]
                off = 0
                for e in sel:
                    buf[off:off + e[5]].copy_(held[e[4]:e[4] + e[5]])
                    off += _align(e[5])
                ops.append(dist.P2POp(dist.isend, buf, dst,
                                      group=new.world_group,
                                      tag=_TAG + 2 + j))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for sel, buf in inbox:
            off = 0
            for name, _, shape, dtype, _, nbytes in sel:
                entries[name] = buf[off:off + nbytes].view(dtype).view(shape)
                off += _align(nbytes)
        return entries


class ElasticController:
    """Host half of the elastic rung: buddy-capture cadence and the
    dead-stage verdict. ``after_step`` mirrors
    ``ResilienceController.after_step`` and runs right after it."""

    def __init__(self, cfg: ElasticConfig, store: BuddyStore, *,
                 registry=None, events=None,
                 log_fn: Callable[[str], None] = print):
        self.cfg = cfg
        self.store = store
        self.registry = registry
        self.events = events
        self.log_fn = log_fn

    @property
    def snapshots(self) -> int:
        return self.store.snapshots

    def after_step(self, b: int, state, aux):
        """Read the heartbeat on the check cadence. Captures a buddy
        snapshot when the state is all-healthy on the snapshot cadence;
        raises :class:`StageLost` when any stage's silent streak reaches
        ``dead_after``. Returns ``(state, aux)`` unchanged otherwise."""
        cfg = self.cfg
        if (b + 1) % cfg.check_every:
            return state, aux
        hb = aux[3].cpu().numpy()      # the host sync point (check cadence)
        consec = int(aux[1])
        dead = np.nonzero(hb >= cfg.dead_after)[0]
        if dead.size:
            # A kill at stage j silences every stage <= j (a zero output
            # kills the backward signal upstream of the cut): the LARGEST
            # silent index localizes the dead stage.
            stage = int(dead.max())
            snap = self.store.step
            if self.registry is not None:
                self.registry.counter("resilience.elastic.stage_lost").inc()
            if self.events is not None:
                self.events.event(RECOVERY, action="stage_lost",
                                  stage=stage, step=b, snapshot_step=snap,
                                  silent_steps=int(hb[stage]))
            self.log_fn(
                f"| elastic: stage {stage} silent {int(hb[stage])} "
                f"accepted steps at step {b} -> StageLost "
                f"(buddy snapshot @ {snap})")
            raise StageLost(stage, b, snap)
        if consec == 0 and not hb.any():
            if not self.store.has_snapshot \
                    or (b + 1) % cfg.snapshot_every == 0:
                self.store.capture(state, b)
        return state, aux


# ---------------------------------------------------------------------------
# Restacking: regroup an n-stage state over n-1 stages
# ---------------------------------------------------------------------------

def _partition_offsets(n_layers: int, n_stages: int) -> np.ndarray:
    from ..models.transformer_lm import pipelined_lm_balance

    return np.cumsum([0] + pipelined_lm_balance(n_layers, n_stages))


def restack_state(state, n_old: int, n_new: int,
                  n_layers: Optional[int] = None):
    """Regroup a host-side ``n_old``-stage :class:`TrainState` (a one-device
    trainer's, or a part of it) over ``n_new`` stages. The port's model keys
    carry the partition (``partitions.{p}.layers.{l}.*``), so regrouping
    renames them for the new cut and every tensor keeps its bytes; the
    optimizer state is indexed by parameter over the whole model, which no
    cut changes, so it carries across as it is. ``n_layers`` (the model's
    blocks) is read from the keys of a whole state when not given. Raises
    ``ValueError`` when the blocks do not regroup uniformly."""
    from ..train.state import TrainState

    if n_layers is None:
        parts: Dict[int, int] = {}
        for key in state.model:
            _, p, _, l, _ = key.split(".", 4)
            parts[int(p)] = max(parts.get(int(p), 0), int(l) + 1)
        n_layers = sum(parts.values()) - 3
    if n_layers % n_new:
        raise ValueError(
            f"{n_layers} layers do not regroup over {n_new} stages "
            f"(uniform stage bodies need n_layers % n_stages == 0)")
    old = _partition_offsets(n_layers, n_old)
    new = _partition_offsets(n_layers, n_new)

    def rename(key):
        _, p, _, l, rest = key.split(".", 4)
        k = old[int(p)] + int(l)
        q = int(np.searchsorted(new, k, side="right")) - 1
        return f"partitions.{q}.layers.{k - new[q]}.{rest}"

    return TrainState(model={rename(k): v for k, v in state.model.items()},
                      optimizer=state.optimizer, step=state.step)


# ---------------------------------------------------------------------------
# Recovery driver
# ---------------------------------------------------------------------------

def replan_after_loss(trainer, lost: StageLost, *,
                      log_fn: Callable[[str], None] = print):
    """Rebuild the run over the ``n-1`` survivors after a stage loss.

    Verifies the degraded topology (op table emission and proofs through
    :func:`~pipe_tpu_torch.core.schedule.replan_stage_loss`, the balance
    re-cut), builds a new trainer (on the same device, or over a mesh on
    :func:`~pipe_tpu_torch.parallel.mesh.survivor_mesh`: every rank of the
    world calls this), restores and restacks the buddy snapshot, and
    returns ``(new_trainer, restored_state, start_step)`` ready for
    ``train_epoch(..., start_step=start_step)``. A rank of the dead stage
    gets ``(None, None, None)``: it has retired. Raises
    :class:`~.recover.TrainingAborted` when no survivor topology exists,
    the final rung of the ladder.
    """
    from ..core.schedule import replan_stage_loss
    from ..parallel.mesh import survivor_mesh
    from .recover import TrainingAborted

    t0 = time.perf_counter()
    cfg = trainer.cfg
    n = cfg.n_stages
    n_new = n - 1
    store = trainer.elastic_store()
    if n_new < 2:
        raise TrainingAborted(
            f"stage {lost.stage} lost with only {n} stages — no pipeline "
            f"survives the re-plan")
    n_layers = trainer.model_cfg.n_layers
    if n_layers % n_new:
        raise TrainingAborted(
            f"stage {lost.stage} lost but {n_layers} layers do not "
            f"regroup over {n_new} survivors (uniform stage bodies)")
    if not store.has_snapshot:
        raise TrainingAborted(
            f"stage {lost.stage} lost at step {lost.detected_step} before "
            f"the first buddy snapshot — nothing to restore from")
    plan = replan_stage_loss(
        cfg.chunks, n, lost.stage, schedule=cfg.schedule,
        balance=[n_layers // n] * n)
    new_cfg = dataclasses.replace(cfg, n_stages=n_new)
    new_chaos = (trainer.chaos.without("kill_stage")
                 if trainer.chaos is not None else None)
    if trainer.mesh is None:
        new_tr = type(trainer)(trainer.model_cfg, new_cfg,
                               device=trainer.device, chaos=new_chaos)
        host = store.restore_state()
    else:
        mesh = survivor_mesh(trainer.mesh, lost.stage)
        if mesh is None:
            log_fn(f"| elastic: rank {trainer.mesh.rank} of lost stage "
                   f"{lost.stage} retires")
            return None, None, None
        new_tr = type(trainer)(trainer.model_cfg, new_cfg, chaos=new_chaos,
                               mesh=mesh)
        host = store.restore_state(mesh=mesh, lost_stage=lost.stage)
    restored = restack_state(host, n, n_new, n_layers=n_layers)
    start_step = store.step + 1
    lost_steps = lost.detected_step - store.step
    dt = time.perf_counter() - t0
    registry = trainer.registry
    registry.counter("resilience.elastic.replans").inc()
    registry.counter("resilience.elastic.lost_steps").inc(max(lost_steps, 0))
    registry.gauge("resilience.elastic.recovery_s").set(dt)
    trainer.events.event(
        RECOVERY, action="replan", stage=lost.stage, n_stages=n_new,
        balance=list(plan.balance or ()), schedule=cfg.schedule,
        phase_ok=plan.phase.accepted, snapshot_step=store.step,
        resume_step=start_step, lost_steps=lost_steps, recovery_s=dt)
    log_fn(f"| elastic: re-planned {n}->{n_new} stages after losing "
           f"stage {lost.stage} (balance {list(plan.balance or ())}, "
           f"table verified, phase "
           f"{'ok' if plan.phase.accepted else 'rejected'}); resuming "
           f"from buddy snapshot @ step {store.step} "
           f"({lost_steps} steps lost, {dt:.2f}s recovery)")
    return new_tr, restored, start_step


def train_elastic(trainer, source, *, epoch: int = 0, state=None,
                  max_steps: Optional[int] = None, log_every: int = 0,
                  log_fn: Callable[[str], None] = print):
    """Run an epoch under the full ladder: train, and on
    :class:`StageLost` re-plan over the survivors and resume, up to
    ``ElasticConfig.max_replans`` times (then
    :class:`~.recover.TrainingAborted`). Returns ``(trainer, state,
    info)``: the trainer may be a new, narrower one after a recovery;
    ``info['recoveries']`` records each one. Over a mesh every rank calls
    it; a rank of a lost stage returns ``(None, None, info)`` with
    ``info['retired']`` true."""
    from .recover import TrainingAborted

    start = 0
    history: List[dict] = []
    while True:
        try:
            state, info = trainer.train_epoch(
                source, epoch, state, max_steps=max_steps,
                log_every=log_every, log_fn=log_fn, start_step=start)
            info["replans"] = len(history)
            info["recoveries"] = history
            return trainer, state, info
        except StageLost as lost:
            max_replans = getattr(trainer.cfg.elastic, "max_replans", 1)
            if len(history) >= max_replans:
                raise TrainingAborted(
                    f"stage {lost.stage} lost at step "
                    f"{lost.detected_step} after {len(history)} re-plans "
                    f"(max_replans={max_replans})") from lost
            t0 = time.perf_counter()
            trainer, state, start = replan_after_loss(trainer, lost,
                                                      log_fn=log_fn)
            history.append({
                "stage": lost.stage,
                "detected_step": lost.detected_step,
                "snapshot_step": lost.snapshot_step,
                "resume_step": start,
                "lost_steps": lost.detected_step - (lost.snapshot_step or 0),
                "n_stages": (trainer.cfg.n_stages if trainer is not None
                             else None),
                "recovery_s": time.perf_counter() - t0,
            })
            if trainer is None:
                return None, None, {"retired": True, "replans": len(history),
                                    "recoveries": history}
