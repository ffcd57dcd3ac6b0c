"""Training loop for the pipelined tutorial LM.

Counterpart of ``pipe_tpu/train/loop.py`` (reference ``main.py:180-234``):
Adam + StepLR(gamma 0.95 per epoch) + global-norm clip 0.5, cross-entropy on
the last stage, the same log line. The model is the tutorial LM as a
``Sequential`` under ``Pipe``, cut where ``PipelinedLM`` cuts it
(``pipelined_lm_balance``). ``schedule="gpipe"`` trains through ``Pipe``
(GPipe on the serial emulator); ``"1f1b"``, ``"zb-h1"`` and
``"interleaved-1f1b"`` train through the table executor
(``parallel/scheduled.py``; zb-h1 under ``never`` with the structural B/W
split, ``split_stage="auto"``) over ``PipelinedLM.from_sequential`` of the same
modules, with the loss on the last stage (``loss_post_fn``), as gpipe does
when ``LMConfig.loss_block`` fuses the decoder into the loss;
``interleaved-1f1b`` cuts the model into ``n_stages * interleave`` virtual
stages, as ``pipe_tpu``'s trainer does. Eval always runs ``Pipe`` with no
remat.

Around the step, as ``pipe_tpu``'s trainer: the ``train.*`` registry
instruments; with ``telemetry_dir`` a JSONL event log of step spans and one
``StepReport`` a step (MFU on the card's own peak, a stage sharing the card:
``n_devices=1``), a ``torch.profiler`` trace every ``profile_every`` steps;
TensorBoard scalars with ``tb_dir``; the native batch prefetcher with
``prefetch_depth``; a planner ``Plan`` (or ``"auto"``) with ``plan``; the
guarded step, rewind and data retry with ``resilience`` (and a ``ChaosPlan``
to inject faults); a SIGTERM autosave (:meth:`Trainer.install_autosave`).
With none of them set the step is the plain one, kernel for kernel, with no
clock read or file write of its own. ``schedule="interleaved"`` trains
through the interleaved wavefront's tables (``parallel/interleaved.py``);
``mu_dtype`` and ``zero`` through ``train/zero.py``'s ``ShardedAdam``.

**Over a world of ranks** (``mesh=``, or an initialized world of
``n_stages * n_data`` ranks, where the trainer makes the mesh itself as
``pipe_tpu``'s makes ``make_mesh(cfg.n_stages, cfg.n_data)``) each rank
builds the model from the seed as the one-device trainer does, keeps only
its stage's modules (the rest go to the ``meta`` device) and trains through
the executor ``pipe_tpu``'s trainer picks: ``SpmdPipeline`` for gpipe,
``ScheduledPipeline`` for 1f1b, zb-h1 and interleaved-1f1b (zb-h1 under
``never`` with the structural B/W split, ``split_stage="auto"``, as on one
device),
``InterleavedSpmdPipeline`` for interleaved, all walking the tables over the
ranks; eval runs ``SpmdPipeline`` (``InterleavedSpmdPipeline`` for the
interleaved placements). The global batch is read on every rank and each
data rank trains on its rows; the gradient clip's global norm sums over
the stages; Adam is ``train/zero.py``'s ``ShardedAdam``, its moments
sharded over the data group with ``zero``.
Rank 0 writes the one-device trainer's checkpoint files (:meth:`Trainer.save`
gathers the model and Adam state), and a one-device checkpoint resumes on a
mesh. One ``StepReport`` a rank, ``n_devices=1`` (ROADMAP.md C.9), each
rank's events under ``telemetry_dir/rank{r}``, TensorBoard from rank 0. The guarded step and chaos run over a mesh as on
one device: the loss and the gradient norm are the world's, so every rank
reaches the same verdict, and each rank selects back, or rewinds, its own
shard.

**Elastic training** (``elastic``, ``resilience/elastic.py``): the guarded
step plus a kill channel (a forward hook on each stage's last block zeroes
its output under a ``kill_stage`` fault) and a per-stage gradient heartbeat,
a ``[n_stages]`` silent-streak vector in the guard's carry (over a mesh each
rank beats for its own stage and the vector is summed over the pipeline).
:meth:`Trainer.elastic_store` keeps the buddy copies that
``replan_after_loss`` restores from.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core import microbatch as mb
from ..core.partition import fold_seed
from ..core.schedule import (InterleavedOneFOneBSchedule,
                             InterleavedSchedule, bubble_fraction)
from ..data import lm_text
from ..models.common import per_row_ce
from ..models.transformer_lm import (LMConfig, PipelinedLM,
                                     build_sequential, pipelined_lm_balance)
from ..obs import events as ev
from ..obs.meters import profile_trace
from ..obs.telemetry import (StepReport, card_name_and_power_limit,
                             device_memory_peaks, get_registry,
                             peak_flops_per_chip)
from ..ops.layers import Sequential
from ..parallel.interleaved import InterleavedSpmdPipeline
from ..parallel.scheduled import ScheduledPipeline
from ..parallel.spmd import SpmdPipeline
from ..pipe import Pipe
from ..utils.platform import DEFAULT_DEVICE, resolve_device
from .state import TrainState, save_checkpoint

__all__ = ["TrainerConfig", "Trainer", "lm_loss", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Training hyperparameters: the fields and defaults of ``pipe_tpu``'s
    (reference ``main.py:101-120,182-185``)."""

    batch_size: int = 32
    eval_batch_size: int = 8
    bptt: int = 128
    chunks: int = 4
    checkpoint: str = "except_last"
    n_stages: int = 2
    n_data: int = 1
    lr: float = 5.0            # reference main.py:183 (Adam at lr=5.0, sic)
    lr_gamma: float = 0.95     # StepLR(1.0, gamma=0.95), main.py:185
    grad_clip: float = 0.5     # main.py:219
    seed: int = 1234
    schedule: str = "gpipe"
    mu_dtype: Optional[str] = None
    interleave: int = 2
    tb_dir: Optional[str] = None
    zero: bool = False
    prefetch_depth: int = 0
    telemetry_dir: Optional[str] = None
    profile_every: int = 0
    resilience: Optional[Any] = None
    elastic: Optional[Any] = None
    plan: Optional[Any] = None
    plan_memory_cap: Optional[int] = None


_SCHEDULES = ("gpipe", "1f1b", "zb-h1", "interleaved", "interleaved-1f1b")


def _check_config(cfg: TrainerConfig, mesh=None) -> None:
    if cfg.schedule not in _SCHEDULES:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.mu_dtype is not None and cfg.mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu_dtype must be one of {sorted(_MU_DTYPES)}, "
                         f"got {cfg.mu_dtype!r}")
    if cfg.elastic is not None:
        if cfg.resilience is None:
            raise ValueError(
                "TrainerConfig.elastic requires resilience= (the "
                "elastic rung extends the guarded step's ladder)")
        if cfg.schedule in ("interleaved", "interleaved-1f1b"):
            raise ValueError(
                "elastic training needs one stage per device "
                f"(schedule {cfg.schedule!r} interleaves "
                f"{cfg.interleave} virtual stages per device)")
        if mesh is not None and mesh.backend != "gloo":
            raise ValueError(
                f"elastic training over a mesh needs the gloo backend, not "
                f"{mesh.backend!r}: the buddy copies are host buffers "
                f"(ROADMAP.md C.22)")


_MU_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
              "float32": torch.float32}


def _world_mesh(cfg: TrainerConfig, mesh):
    """The mesh the trainer runs over: ``mesh``, else one over an
    initialized world of more than one rank, else None (one device)."""
    import torch.distributed as dist

    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(cfg.n_stages, cfg.n_data)
    if mesh is None:
        if cfg.n_data != 1:
            raise ValueError(
                f"TrainerConfig.n_data={cfg.n_data} needs a world of "
                f"n_stages * n_data = {cfg.n_stages * cfg.n_data} ranks "
                f"(runtime.distributed.launch, initialize or torchrun)")
        return None
    if (mesh.n_stages, mesh.n_data) != (cfg.n_stages, cfg.n_data):
        raise ValueError(
            f"a {mesh.n_stages}x{mesh.n_data} mesh for n_stages="
            f"{cfg.n_stages}, n_data={cfg.n_data}")
    return mesh


def _resolve_plan_config(model_cfg: LMConfig,
                         cfg: TrainerConfig) -> TrainerConfig:
    """Fold a planner ``Plan`` into the config (``cfg.plan`` is set), as
    ``pipe_tpu``'s ``_resolve_plan_config``: a ``Plan`` or a saved plan's
    path is adopted as it is; ``"auto"`` searches the families this trainer
    runs over an analytic uniform profile (the LM's blocks are alike, so
    uniform relative costs are exact) at this config's stage count, batch
    and checkpoint mode. The port prices it ``serialized``: every stage
    shares one device, so a step costs the sum of its ops, not the max over
    devices (``pipe_tpu`` picks ``parallel`` on an accelerator; ROADMAP.md
    C.9)."""
    from ..core.planner import Plan, search, uniform_profile

    plan = cfg.plan
    if isinstance(plan, str) and plan != "auto":
        plan = Plan.load(plan)
    if plan == "auto":
        # Per-layer analytic sizes: one boundary activation row is
        # [bptt, d_model] f32; transformer-block params are the attention
        # (4 d^2) + FFN (2 d d_ff) matmuls.
        act = cfg.bptt * model_cfg.d_model * 4
        p_layer = (4 * model_cfg.d_model ** 2
                   + 2 * model_cfg.d_model * model_cfg.d_ff) * 4
        prof = uniform_profile(
            model_cfg.n_layers, rows=1, mode="serialized",
            layer_act_bytes=act, layer_param_bytes=p_layer)
        m_cands = sorted({m for m in (2, 4, 8, 16, 32, cfg.chunks)
                          if m > 0 and cfg.batch_size % m == 0})
        plans = search(
            prof, n_devices=cfg.n_stages, m_candidates=m_cands,
            batch_rows=cfg.batch_size,
            schedules=("gpipe", "1f1b", "zb-h1", "interleaved-1f1b"),
            interleave_candidates=(cfg.interleave,),
            checkpoint=cfg.checkpoint,
            memory_cap_bytes=cfg.plan_memory_cap,
            uniform_only=True)
        if not plans:
            raise ValueError(
                "plan='auto' found no feasible plan: every candidate "
                "failed verification, phase compilation, or the "
                "plan_memory_cap — raise the cap or hand-pick a config")
        plan = plans[0]
    if len(set(plan.balance)) > 1:
        warnings.warn(
            f"plan balance {list(plan.balance)} is non-uniform; the "
            f"Trainer's PipelinedLM factors layers uniformly over "
            f"virtual stages, so only the plan's stage COUNT is honored "
            f"here (drive Pipe(plan=...) for heterogeneous cuts)",
            stacklevel=3)
    kw: Dict[str, Any] = {"plan": plan, "schedule": plan.schedule,
                          "chunks": plan.m, "checkpoint": plan.checkpoint,
                          "n_stages": plan.n_devices}
    if plan.v > 1:
        kw["interleave"] = plan.v
    return dataclasses.replace(cfg, **kw)


def plan_line(cfg: TrainerConfig) -> str:
    """The resolved plan, as ``apps/lm_tutorial.py --plan`` prints it, with
    the split the trainer runs: zb-h1 under ``never`` runs the structural
    B/W split (``split_stage="auto"``), under a recompute mode the fused
    backward at B."""
    plan = cfg.plan
    line = (f"plan resolved: schedule={cfg.schedule} chunks={cfg.chunks} "
            f"interleave={cfg.interleave} checkpoint={cfg.checkpoint}")
    if cfg.schedule == "zb-h1":
        line += (" split=structural" if cfg.checkpoint == "never" else
                 " split=none (fused backward at B)")
    if plan.profile_source != "uniform":
        # uniform (analytic) profiles rank in abstract units: only a
        # measured profile's prediction is wall time
        line += (f" (predicted {plan.predicted_step_s * 1e3:.2f} ms/step, "
                 f"{plan.predicted_peak_bytes / 1e6:.1f} MB/device)")
    return line


def lm_loss(pipe: Pipe, tokens: torch.Tensor, targets: torch.Tensor, *,
            train: bool, seed: Optional[int] = None) -> torch.Tensor:
    """Mean over the batch's rows of ``per_row_ce`` of the pipeline's logits.

    ``Pipe`` gathers the ``[batch, seq, vocab]`` logits before the loss (at
    the tutorial's width that is 32 x 128 x vocab floats, a few hundred MB);
    the table executor computes it per micro-batch on the last stage
    instead. A batch that ``chunks`` does not divide is split unevenly by
    ``Pipe``, so every row is real and the mean is the JAX trainer's
    row-masked mean over its zero-padded batch.
    """
    return per_row_ce(pipe(tokens, train=train, seed=seed), targets).mean()


def clip_by_global_norm(grads: Iterable[torch.Tensor],
                        max_norm: float, mesh=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: left alone when the global
    norm is below ``max_norm``, else ``g / norm * max_norm``. Unlike
    ``torch.nn.utils.clip_grad_norm_`` it adds nothing to the norm, and it
    reads nothing back to the host. Returns the norm before clipping (the
    guarded step's ``step_guard`` reads it). On a ``mesh`` the grads are
    this rank's stage's and the squares are summed over the pipeline."""
    grads = list(grads)
    sq = sum(g.float().square().sum() for g in grads)
    if mesh is not None:
        sq = torch.as_tensor(sq, dtype=torch.float32,
                             device=mesh.device).clone()
        mesh.all_reduce(sq, "stage")
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


class Trainer:
    """Builds the LM, ``Pipe`` (and, for a table schedule, the
    ``ScheduledPipeline`` over the same modules) and Adam on ``device``, and
    runs epochs.

    The model and optimizer live in the trainer and are updated in place.
    A :class:`TrainState` it returns shares their tensors: it is the live
    state, and training on moves it on (clone its tensors to keep a copy). A
    state from elsewhere (a checkpoint, another run) is copied in when it is
    passed to :meth:`train_epoch` or :meth:`evaluate`.

    ``chaos`` (a ``resilience.ChaosPlan``) injects its train and data faults
    into the guarded step (``cfg.resilience``); the activation fault rides a
    forward hook on the positional encoding, installed only when a plan is
    given.
    """

    def __init__(self, model_cfg: LMConfig, cfg: TrainerConfig,
                 device=DEFAULT_DEVICE, chaos=None, mesh=None):
        if cfg.plan is not None:
            cfg = _resolve_plan_config(model_cfg, cfg)
        mesh = _world_mesh(cfg, mesh)
        _check_config(cfg, mesh)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.chaos = chaos
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.pipe = Pipe(self._build(cfg.seed), chunks=cfg.chunks,
                         checkpoint=cfg.checkpoint,
                         balance=pipelined_lm_balance(model_cfg.n_layers,
                                                      cfg.n_stages),
                         device=self.device)
        self.scheduled = self._build_scheduled()
        self.eval_exec = self._build_eval() if mesh is not None else None
        # each stage's blocks, as PipelinedLM's stage_fn runs them (the
        # heartbeat reads their gradients, the kill zeroes their output)
        layers, lps = list(self.pipe), model_cfg.n_layers // cfg.n_stages
        self._stage_blocks = [layers[2 + s * lps:2 + (s + 1) * lps]
                              for s in range(cfg.n_stages)]
        if chaos is not None:
            from ..resilience.chaos import kill_output, poison_activations
            # the embedding's output, in Pipe and in the tables' pre_fn
            self.pipe[1].register_forward_hook(
                lambda module, args, out: poison_activations(out))
            for s, blocks in enumerate(self._stage_blocks):
                blocks[-1].register_forward_hook(
                    lambda module, args, out, s=s: kill_output(out, s))
        # this rank's parameters (every one on one device)
        self.params = [p for p in self.pipe.parameters()
                       if p.device.type != "meta"]
        # optax.scale_by_adam(0.9, 0.999, eps 1e-8) then -lr * u. Over a
        # mesh: ShardedAdam, whose update is the same with its moments
        # sharded (zero) or not, operation for operation.
        if mesh is not None or cfg.zero or cfg.mu_dtype is not None:
            from .zero import ShardedAdam
            self.optimizer: Any = ShardedAdam(
                self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                mesh=mesh, zero=cfg.zero,
                mu_dtype=_MU_DTYPES.get(cfg.mu_dtype))
        else:
            self.optimizer = torch.optim.Adam(self.params, lr=cfg.lr,
                                              betas=(0.9, 0.999), eps=1e-8)
        self._state: Optional[TrainState] = None
        self.tb = None
        if cfg.tb_dir is not None and (mesh is None or mesh.rank == mesh.lead):
            from ..obs.tb_writer import ScalarWriter
            self.tb = ScalarWriter(cfg.tb_dir)
        # The registry (cheap counters) and the event log; with no
        # telemetry_dir the log is the shared null sink.
        self.registry = get_registry()
        self.events: Any = ev.NULL_EVENT_LOG
        if cfg.telemetry_dir is not None:
            tdir = (cfg.telemetry_dir if mesh is None else
                    os.path.join(cfg.telemetry_dir, f"rank{mesh.rank}"))
            os.makedirs(tdir, exist_ok=True)
            self.events = ev.EventLog(os.path.join(tdir, "events.jsonl"))
        self._stop_requested = False
        self._autosave_dir: Optional[str] = None
        self._guard_bufs: Optional[List[torch.Tensor]] = None
        self._pending_verdict = None
        self._buddy_store = None

    def _build_scheduled(self):
        """The table executor for ``1f1b``/``zb-h1``/``interleaved-1f1b``
        (and for ``gpipe`` with ``loss_block``, whose fused loss lives on
        the last stage, and for every schedule over a mesh: ``SpmdPipeline``
        for gpipe), the interleaved wavefront for ``interleaved``, over
        ``PipelinedLM.from_sequential`` of the ``Pipe``'s own modules: one
        set of weights, one state dict. None: ``Pipe`` trains."""
        cfg, mesh = self.cfg, self.mesh
        if cfg.schedule == "gpipe" and not self.model_cfg.loss_block \
                and mesh is None:
            return None
        split_kw = {}
        if cfg.schedule == "zb-h1" and cfg.checkpoint == "never":
            split_kw["split_stage"] = "auto"     # as pipe_tpu's trainer
        elif cfg.schedule == "zb-h1":
            from ..obs.zb_model import crossover
            row = crossover(cfg.chunks, cfg.n_stages, sigma=1.0)
            warnings.warn(
                f"zb-h1 at (m={cfg.chunks}, n={cfg.n_stages}) with "
                f"checkpoint={cfg.checkpoint!r}: the B/W split needs "
                f"checkpoint='never', so the fused backward runs at B and "
                f"the zero-bubble advantage (breakeven sigma* "
                f"{row['breakeven_sigma']:.2f}, obs/zb_model.py crossover) "
                f"is forfeited.", stacklevel=3)
        schedule, n_virtual = cfg.schedule, cfg.n_stages
        if schedule in ("interleaved", "interleaved-1f1b"):
            # n_stages devices' worth of tables, each hosting `interleave`
            # virtual stages: the model factors into n_stages*interleave
            n_virtual = cfg.n_stages * cfg.interleave
        if schedule == "interleaved-1f1b":
            schedule = InterleavedOneFOneBSchedule(interleave=cfg.interleave)
        self.model = PipelinedLM.from_sequential(
            self.model_cfg, Sequential(list(self.pipe)), n_virtual)
        if mesh is not None:
            self._localize(n_virtual)
        kw = dict(module=self.model, checkpoint=cfg.checkpoint, mesh=mesh,
                  device=self.device)
        if cfg.schedule == "interleaved":
            return InterleavedSpmdPipeline(
                self.model.stage_fn, self.model.pre_fn,
                self.model.loss_post_fn, cfg.n_stages,
                post_with_batch=True, v=cfg.interleave, **kw)
        if cfg.schedule == "gpipe" and mesh is not None:
            return SpmdPipeline(
                self.model.stage_fn, self.model.pre_fn,
                self.model.loss_post_fn, cfg.n_stages, post_with_batch=True,
                **kw)
        return ScheduledPipeline(
            self.model.stage_fn, self.model.pre_fn, self.model.loss_post_fn,
            n_stages=cfg.n_stages, schedule=schedule, **split_kw, **kw)

    def _localize(self, n_virtual: int) -> None:
        """Keep this rank's stage on its device (its blocks, the embedding
        on the first stage, the decoder on the last); the rest to meta."""
        from ..parallel.mesh import localize

        d, p = self.mesh.n_stages, self.mesh.stage
        keep = [self.model.stage_blocks(s) for s in range(n_virtual)
                if s % d == p]
        if p == 0:
            keep += [self.model.embed, self.model.posenc]
        if p == d - 1:
            keep.append(self.model.decoder)
        localize(self.pipe, keep, self.device)

    def _build_eval(self):
        """Eval over the mesh, ``pipe_tpu``'s ``eval_pipe``: the wavefront
        with no remat, interleaved for the interleaved placements."""
        cfg = self.cfg
        kw = dict(module=self.model, checkpoint="never", mesh=self.mesh,
                  device=self.device, post_with_batch=True)
        if cfg.schedule in ("interleaved", "interleaved-1f1b"):
            return InterleavedSpmdPipeline(
                self.model.stage_fn, self.model.pre_fn,
                self.model.loss_post_fn, cfg.n_stages, v=cfg.interleave,
                **kw)
        return SpmdPipeline(self.model.stage_fn, self.model.pre_fn,
                            self.model.loss_post_fn, cfg.n_stages, **kw)

    def _build(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return build_sequential(self.model_cfg, device=self.device,
                                generator=gen)

    # --- state ---

    def _capture(self, step: int) -> TrainState:
        self._settle_steps()
        model = self.pipe.state_dict()
        if self.mesh is not None:         # this rank's entries
            model = {k: v for k, v in model.items()
                     if v.device.type != "meta"}
        self._state = TrainState(model=model,
                                 optimizer=self.optimizer.state_dict(),
                                 step=step)
        return self._state

    def _adopt(self, state: TrainState) -> None:
        if state is self._state:
            return
        self._pending_verdict = None      # the live state it was for goes
        if self.mesh is None and not isinstance(self.optimizer,
                                                torch.optim.Optimizer):
            self.pipe.load_state_dict(state.model)
            self._load_optimizer(state)
        elif self.mesh is None:
            self.pipe.load_state_dict(state.model)
            self.optimizer.load_state_dict(copy.deepcopy(state.optimizer))
        else:
            own = {k for k, v in self.pipe.state_dict().items()
                   if v.device.type != "meta"}
            self.pipe.load_state_dict({k: state.model[k] for k in own},
                                      strict=False)
            self._load_optimizer(state)
        self._state = None

    def _global_index(self) -> List[int]:
        """Each local parameter's index among all the model's (the
        one-device optimizer's numbering)."""
        index = {id(p): k for k, p in enumerate(self.pipe.parameters())}
        return [index[id(p)] for p in self.params]

    def _load_optimizer(self, state: TrainState) -> None:
        """The optimizer state of ``state``: this trainer's own, or a
        one-device trainer's (``torch.optim.Adam`` over every parameter,
        as a checkpoint holds it), cut to this rank's parameters."""
        sd = state.optimizer
        if "exp_avg" in sd:                        # a ShardedAdam's own
            self.optimizer.load_state_dict(sd)
            return
        n_all = sum(1 for _ in self.pipe.parameters())
        full = len(sd["param_groups"][0]["params"]) == n_all
        gidx = self._global_index() if full else list(range(len(
            self.params)))
        if isinstance(self.optimizer, torch.optim.Optimizer):
            local = {"state": {j: sd["state"][g] for j, g in enumerate(gidx)
                               if g in sd["state"]},
                     "param_groups": [{**sd["param_groups"][0],
                                       "params": list(range(len(
                                           self.params)))}]}
            self.optimizer.load_state_dict(copy.deepcopy(local))
            return
        steps = [int(st["step"]) for st in sd["state"].values()]
        moments = {j: sd["state"][g] for j, g in enumerate(gidx)
                   if g in sd["state"]}
        if len(moments) != len(self.params):       # a fresh Adam
            moments = {j: {"exp_avg": torch.zeros_like(p),
                           "exp_avg_sq": torch.zeros_like(p)}
                       for j, p in enumerate(self.params)}
        self.optimizer.load_full_moments(moments, max(steps, default=0))

    def _own_state(self):
        """This rank's part of the one-device trainer's state, on the host:
        its model tensors by name, and the Adam state of its parameters by
        their index over the whole model (under ``zero`` the moments are
        gathered whole over the data group: collective)."""
        if isinstance(self.optimizer, torch.optim.Optimizer):
            st = self.optimizer.state_dict()["state"]
            moments = {j: {k: (v.detach().cpu() if isinstance(
                v, torch.Tensor) else v) for k, v in st[j].items()}
                for j in st}
        else:
            step = torch.tensor(float(self.optimizer.step_count))
            moments = {j: {"step": step.clone(),
                           "exp_avg": m["exp_avg"].float().cpu(),
                           "exp_avg_sq": m["exp_avg_sq"].cpu()}
                       for j, m in self.optimizer.full_moments().items()}
        return ({k: v.detach().cpu() for k, v in
                 self.pipe.state_dict().items() if v.device.type != "meta"},
                {g: moments[j] for j, g in enumerate(self._global_index())
                 if j in moments})

    def _full_state(self, state: TrainState) -> Optional[TrainState]:
        """The one-device trainer's state of the whole model, gathered on
        the mesh's lead rank (None on the others; collective over the
        mesh's world)."""
        import torch.distributed as dist

        self._adopt(state)
        mesh = self.mesh
        part = self._own_state()
        mine = part if mesh.data == 0 else None
        size = mesh.n_stages * mesh.n_data
        got = [None] * size if mesh.rank == mesh.lead else None
        dist.gather_object(mine, got, dst=mesh.lead, group=mesh.world_group)
        if mesh.rank != mesh.lead:
            return None
        return self._whole_state([p for p in got if p is not None],
                                 state.step)

    def _whole_state(self, parts, step: int) -> TrainState:
        """The one-device trainer's :class:`TrainState` of the ranks'
        :meth:`_own_state` parts (together, the whole model)."""
        model, opt = {}, {}
        for part in parts:
            model.update(part[0])
            opt.update(part[1])
        tmpl = self._adam_template()
        tmpl["state"] = {g: opt[g] for g in sorted(opt)}
        return TrainState(model={k: model[k] for k in self.pipe.state_dict()},
                          optimizer=tmpl, step=step)

    def _adam_template(self) -> Dict[str, Any]:
        """An empty one-device optimizer state: ``torch.optim.Adam``'s over
        every parameter of the model, at the current learning rate."""
        tmpl = torch.optim.Adam(list(self.pipe.parameters()), lr=self.cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8).state_dict()
        tmpl["param_groups"][0]["lr"] = self.optimizer.param_groups[0]["lr"]
        return tmpl

    # --- stage shards (the elastic rung's buddy copies) ---

    def _shard_layout(self, stage: int) -> List[tuple]:
        """Stage ``stage``'s shard, entry by entry, as every rank can derive
        it from the model (another rank's tensors are ``meta`` here):
        ``(name, layer in the partition, shape, dtype)`` for each model
        tensor of the partition (``model/{key}``) and both Adam moments of
        each of its parameters (``exp_avg/{g}``, ``exp_avg_sq/{g}``, ``g``
        the parameter's index among all the model's)."""
        prefix = f"partitions.{stage}.layers."

        def layer(name):
            return int(name[len(prefix):].split(".", 1)[0])

        out = [(f"model/{k}", layer(k), t.shape, t.dtype)
               for k, t in self.pipe.state_dict().items()
               if k.startswith(prefix)]
        mu = _MU_DTYPES.get(self.cfg.mu_dtype)
        params = [(g, n, p) for g, (n, p) in
                  enumerate(self.pipe.named_parameters())
                  if n.startswith(prefix)]
        out += [(f"exp_avg/{g}", layer(n), p.shape, mu or p.dtype)
                for g, n, p in params]
        out += [(f"exp_avg_sq/{g}", layer(n), p.shape, p.dtype)
                for g, n, p in params]
        return out

    def _stage_shards(self):
        """This process's stage shards, ``{stage: tensors}`` in
        :meth:`_shard_layout` order (every stage on one device, this rank's
        over a mesh), and Adam's step count. Under ``zero`` the moments are
        gathered whole over the data group (collective)."""
        self._settle_steps()
        if isinstance(self.optimizer, torch.optim.Optimizer):
            self._guarded_tensors()          # Adam's state, made if empty
            params = list(self.pipe.parameters())
            moments = {g: self.optimizer.state[p]
                       for g, p in enumerate(params)}
            steps = int(moments[0]["step"])
        else:
            full = self.optimizer.full_moments()
            moments = {g: full[j] for j, g in enumerate(self._global_index())}
            steps = self.optimizer.step_count
        sd = self.pipe.state_dict()

        def tensor(name):
            kind, key = name.split("/", 1)
            return sd[key] if kind == "model" else moments[int(key)][kind]

        stages = (range(self.cfg.n_stages) if self.mesh is None
                  else [self.mesh.stage])
        return ({s: [tensor(e[0]) for e in self._shard_layout(s)]
                 for s in stages}, steps)

    def _state_from_shards(self, entries: Dict[str, torch.Tensor],
                           adam_steps: int, step: int) -> TrainState:
        """A one-device trainer's :class:`TrainState` (``torch.optim.Adam``'s
        state, indexed over the whole model) of the entries of
        :meth:`_shard_layout`: the whole model's, or some stages'."""
        scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
                  else torch.float32)
        order = {k: i for i, k in enumerate(self.pipe.state_dict())}
        model = {k[6:]: v for k, v in sorted(
            ((k, v) for k, v in entries.items() if k.startswith("model/")),
            key=lambda kv: order[kv[0][6:]])}
        index = sorted(int(k.split("/")[1]) for k in entries
                       if k.startswith("exp_avg/"))
        opt = ({"param_groups": copy.deepcopy(
            self.optimizer.state_dict()["param_groups"])} if isinstance(
            self.optimizer, torch.optim.Optimizer) else self._adam_template())
        opt["state"] = {g: {"step": torch.tensor(float(adam_steps),
                                                 dtype=scalar),
                            "exp_avg": entries[f"exp_avg/{g}"],
                            "exp_avg_sq": entries[f"exp_avg_sq/{g}"]}
                        for g in index}
        return TrainState(model=model, optimizer=opt, step=step)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights drawn from ``seed`` (default ``cfg.seed``) and an
        empty Adam state, loaded into the trainer: the live state at step 0."""
        fresh = self._build(self.cfg.seed if seed is None else seed)
        for dst, src in zip(self.pipe, fresh):
            if any(t.device.type == "meta" for t in dst.state_dict().values()):
                continue                  # another rank's layer
            dst.load_state_dict(src.state_dict())
        del fresh
        if isinstance(self.optimizer, torch.optim.Optimizer):
            self.optimizer.state.clear()
        else:
            self.optimizer.reset()
        self._pending_verdict = None
        return self._capture(0)

    def restore(self, directory: str, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """``restore_checkpoint`` of a checkpoint of this model (a
        one-device trainer's, or one this trainer saved), into ``template``'s
        devices; over a mesh each rank keeps its own tensors and
        :meth:`train_epoch` loads them."""
        from .state import restore_checkpoint

        if self.mesh is not None:       # the whole model's names
            template = TrainState(model=self.pipe.state_dict(),
                                  optimizer=template.optimizer,
                                  step=template.step)
        return restore_checkpoint(directory, template, step=step)

    def num_params(self, state: TrainState) -> int:
        if self.mesh is not None:              # the whole model's
            return sum(t.numel() for t in self.pipe.state_dict().values())
        return sum(t.numel() for t in state.model.values())

    def save(self, directory: str, state: TrainState,
             step: Optional[int] = None) -> None:
        """Write ``state`` as a checkpoint. Over a mesh every rank calls
        it: rank 0 writes the one-device trainer's files, the whole model
        and Adam state gathered from the ranks."""
        step = state.step if step is None else step
        if self.mesh is None:
            save_checkpoint(directory, state, step)
            return
        import torch.distributed as dist

        full = self._full_state(state)
        if full is not None:
            save_checkpoint(directory, full, step)
        dist.barrier(group=self.mesh.world_group)

    def install_autosave(self, directory: str,
                         signals: Optional[List[int]] = None) -> None:
        """Preemption-aware checkpointing: on SIGTERM (what a scheduler sends
        before reclaiming the machine) the in-flight step finishes, the
        state is saved into ``directory`` and the epoch loop stops. The
        handler only sets a flag; saving happens on the training thread
        between steps. Resume with ``restore_checkpoint`` and
        ``train_epoch(start_step=state.step)``."""
        import signal as _signal

        self._autosave_dir = directory
        self._stop_requested = False

        def _handler(signum, frame):
            self._stop_requested = True

        for sig in (signals if signals is not None
                    else [_signal.SIGTERM]):
            _signal.signal(sig, _handler)

    def _autosave_pending(self) -> bool:
        return self._stop_requested

    def _autosave(self, step: int, log_fn: Callable[[str], None]) -> None:
        self.save(self._autosave_dir, self._capture(step))
        log_fn(f"| autosave: step {step} checkpointed to "
               f"{self._autosave_dir} (stop requested)")

    def analytic_bubble(self) -> float:
        cfg = self.cfg
        if cfg.schedule == "interleaved":
            return InterleavedSchedule(v=cfg.interleave).device_bubble(
                cfg.chunks, cfg.n_stages)
        if cfg.schedule == "interleaved-1f1b":
            return InterleavedOneFOneBSchedule(
                interleave=cfg.interleave).bubble(cfg.chunks, cfg.n_stages)
        return bubble_fraction(cfg.chunks, cfg.n_stages)

    def generate(self, state: TrainState, prompt, *,
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: Optional[int] = None, num_beams: int = 1,
                 seed: int = 0) -> torch.Tensor:
        """Sample continuations of ``prompt [b, prompt_len]`` from
        ``state``'s weights: the trainer's own layers, wrapped by
        ``PipelinedLM.from_sequential`` with no copy, run the KV-cached
        ``Generator`` (sampling seeded with ``seed``). Over a mesh, as
        ``pipe_tpu`` gathers the stage-stacked params to the host: every
        rank of a pipeline gathers the whole model over its stage group
        (:meth:`_gathered_layers`, any layout, interleaved included) and
        runs the ``Generator`` on it, so every rank returns the same
        tokens; every rank of the mesh calls it."""
        from ..inference import GenerationConfig, Generator
        from ..ops.layers import Sequential

        self._adopt(state)
        layers = (list(self.pipe) if self.mesh is None
                  else self._gathered_layers())
        model = PipelinedLM.from_sequential(
            self.model_cfg, Sequential(layers), self.cfg.n_stages)
        gen = Generator(model, GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, num_beams=num_beams))
        return gen.generate(prompt, seed=seed)

    def _gathered_layers(self) -> list:
        """The whole model's layers on this rank's device, gathered over
        the stage group: each tensor broadcast from the stage that holds
        it, into a fresh ``build_sequential`` of the model's config (this
        trainer's own layers stay as they are)."""
        import torch.distributed as dist

        mesh = self.mesh
        seq = build_sequential(self.model_cfg, device=self.device)
        src = dict(self.pipe.named_parameters())
        src.update(self.pipe.named_buffers())
        names = list(src)
        mine = [n for n in names if src[n].device.type != "meta"]
        held = [None] * mesh.n_stages
        dist.all_gather_object(held, mine, group=mesh.column_group)
        owner = {}
        for stage, have in enumerate(held):
            for n in have:
                owner.setdefault(n, stage)
        dst = dict(seq.named_parameters())
        dst.update(seq.named_buffers())
        # a Pipe tensor's name, partitions.{j}.layers.{i}.*, is layers.{k}.*
        # in the model's Sequential
        offsets = np.cumsum([0] + [len(part) for part in
                                   self.pipe.partitions])
        with torch.no_grad():
            for n in names:
                _, j, _, i, rest = n.split(".", 4)
                t = mesh.broadcast_from(
                    src[n].detach() if owner[n] == mesh.stage else None,
                    owner[n])
                dst[f"layers.{offsets[int(j)] + int(i)}.{rest}"].copy_(t)
        return list(seq)

    # --- steps ---

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).long().to(self.device)

    def _loss_and_grads(self, data: np.ndarray, target: np.ndarray,
                        seed: int) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        tokens, targets = self._tensor(data), self._tensor(target)
        if self.scheduled is None:
            loss = lm_loss(self.pipe, tokens, targets, train=True, seed=seed)
            loss.backward()
        else:
            # zero-padded micro-batches and the mask of the real rows, as
            # pipe_tpu's Trainer feeds its ScheduledPipeline
            x, rows = mb.stack_scatter({"tokens": tokens, "targets": targets},
                                       self.cfg.chunks)
            loss, _ = self.scheduled.loss_and_grad(
                x, mb.valid_row_mask(x, rows), seed=seed)
        return loss.detach()

    def _step(self, data: np.ndarray, target: np.ndarray,
              seed: int) -> torch.Tensor:
        loss = self._loss_and_grads(data, target, seed)
        clip_by_global_norm([p.grad for p in self.params],
                            self.cfg.grad_clip, mesh=self.mesh)
        self.optimizer.step()
        return loss

    def _guarded_step(self, data: np.ndarray, target: np.ndarray, seed: int,
                      step: int, aux, inject: torch.Tensor,
                      magnitude: torch.Tensor,
                      kill: Optional[torch.Tensor] = None):
        """The resilient step: the plain step's update plus (a) the chaos
        faults selected by the ``inject`` code (with a plan) and (b)
        ``step_guard``'s verdict, which selects the pre-step parameters and
        Adam moments back in on a bad step (skip-step: the step counter
        still advances, so the LR and dropout-seed walk is unaffected).
        ``aux`` is ``(loss EWMA, consecutive anomalies, total anomalies)``
        on the device. The pre-step copies and the select are device work.
        Over a mesh the loss and the clip's norm are the world's, so every
        rank reaches the same verdict and selects back its own shard.

        The elastic step (``kill``, a 0-dim int32 kill code): the forward
        runs under ``kill_scope``, and ``aux`` carries a fourth entry, the
        ``[n_stages]`` int32 silent streaks, which a guard-accepted step
        advances where the stage's gradient heartbeat is exactly zero and
        resets elsewhere (a rejected step leaves them).
        Adam's step count is a host number, so before this step's update
        the host waits for the previous step's verdict (:meth:`_settle_steps`)
        and puts the count back if that step was skipped. That wait is one
        step behind: this step's forward and backward are already queued, so
        the device queue does not drain and the host runs at most one step
        ahead. The loop reads the verdict itself (a full sync) only every
        ``check_every`` steps. Returns ``(loss, aux)``."""
        from ..resilience.chaos import (apply_train_faults, inject_scope,
                                        kill_scope)
        from ..resilience.detect import step_guard

        rc = self.cfg.resilience
        with inject_scope(inject if self.chaos is not None else None), \
                kill_scope(kill):
            loss = self._loss_and_grads(data, target, seed)
        grads = [p.grad for p in self.params]
        if self.chaos is not None:
            loss, _ = apply_train_faults(inject, magnitude, loss, grads)
        beat = self._heartbeat() if kill is not None else None
        norm = clip_by_global_norm(grads, self.cfg.grad_clip, mesh=self.mesh)
        ewma, consec, total = aux[:3]
        ok, new_ewma = step_guard(
            loss, None, ewma, step, spike_factor=rc.spike_factor,
            warmup_steps=rc.warmup_steps, ewma_alpha=rc.ewma_alpha,
            gnorm=norm)
        live = self._guarded_tensors()
        if self._guard_bufs is None or len(self._guard_bufs) != len(live):
            self._guard_bufs = [torch.empty_like(t) for t in live]
        with torch.no_grad():
            torch._foreach_copy_(self._guard_bufs, live)
            self._settle_steps()
            self.optimizer.step()
            for t, old in zip(live, self._guard_bufs):
                torch.where(ok, t, old, out=t)
        self._hold_verdict(ok)
        bad = (~ok).to(total.dtype)
        new_aux = (new_ewma, torch.where(ok, torch.zeros_like(consec),
                                         consec + 1), total + bad)
        if beat is not None:
            hb = aux[3]
            streak = torch.where(beat == 0, hb + 1, torch.zeros_like(hb))
            new_aux += (torch.where(ok, streak, hb),)
        return loss, new_aux

    def _heartbeat(self) -> torch.Tensor:
        """``stage_heartbeat`` of each stage's block gradients, ``[n_stages]``
        float32: exactly 0.0 for a stage whose output a kill zeroed and for
        every stage before it. Over a mesh this rank beats for its own
        stage and the vector is summed over its pipeline."""
        from ..resilience.detect import stage_heartbeat

        def beat(blocks):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for m in blocks for p in m.parameters()]
            return stage_heartbeat([g.unsqueeze(0) for g in grads], 1)

        if self.mesh is None:
            return torch.cat([beat(b) for b in self._stage_blocks])
        out = torch.zeros(self.cfg.n_stages, device=self.device)
        out[self.mesh.stage] = beat(self._stage_blocks[self.mesh.stage])[0]
        self.mesh.all_reduce(out, "stage")
        return out

    def elastic_store(self):
        """The trainer's buddy-replication store, made on first use. It
        lives on the trainer, not the epoch, so the snapshot survives the
        ``StageLost`` raise and ``replan_after_loss`` restores from it."""
        if self._buddy_store is None:
            from ..resilience.elastic import BuddyStore
            el = self.cfg.elastic
            self._buddy_store = BuddyStore(
                self, verify=getattr(el, "verify_replication", True),
                registry=self.registry, events=self.events,
                snapshot_dir=getattr(el, "snapshot_dir", None))
        return self._buddy_store

    def _guarded_tensors(self) -> List[torch.Tensor]:
        """The parameters and both Adam moments, the moments created as
        ``torch.optim.Adam`` creates them at its first step (zeros, step
        0) so that a skipped first step has a state to keep. Under
        ``ShardedAdam`` the moments are its flat buffers (this rank's
        shard under ``zero``, the first moment in ``mu_dtype``)."""
        if not isinstance(self.optimizer, torch.optim.Optimizer):
            opt = self.optimizer
            return (list(self.params) + list(opt.exp_avg.values())
                    + list(opt.exp_avg_sq.values()))
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
                  else torch.float32)
        for p in params:
            st = self.optimizer.state[p]
            if not st:
                st["step"] = torch.tensor(0.0, dtype=scalar)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        states = [self.optimizer.state[p] for p in params]
        return (params + [st["exp_avg"] for st in states]
                + [st["exp_avg_sq"] for st in states])

    def _hold_verdict(self, ok: torch.Tensor) -> None:
        """Keep the step's verdict for :meth:`_settle_steps`: on a card, a
        copy into pinned host memory queued behind the step, and an event
        that marks it done."""
        if ok.device.type != "cuda":
            self._pending_verdict = (ok, None)
            return
        if getattr(self, "_verdict_host", None) is None:
            self._verdict_host = torch.empty((), dtype=torch.bool,
                                             pin_memory=True)
        self._verdict_host.copy_(ok, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending_verdict = (self._verdict_host, done)

    def _settle_steps(self) -> None:
        """Put Adam's step count back if the last guarded step was
        skipped. Adam keeps the count on the host and folds it into its
        bias corrections there, so it is settled from the verdict before
        the next update and before any state capture. On a card this waits
        on the event recorded after that step."""
        pending, self._pending_verdict = self._pending_verdict, None
        if pending is None:
            return
        verdict, done = pending
        if done is not None:
            done.synchronize()
        if bool(verdict):
            return
        if not isinstance(self.optimizer, torch.optim.Optimizer):
            self.optimizer.step_count -= 1
            return
        for st in self.optimizer.state.values():
            if "step" in st:
                st["step"].sub_(1)

    def _batches(self, source: np.ndarray, n: int, start: int = 0):
        """Full (data, target) batches ``start`` .. ``n``-1, stopping at the
        first short tail batch. With ``prefetch_depth > 0`` (and a C++
        toolchain) they are assembled on the native producer thread
        (``data/native.py``), each slot copied before it is handed out (the
        producer may overwrite it once the iterator moves on); otherwise
        inline by ``get_batch``. ``start`` is the resume hook of
        ``resilience.RetryingIterator``."""
        cfg = self.cfg
        if cfg.prefetch_depth > 0:
            from ..data.native import BatchPrefetcher, prefetch_available
            if prefetch_available():
                with BatchPrefetcher(source, cfg.bptt,
                                     depth=cfg.prefetch_depth) as pf:
                    for i, (d, t) in enumerate(pf):
                        if i >= n:
                            break
                        if i >= start:
                            yield d.copy(), t.copy()
                return
        for b in range(start, n):
            data, target = lm_text.get_batch(source, b * cfg.bptt, cfg.bptt)
            if data.shape[1] < cfg.bptt:
                return
            yield data, target

    # --- epochs ---

    def train_epoch(self, source: np.ndarray, epoch: int = 0,
                    state: Optional[TrainState] = None,
                    max_steps: Optional[int] = None,
                    log_every: int = 10,
                    log_fn: Callable[[str], None] = print,
                    start_step: int = 0):
        """One pass over ``source`` (a ``batchify``'d id matrix); returns
        ``(state, {"loss", "losses", "steps", "sec_per_step"})`` (``losses``
        one a step), plus ``anomalies``,
        ``rewinds`` and ``loss_ewma`` under ``cfg.resilience``, and
        ``buddy_snapshots`` and ``loss_by_step`` (keyed by the global batch
        index) under ``cfg.elastic``, whose controller may raise
        ``StageLost`` (``resilience.elastic.train_elastic`` recovers).

        The learning rate is ``cfg.lr * cfg.lr_gamma ** epoch`` (StepLR);
        batch ``b`` is the global batch index ``start_step + i``, and its
        dropout seed is folded from ``(cfg.seed, epoch, b)``, so a resumed
        epoch replays what an uninterrupted one would.

        With ``telemetry_dir`` each step's ``StepReport`` carries the wall
        time from the previous step's report to its own, after the step's
        syncs (the first and the logged steps read the loss back): the loop
        does not synchronize every step, so one step's time is honest only
        at a sync point, but the times add up to the loop's elapsed time.
        ``compile_inclusive`` marks the first step.
        """
        cfg = self.cfg
        state = self.init_state() if state is None else state
        self._adopt(state)
        step = state.step
        lr = cfg.lr * cfg.lr_gamma ** epoch  # StepLR, main.py:185
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        n = lm_text.num_batches(source, cfg.bptt)
        if max_steps is not None:
            n = min(n, max_steps)
        key = fold_seed(cfg.seed, epoch)
        tokens_per_step = cfg.batch_size * cfg.bptt
        telemetry_on = self.events is not ev.NULL_EVENT_LOG
        steps_ctr = self.registry.counter("train.steps")
        tokens_ctr = self.registry.counter("train.tokens")
        step_timer = self.registry.timer("train.step_sec")
        tps_gauge = self.registry.gauge("train.tokens_per_sec")
        peak = kind = None
        if telemetry_on:
            cuda = self.device.type == "cuda"
            peak = peak_flops_per_chip(self.model_cfg.compute_dtype,
                                       self.device)
            kind = torch.cuda.get_device_name(self.device) if cuda else "cpu"
            self.events.event("device", device_kind=kind, peak_flops=peak,
                              card=card_name_and_power_limit()
                              if cuda else None)

        rc = cfg.resilience
        resil = aux = elastic = kill = None
        if rc is not None:
            from ..resilience.recover import (ResilienceController,
                                              RetryingIterator)
            resil = ResilienceController(rc, self.registry, self.events,
                                         log_fn=log_fn)
            dev = self.device
            aux = (torch.zeros((), device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))
            inject = torch.zeros((), dtype=torch.int32, device=dev)
            magnitude = torch.ones((), device=dev)
            if cfg.elastic is not None:
                from ..resilience.chaos import KILL_NONE
                from ..resilience.elastic import ElasticController
                elastic = ElasticController(
                    cfg.elastic, self.elastic_store(),
                    registry=self.registry, events=self.events,
                    log_fn=log_fn)
                aux = aux + (torch.zeros(cfg.n_stages, dtype=torch.int32,
                                         device=dev),)
                kill = torch.full((), KILL_NONE, dtype=torch.int32,
                                  device=dev)
            batch_iter = RetryingIterator(
                lambda pos: self._batches(source, n, start=pos),
                retries=rc.data_retries, backoff_s=rc.data_backoff_s,
                chaos=self.chaos, registry=self.registry,
                events=self.events, start=start_step)
        else:
            batch_iter = self._batches(source, n, start_step)

        t_first = t0 = t_mark = time.perf_counter()
        losses = []
        for i, (data, target) in enumerate(batch_iter):
            b = start_step + i
            seed = fold_seed(key, b)
            tracing = bool(telemetry_on and cfg.profile_every
                           and (b + 1) % cfg.profile_every == 0)
            with contextlib.ExitStack() as scopes:
                if telemetry_on:
                    scopes.enter_context(self.events.span(ev.STEP, step=b,
                                                          epoch=epoch))
                if tracing:
                    trace_dir = os.path.join(cfg.telemetry_dir,
                                             f"trace_step{b + 1}")
                    scopes.enter_context(profile_trace(trace_dir))
                if resil is None:
                    loss = self._step(data, target, seed)
                else:
                    if self.chaos is not None:
                        code, mag = self.chaos.train_inject(b)
                        inject.fill_(code)
                        magnitude.fill_(mag)
                        if kill is not None:
                            kill.fill_(self.chaos.train_kill(b))
                    loss, aux = self._guarded_step(data, target, seed, step,
                                                   aux, inject, magnitude,
                                                   kill)
            step += 1
            steps_ctr.inc()
            tokens_ctr.inc(tokens_per_step)
            losses.append(loss)
            at_log = bool(log_every and (b + 1) % log_every == 0)
            if i == 0:
                float(loss)                   # the first step, warm-up
                t0 = time.perf_counter()      # steady-state timing from step 2
            l = float(loss) if at_log else None
            if telemetry_on:
                now = time.perf_counter()
                wall, t_mark = now - t_mark, now
                step_timer.observe(wall)
                if wall > 0:
                    tps_gauge.set(tokens_per_step / wall)
                if tracing:
                    self.events.event("profile_trace", step=b,
                                      path=trace_dir)
                report = StepReport.compute(
                    step=step, wall_sec=wall, tokens=tokens_per_step,
                    n_stages=cfg.n_stages, chunks=cfg.chunks,
                    checkpoint=cfg.checkpoint, schedule=cfg.schedule,
                    loss=l, model_cfg=self.model_cfg,
                    analytic_bubble=self.analytic_bubble(),
                    memory=(device_memory_peaks(self.device)
                            if at_log or i == 0 else {}),
                    compile_inclusive=(i == 0), peak_flops=peak,
                    platform="gpu" if self.device.type == "cuda" else "cpu",
                    device_kind=kind, n_devices=1, epoch=epoch)
                self.events.step_report(report)
                if self.tb is not None and at_log:
                    for tag, val in report.scalar_items():
                        self.tb.add_scalar(tag, val, step)
            if resil is not None and (b + 1) % rc.check_every == 0:
                # the verdict is read on the check cadence only (the host
                # waits for the device here): rewind/abort may load a
                # known-good copy or raise TrainingAborted after the budget;
                # the heartbeat streaks ride outside the numeric triple and
                # survive a rewind
                live = self._capture(step)
                kept, aux3 = resil.after_step(b, live, aux[:3])
                aux = aux3 + aux[3:]
                if kept is not live:
                    self._adopt(kept)
                    step = kept.step
            if elastic is not None and (b + 1) % cfg.elastic.check_every == 0:
                # buddy capture on the healthy cadence; StageLost once a
                # stage's silent streak reaches dead_after
                elastic.after_step(b, self._capture(step), aux)
            if self._autosave_pending():
                self._autosave(step, log_fn)
                break
            if at_log:
                dt = ((time.perf_counter() - t0) / i if i >= 1
                      else time.perf_counter() - t_first)
                log_fn(f"| epoch {epoch} | step {b+1}/{n} "
                       f"| lr {lr:.3f} "
                       f"| ms/batch {dt*1000:.1f} "
                       f"| tok/s {tokens_per_step/dt:,.0f} "
                       f"| loss {l:.3f} | ppl {np.exp(min(l, 20.0)):.2f} "
                       f"| bubble {self.analytic_bubble():.1%}")
                if self.tb is not None:
                    self.tb.add_scalar("train/loss", l, step)
                    self.tb.add_scalar("train/ppl",
                                       float(np.exp(min(l, 20.0))), step)
                    self.tb.add_scalar("train/tok_s",
                                       tokens_per_step / dt, step)
                    self.tb.add_scalar("train/ms_batch", dt * 1000, step)
                    self.tb.add_scalar("train/lr", lr, step)
                    self.tb.add_scalar("pipeline/bubble",
                                       self.analytic_bubble(), step)
                    self.tb.flush()  # visible live; a crash loses nothing
        final = float(losses[-1]) if losses else float("nan")
        if self.tb is not None and losses:
            self.tb.add_scalar("train/epoch_loss", final, step)
            self.tb.flush()
        if telemetry_on:
            self.events.metrics_snapshot(self.registry)
            self.events.flush()
        info = {"loss": final,
                "losses": [float(l) for l in losses],
                "steps": len(losses),
                "sec_per_step": (time.perf_counter() - t0)
                / max(len(losses) - 1, 1)}
        if resil is not None:
            info["anomalies"] = resil.anomalies
            info["rewinds"] = resil.rewinds
            info["loss_ewma"] = float(aux[0])
        if elastic is not None:
            info["buddy_snapshots"] = elastic.snapshots
            info["loss_by_step"] = {start_step + i: l for i, l in
                                    enumerate(info["losses"])}
        return self._capture(step), info

    def evaluate(self, source: np.ndarray, state: TrainState,
                 max_steps: Optional[int] = None) -> float:
        """Mean eval loss over ``source`` (reference ``evaluate``,
        ``main.py:275-289``); logged to ``eval/loss`` with ``tb_dir``."""
        cfg = self.cfg
        self._adopt(state)
        n = lm_text.num_batches(source, cfg.bptt)
        if max_steps is not None:
            n = min(n, max_steps)
        total, count = 0.0, 0
        with torch.no_grad():
            for b in range(n):
                data, target = lm_text.get_batch(source, b * cfg.bptt,
                                                 cfg.bptt)
                if data.shape[1] < cfg.bptt:
                    break
                if self.mesh is None:
                    loss = lm_loss(self.pipe, self._tensor(data),
                                   self._tensor(target), train=False)
                else:
                    x, rows = mb.stack_scatter(
                        {"tokens": self._tensor(data),
                         "targets": self._tensor(target)}, cfg.chunks)
                    w = mb.valid_row_mask(x, rows)
                    loss = (self.eval_exec(x) * w).sum() / w.sum()
                total += float(loss) * data.size
                count += data.size
        mean = total / max(count, 1)
        if self.tb is not None and count:
            self.tb.add_scalar("eval/loss", mean, state.step)
            self.tb.flush()
        return mean
