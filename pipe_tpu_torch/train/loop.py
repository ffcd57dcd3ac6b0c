"""Training loop for the pipelined tutorial LM.

Counterpart of ``pipe_tpu/train/loop.py`` (reference ``main.py:180-234``):
Adam + StepLR(gamma 0.95 per epoch) + global-norm clip 0.5, cross-entropy on
the last stage, the same log line. The model is the tutorial LM as a
``Sequential`` under ``Pipe``, cut where ``PipelinedLM`` cuts it
(``pipelined_lm_balance``). ``schedule="gpipe"`` trains through ``Pipe``
(GPipe on the serial emulator); ``"1f1b"``, ``"zb-h1"`` and
``"interleaved-1f1b"`` train through the table executor
(``parallel/scheduled.py``) over ``PipelinedLM.from_sequential`` of the same
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
clock read or file write of its own. ``schedule="interleaved"`` (the
interleaved executors), ZeRO, ``mu_dtype``, ``n_data`` and elastic training
are not ported yet: their ``TrainerConfig`` values raise
``NotImplementedError``.
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
from ..core.schedule import InterleavedOneFOneBSchedule, bubble_fraction
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
from ..parallel.scheduled import ScheduledPipeline
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


# Schedules the trainer runs; "interleaved" needs the interleaved executors
# of parallel/interleaved.py (ROADMAP.md A.8).
_SCHEDULES = ("gpipe", "1f1b", "zb-h1", "interleaved-1f1b")

# (field, its default, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("n_data", 1, "queue A, the multi-device executors"),
    ("mu_dtype", None, "queue A, ZeRO and optimizer-state options"),
    ("zero", False, "queue A, ZeRO and optimizer-state options"),
    ("elastic", None, "A.7/A.8, resilience/elastic.py"),
)


def _check_ported(cfg: TrainerConfig) -> None:
    if cfg.schedule == "interleaved":
        raise NotImplementedError(
            f"TrainerConfig.schedule={cfg.schedule!r} is not ported to "
            f"pipe_tpu_torch yet (ROADMAP.md: A.8, the interleaved executors "
            f"of parallel/interleaved.py)")
    if cfg.schedule not in _SCHEDULES:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    for name, default, item in _NOT_PORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"TrainerConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"to pipe_tpu_torch yet (ROADMAP.md: {item})")


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
    the split the port runs: its zb-h1 under ``never`` is the stored-graph
    B/W split (ROADMAP.md C.7), whatever split the plan was priced at."""
    plan = cfg.plan
    line = (f"plan resolved: schedule={cfg.schedule} chunks={cfg.chunks} "
            f"interleave={cfg.interleave} checkpoint={cfg.checkpoint}")
    if cfg.schedule == "zb-h1":
        line += (" split=stored-graph (priced "
                 f"split_stage={plan.split_stage})"
                 if cfg.checkpoint == "never" else
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
                        max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: left alone when the global
    norm is below ``max_norm``, else ``g / norm * max_norm``. Unlike
    ``torch.nn.utils.clip_grad_norm_`` it adds nothing to the norm, and it
    reads nothing back to the host. Returns the norm before clipping (the
    guarded step's ``step_guard`` reads it)."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
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
                 device=DEFAULT_DEVICE, chaos=None):
        if cfg.plan is not None:
            cfg = _resolve_plan_config(model_cfg, cfg)
        _check_ported(cfg)
        if chaos is not None:
            chaos.check_ported()
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.chaos = chaos
        self.device = resolve_device(device)
        self.pipe = Pipe(self._build(cfg.seed), chunks=cfg.chunks,
                         checkpoint=cfg.checkpoint,
                         balance=pipelined_lm_balance(model_cfg.n_layers,
                                                      cfg.n_stages),
                         device=self.device)
        self.scheduled = self._build_scheduled()
        if chaos is not None:
            from ..resilience.chaos import poison_activations
            # the embedding's output, in Pipe and in the tables' pre_fn
            self.pipe[1].register_forward_hook(
                lambda module, args, out: poison_activations(out))
        # optax.scale_by_adam(0.9, 0.999, eps 1e-8) then -lr * u.
        self.optimizer = torch.optim.Adam(self.pipe.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._state: Optional[TrainState] = None
        self.tb = None
        if cfg.tb_dir is not None:
            from ..obs.tb_writer import ScalarWriter
            self.tb = ScalarWriter(cfg.tb_dir)
        # The registry (cheap counters) and the event log; with no
        # telemetry_dir the log is the shared null sink.
        self.registry = get_registry()
        self.events: Any = ev.NULL_EVENT_LOG
        if cfg.telemetry_dir is not None:
            os.makedirs(cfg.telemetry_dir, exist_ok=True)
            self.events = ev.EventLog(
                os.path.join(cfg.telemetry_dir, "events.jsonl"))
        self._stop_requested = False
        self._autosave_dir: Optional[str] = None
        self._guard_bufs: Optional[List[torch.Tensor]] = None
        self._pending_verdict = None

    def _build_scheduled(self) -> Optional[ScheduledPipeline]:
        """The table executor for ``1f1b``/``zb-h1``/``interleaved-1f1b``
        (and for ``gpipe`` with ``loss_block``, whose fused loss lives on
        the last stage), over ``PipelinedLM.from_sequential`` of the
        ``Pipe``'s own modules: one set of weights, one state dict. None:
        ``Pipe`` trains."""
        cfg = self.cfg
        if cfg.schedule == "gpipe" and not self.model_cfg.loss_block:
            return None
        if cfg.schedule == "zb-h1" and cfg.checkpoint != "never":
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
        if schedule == "interleaved-1f1b":
            # n_stages devices' worth of tables, each hosting `interleave`
            # virtual stages: the model factors into n_stages*interleave
            schedule = InterleavedOneFOneBSchedule(interleave=cfg.interleave)
            n_virtual = cfg.n_stages * cfg.interleave
        self.model = PipelinedLM.from_sequential(
            self.model_cfg, Sequential(list(self.pipe)), n_virtual)
        return ScheduledPipeline(
            self.model.stage_fn, self.model.pre_fn, self.model.loss_post_fn,
            n_stages=cfg.n_stages, module=self.model,
            checkpoint=cfg.checkpoint, schedule=schedule,
            device=self.device)

    def _build(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return build_sequential(self.model_cfg, device=self.device,
                                generator=gen)

    # --- state ---

    def _capture(self, step: int) -> TrainState:
        self._settle_steps()
        self._state = TrainState(model=self.pipe.state_dict(),
                                 optimizer=self.optimizer.state_dict(),
                                 step=step)
        return self._state

    def _adopt(self, state: TrainState) -> None:
        if state is self._state:
            return
        self._pending_verdict = None      # the live state it was for goes
        self.pipe.load_state_dict(state.model)
        self.optimizer.load_state_dict(copy.deepcopy(state.optimizer))
        self._state = None

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights drawn from ``seed`` (default ``cfg.seed``) and an
        empty Adam state, loaded into the trainer: the live state at step 0."""
        fresh = self._build(self.cfg.seed if seed is None else seed)
        for dst, src in zip(self.pipe, fresh):
            dst.load_state_dict(src.state_dict())
        self.optimizer.state.clear()
        self._pending_verdict = None
        return self._capture(0)

    def num_params(self, state: TrainState) -> int:
        return sum(t.numel() for t in state.model.values())

    def save(self, directory: str, state: TrainState,
             step: Optional[int] = None) -> None:
        save_checkpoint(directory, state, state.step if step is None else step)

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
        ``Generator`` (sampling seeded with ``seed``)."""
        from ..inference import GenerationConfig, Generator
        from ..ops.layers import Sequential

        self._adopt(state)
        model = PipelinedLM.from_sequential(
            self.model_cfg, Sequential(list(self.pipe)), self.cfg.n_stages)
        gen = Generator(model, GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, num_beams=num_beams))
        return gen.generate(prompt, seed=seed)

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
        clip_by_global_norm([p.grad for p in self.pipe.parameters()],
                            self.cfg.grad_clip)
        self.optimizer.step()
        return loss

    def _guarded_step(self, data: np.ndarray, target: np.ndarray, seed: int,
                      step: int, aux, inject: torch.Tensor,
                      magnitude: torch.Tensor):
        """The resilient step: the plain step's update plus (a) the chaos
        faults selected by the ``inject`` code (with a plan) and (b)
        ``step_guard``'s verdict, which selects the pre-step parameters and
        Adam moments back in on a bad step (skip-step: the step counter
        still advances, so the LR and dropout-seed walk is unaffected).
        ``aux`` is ``(loss EWMA, consecutive anomalies, total anomalies)``
        on the device. The pre-step copies and the select are device work.
        Adam's step count is a host number, so before this step's update
        the host waits for the previous step's verdict (:meth:`_settle_steps`)
        and puts the count back if that step was skipped. That wait is one
        step behind: this step's forward and backward are already queued, so
        the device queue does not drain and the host runs at most one step
        ahead. The loop reads the verdict itself (a full sync) only every
        ``check_every`` steps. Returns ``(loss, aux)``."""
        from ..resilience.chaos import apply_train_faults, inject_scope
        from ..resilience.detect import step_guard

        rc = self.cfg.resilience
        with inject_scope(inject if self.chaos is not None else None):
            loss = self._loss_and_grads(data, target, seed)
        grads = [p.grad for p in self.pipe.parameters()]
        if self.chaos is not None:
            loss, _ = apply_train_faults(inject, magnitude, loss, grads)
        norm = clip_by_global_norm(grads, self.cfg.grad_clip)
        ewma, consec, total = aux
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
        return loss, (new_ewma, torch.where(ok, torch.zeros_like(consec),
                                            consec + 1), total + bad)

    def _guarded_tensors(self) -> List[torch.Tensor]:
        """The parameters and both Adam moments, the moments created as
        ``torch.optim.Adam`` creates them at its first step (zeros, step
        0) so that a skipped first step has a state to keep."""
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
        if not bool(verdict):
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
        ``(state, {"loss", "steps", "sec_per_step"})``, plus ``anomalies``,
        ``rewinds`` and ``loss_ewma`` under ``cfg.resilience``.

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
        resil = aux = None
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
                    loss, aux = self._guarded_step(data, target, seed, step,
                                                   aux, inject, magnitude)
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
                # known-good copy or raise TrainingAborted after the budget
                live = self._capture(step)
                kept, aux = resil.after_step(b, live, aux)
                if kept is not live:
                    self._adopt(kept)
                    step = kept.step
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
                "steps": len(losses),
                "sec_per_step": (time.perf_counter() - t0)
                / max(len(losses) - 1, 1)}
        if resil is not None:
            info["anomalies"] = resil.anomalies
            info["rewinds"] = resil.rewinds
            info["loss_ewma"] = float(aux[0])
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
                loss = lm_loss(self.pipe, self._tensor(data),
                               self._tensor(target), train=False)
                total += float(loss) * data.size
                count += data.size
        mean = total / max(count, 1)
        if self.tb is not None and count:
            self.tb.add_scalar("eval/loss", mean, state.step)
            self.tb.flush()
        return mean
