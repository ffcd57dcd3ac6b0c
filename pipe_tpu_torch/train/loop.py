"""Training loop for the pipelined tutorial LM.

Counterpart of ``pipe_tpu/train/loop.py`` (reference ``main.py:180-234``):
Adam + StepLR(gamma 0.95 per epoch) + global-norm clip 0.5, cross-entropy on
the last stage's logits, the same log line. The model is the tutorial LM as a
``Sequential`` under ``Pipe`` (GPipe on the serial emulator), cut where
``PipelinedLM`` cuts it (``pipelined_lm_balance``). The other executors,
ZeRO, telemetry, TensorBoard, prefetch, resilience, elastic training and the
planner are not ported yet: their ``TrainerConfig`` fields raise
``NotImplementedError`` when set away from their defaults.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..core.partition import fold_seed
from ..core.schedule import bubble_fraction
from ..data import lm_text
from ..models.common import per_row_ce
from ..models.transformer_lm import (LMConfig, PipelinedLM,
                                     build_sequential, pipelined_lm_balance)
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


# (field, its default, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("schedule", "gpipe", "queue A, the 1F1B / zb / interleaved executors"),
    ("n_data", 1, "queue A, the multi-device executors"),
    ("mu_dtype", None, "queue A, ZeRO and optimizer-state options"),
    ("zero", False, "queue A, ZeRO and optimizer-state options"),
    ("tb_dir", None, "queue A, telemetry and TensorBoard hooks"),
    ("telemetry_dir", None, "queue A, telemetry and TensorBoard hooks"),
    ("profile_every", 0, "queue A, telemetry and TensorBoard hooks"),
    ("prefetch_depth", 0, "queue A, data/native.py"),
    ("resilience", None, "queue A, resilience/*"),
    ("elastic", None, "queue A, resilience/*"),
    ("plan", None, "queue A, the planner"),
)


def _check_ported(cfg: TrainerConfig) -> None:
    for name, default, item in _NOT_PORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"TrainerConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"to pipe_tpu_torch yet (ROADMAP.md: {item})")


def lm_loss(pipe: Pipe, tokens: torch.Tensor, targets: torch.Tensor, *,
            train: bool, seed: Optional[int] = None) -> torch.Tensor:
    """Mean over the batch's rows of ``per_row_ce`` of the pipeline's logits.

    ``Pipe`` gathers the ``[batch, seq, vocab]`` logits before the loss (at
    the tutorial's width that is 32 x 128 x vocab floats, a few hundred MB);
    the JAX trainer computes the loss per micro-batch on the last stage
    instead. A batch that ``chunks`` does not divide is split unevenly by
    ``Pipe``, so every row is real and the mean is the JAX trainer's
    row-masked mean over its zero-padded batch.
    """
    return per_row_ce(pipe(tokens, train=train, seed=seed), targets).mean()


def clip_by_global_norm(grads: Iterable[torch.Tensor],
                        max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: left alone when the global
    norm is below ``max_norm``, else ``g / norm * max_norm``. Unlike
    ``torch.nn.utils.clip_grad_norm_`` it adds nothing to the norm, and it
    reads nothing back to the host."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)


class Trainer:
    """Builds the LM, ``Pipe`` and Adam on ``device`` and runs epochs.

    The model and optimizer live in the trainer and are updated in place.
    A :class:`TrainState` it returns shares their tensors: it is the live
    state, and training on moves it on (clone its tensors to keep a copy). A
    state from elsewhere (a checkpoint, another run) is copied in when it is
    passed to :meth:`train_epoch` or :meth:`evaluate`.
    """

    def __init__(self, model_cfg: LMConfig, cfg: TrainerConfig,
                 device=DEFAULT_DEVICE):
        _check_ported(cfg)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pipe = Pipe(self._build(cfg.seed), chunks=cfg.chunks,
                         checkpoint=cfg.checkpoint,
                         balance=pipelined_lm_balance(model_cfg.n_layers,
                                                      cfg.n_stages),
                         device=self.device)
        # optax.scale_by_adam(0.9, 0.999, eps 1e-8) then -lr * u.
        self.optimizer = torch.optim.Adam(self.pipe.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._state: Optional[TrainState] = None

    def _build(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return build_sequential(self.model_cfg, device=self.device,
                                generator=gen)

    # --- state ---

    def _capture(self, step: int) -> TrainState:
        self._state = TrainState(model=self.pipe.state_dict(),
                                 optimizer=self.optimizer.state_dict(),
                                 step=step)
        return self._state

    def _adopt(self, state: TrainState) -> None:
        if state is self._state:
            return
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
        return self._capture(0)

    def num_params(self, state: TrainState) -> int:
        return sum(t.numel() for t in state.model.values())

    def save(self, directory: str, state: TrainState,
             step: Optional[int] = None) -> None:
        save_checkpoint(directory, state, state.step if step is None else step)

    def analytic_bubble(self) -> float:
        return bubble_fraction(self.cfg.chunks, self.cfg.n_stages)

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

    def _step(self, data: np.ndarray, target: np.ndarray,
              seed: int) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(self.pipe, self._tensor(data), self._tensor(target),
                       train=True, seed=seed)
        loss.backward()
        clip_by_global_norm([p.grad for p in self.pipe.parameters()],
                            self.cfg.grad_clip)
        self.optimizer.step()
        return loss.detach()

    def _batches(self, source: np.ndarray, n: int, start: int = 0):
        """Full (data, target) batches ``start`` .. ``n``-1, stopping at the
        first short tail batch."""
        for b in range(start, n):
            data, target = lm_text.get_batch(source, b * self.cfg.bptt,
                                             self.cfg.bptt)
            if data.shape[1] < self.cfg.bptt:
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
        ``(state, {"loss", "steps", "sec_per_step"})``.

        The learning rate is ``cfg.lr * cfg.lr_gamma ** epoch`` (StepLR);
        batch ``b`` is the global batch index ``start_step + i``, and its
        dropout seed is folded from ``(cfg.seed, epoch, b)``, so a resumed
        epoch replays what an uninterrupted one would.
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

        t_first = t0 = time.perf_counter()
        losses = []
        for i, (data, target) in enumerate(self._batches(source, n,
                                                         start_step)):
            b = start_step + i
            losses.append(self._step(data, target, fold_seed(key, b)))
            step += 1
            if i == 0:
                float(losses[0])              # the first step, warm-up
                t0 = time.perf_counter()      # steady-state timing from step 2
            if log_every and (b + 1) % log_every == 0:
                l = float(losses[-1])
                dt = ((time.perf_counter() - t0) / i if i >= 1
                      else time.perf_counter() - t_first)
                log_fn(f"| epoch {epoch} | step {b+1}/{n} "
                       f"| lr {lr:.3f} "
                       f"| ms/batch {dt*1000:.1f} "
                       f"| tok/s {tokens_per_step/dt:,.0f} "
                       f"| loss {l:.3f} | ppl {np.exp(min(l, 20.0)):.2f} "
                       f"| bubble {self.analytic_bubble():.1%}")
        final = float(losses[-1]) if losses else float("nan")
        info = {"loss": final,
                "steps": len(losses),
                "sec_per_step": (time.perf_counter() - t0)
                / max(len(losses) - 1, 1)}
        return self._capture(step), info

    def evaluate(self, source: np.ndarray, state: TrainState,
                 max_steps: Optional[int] = None) -> float:
        """Mean eval loss over ``source`` (reference ``evaluate``,
        ``main.py:275-289``)."""
        cfg = self.cfg
        self._adopt(state)
        n = lm_text.num_batches(source, cfg.bptt)
        if max_steps is not None:
            n = min(n, max_steps)
        total, count = 0.0, 0
        with torch.no_grad():
            for data, target in self._batches(source, n):
                loss = lm_loss(self.pipe, self._tensor(data),
                               self._tensor(target), train=False)
                total += float(loss) * data.size
                count += data.size
        return total / max(count, 1)
