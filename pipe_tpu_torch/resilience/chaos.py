"""Deterministic fault injection: seeded, step/tick-indexed ChaosPlans.

Counterpart of ``pipe_tpu/resilience/chaos.py``. A :class:`ChaosPlan` is a
static list of :class:`Fault`\\ s, each firing at a known step (train) or
tick (serve) index for a known duration: everything decided up front,
nothing random at run time (the ``seed`` only derives payload content,
never whether a fault fires).

Every fault kind of ``pipe_tpu`` is accepted in a plan, with its injection
site:

==================  =======================================================
``nan_grads``       gradients scaled by NaN inside the guarded train step
``inf_grads``       gradients scaled by +inf inside the guarded train step
``nan_loss``        the step loss replaced by NaN
``loss_spike``      the step loss scaled by ``magnitude`` (default 1e3)
``nan_activations`` the pre-stage activations scaled by NaN (the wrapped
                    ``pre_fn``; corrupts loss and grads the way a real
                    numeric blowup does)
``data_raise``      :class:`ChaosError` raised from the data iterator
``transport_drop``  a stage-boundary hop zeroed in the emulator executor
``transport_corrupt`` the same hop scaled by NaN instead
``persistent_hop_drop`` the hop leaving ``stage`` zeroed for every
                    micro-batch (feeds :class:`~.detect.HopHealth`)
``wire_partition``  fleet process wire: the parent drops the covered
                    outgoing frame, severs the connection and refuses the
                    child's re-dial for ``magnitude`` seconds (capped 30s)
``wire_delay``      the covered outgoing frame held ``magnitude`` seconds
                    (capped 5s) before send
``wire_corrupt``    the covered frame's last byte flipped after the
                    checksum, so the receiver's CRC32 rejects it
``wire_dup``        the covered frame sent twice (sequence dedup collapses
                    them)
``stall_tick``      the serve engine sleeps ``magnitude`` seconds in-tick
``queue_flood``     the serve queue force-filled to capacity with junk
``backend_raise``   :class:`ChaosError` raised at the next backend prefill
``wedge_replica``   router fleet: replica ``stage``'s decode raises while
                    the fault covers the tick
``kill_replica``    router fleet: replica ``stage``'s decode raises from
                    ``step`` onward, permanently
``slow_replica``    router fleet: replica ``stage``'s decode sleeps
                    ``magnitude`` seconds per tick while covered
``kill_stage``      pipeline stage ``stage``'s output zeroed permanently
                    from ``step`` on, through a kill code the elastic step
                    reads (``resilience/elastic.py``); the stage never
                    comes back
==================  =======================================================

Train-step faults ride an ``inject`` code, a 0-dim int32 tensor on the
training device: the host writes the code of each step into it
(``fill_``, no sync) and the step reads it in its tensor arithmetic, so a
fault step and a clean step run the same kernels and a plan with no faults
keeps the code at 0. The activation hook reads the code through
:func:`inject_scope` / :func:`current_inject`, set only while the guarded
step runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["ChaosError", "Fault", "ChaosPlan",
           "INJECT_NONE", "INJECT_NAN_GRADS", "INJECT_INF_GRADS",
           "INJECT_NAN_LOSS", "INJECT_LOSS_SPIKE", "INJECT_NAN_ACT",
           "KILL_NONE", "inject_scope", "current_inject",
           "kill_scope", "current_kill", "apply_train_faults",
           "wrap_pre_fn", "wrap_stage_fn", "kill_output"]


class ChaosError(RuntimeError):
    """An injected fault (never raised by real code paths)."""


TRAIN_KINDS = ("nan_grads", "inf_grads", "nan_loss", "loss_spike",
               "nan_activations")
DATA_KINDS = ("data_raise",)
# "transport" faults reach pipe_tpu's EMULATOR stage-boundary hops only;
# WIRE_KINDS fault its fleet's socket wire.
TRANSPORT_KINDS = ("transport_drop", "transport_corrupt",
                   "persistent_hop_drop")
WIRE_KINDS = ("wire_partition", "wire_delay", "wire_corrupt", "wire_dup")
SERVE_KINDS = ("stall_tick", "queue_flood", "backend_raise")
REPLICA_KINDS = ("wedge_replica", "kill_replica", "slow_replica")
STAGE_KINDS = ("kill_stage",)
KINDS = TRAIN_KINDS + DATA_KINDS + TRANSPORT_KINDS + WIRE_KINDS \
    + SERVE_KINDS + REPLICA_KINDS + STAGE_KINDS

# Inject codes (the 0-dim int32 tensor the guarded step reads).
INJECT_NONE = 0
INJECT_NAN_GRADS = 1
INJECT_INF_GRADS = 2
INJECT_NAN_LOSS = 3
INJECT_LOSS_SPIKE = 4
INJECT_NAN_ACT = 5
_TRAIN_CODE = {"nan_grads": INJECT_NAN_GRADS,
               "inf_grads": INJECT_INF_GRADS,
               "nan_loss": INJECT_NAN_LOSS,
               "loss_spike": INJECT_LOSS_SPIKE,
               "nan_activations": INJECT_NAN_ACT}

# Kill code of the elastic step: the stage index to silence, or KILL_NONE
# for a healthy step.
KILL_NONE = -1


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: ``kind`` fires at ``step`` (train step or
    serve tick index, 0-based) for ``count`` consecutive indices.
    ``stage``/``microbatch`` address transport faults (the hop leaving
    ``stage`` for micro-batch ``microbatch``); ``magnitude`` scales
    ``loss_spike`` (factor) and ``stall_tick`` (seconds)."""

    kind: str
    step: int
    count: int = 1
    stage: int = 0
    microbatch: int = 0
    magnitude: float = 1e3

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.step < 0 or self.count < 1:
            raise ValueError(
                f"fault needs step >= 0 and count >= 1, got "
                f"step={self.step} count={self.count}")

    def covers(self, index: int) -> bool:
        return self.step <= index < self.step + self.count


class ChaosPlan:
    """A static, seeded fault schedule, immutable after construction.
    Train faults key on the step index, serve faults on the tick index
    (disjoint kinds)."""

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __repr__(self) -> str:
        return f"ChaosPlan({list(self.faults)!r}, seed={self.seed})"

    def active(self, kind: str, index: int) -> Optional[Fault]:
        """The first ``kind`` fault covering ``index`` (or None)."""
        for f in self.faults:
            if f.kind == kind and f.covers(index):
                return f
        return None

    def without(self, kind: str) -> "ChaosPlan":
        """A new plan minus every ``kind`` fault (same seed): after a
        stage loss, the survivors' plan drops the ``kill_stage`` fault so it
        does not re-fire against the new indices."""
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        return ChaosPlan([f for f in self.faults if f.kind != kind],
                         seed=self.seed)

    # -- train step ---------------------------------------------------------

    def train_inject(self, step: int) -> Tuple[int, float]:
        """(inject code, magnitude) for the guarded train step at
        ``step`` — (0, 1.0) when no train fault covers it."""
        for f in self.faults:
            if f.kind in _TRAIN_CODE and f.covers(step):
                return _TRAIN_CODE[f.kind], float(f.magnitude)
        return INJECT_NONE, 1.0

    def train_kill(self, step: int) -> int:
        """The stage index a ``kill_stage`` fault silences at ``step``,
        or :data:`KILL_NONE`. Like ``kill_replica``, a stage kill is
        permanent: it matches every step from ``step`` onward whatever
        ``count`` is — a dead stage never comes back on its own."""
        for f in self.faults:
            if f.kind == "kill_stage" and step >= f.step:
                return int(f.stage)
        return KILL_NONE

    def last_train_fault_step(self) -> int:
        """Last step index any train-visible fault covers (-1 if none):
        where a drill starts counting the steps to recover."""
        last = -1
        for f in self.faults:
            if f.kind in _TRAIN_CODE:
                last = max(last, f.step + f.count - 1)
        return last

    # -- data iterator ------------------------------------------------------

    def maybe_raise_data(self, index: int) -> None:
        f = self.active("data_raise", index)
        if f is not None:
            raise ChaosError(
                f"injected data-iterator fault at batch {index} "
                f"(plan seed {self.seed})")

    # -- emulator transport -------------------------------------------------

    def transport_fault(self, microbatch: int, stage: int) -> Optional[str]:
        """'drop' | 'corrupt' | None for the hop leaving ``stage`` with
        micro-batch ``microbatch`` (emulator executor only). A
        ``persistent_hop_drop`` on the hop matches EVERY micro-batch —
        the failure-streak counter sees it never clear."""
        for f in self.faults:
            if f.kind not in TRANSPORT_KINDS or f.stage != stage:
                continue
            if f.kind == "persistent_hop_drop":
                return "drop"
            if f.microbatch == microbatch:
                return "drop" if f.kind == "transport_drop" else "corrupt"
        return None

    # -- fleet proc wire ----------------------------------------------------

    def wire_fault(self, kind: str, index: int,
                   replica: int = 0) -> Optional[Fault]:
        """The first ``kind`` wire fault hitting ``replica``'s proc
        wire (addressed via ``Fault.stage``, like replica faults) at
        outgoing frame ``index``. Consulted by
        :func:`pipe_tpu_torch.fleet.proc.apply_wire_chaos` per parent->child
        frame — frame index, not tick, is the coverage key, so a drill
        can corrupt exactly the Nth frame regardless of timing."""
        if kind not in WIRE_KINDS:
            raise ValueError(f"{kind!r} is not a wire fault kind; "
                             f"one of {WIRE_KINDS}")
        for f in self.faults:
            if f.kind == kind and f.stage == replica and f.covers(index):
                return f
        return None

    # -- serve tick ---------------------------------------------------------

    def serve_fault(self, kind: str, tick: int) -> Optional[Fault]:
        if kind not in SERVE_KINDS:
            raise ValueError(f"{kind!r} is not a serve fault kind")
        return self.active(kind, tick)

    # -- router fleet -------------------------------------------------------

    def replica_fault(self, kind: str, tick: int,
                      replica: int) -> Optional[Fault]:
        """The first ``kind`` fault hitting ``replica`` (addressed via
        ``Fault.stage``) at router tick ``tick``. ``kill_replica`` is
        permanent — it matches every tick from ``step`` onward, however
        small ``count`` is; a killed replica never recovers."""
        if kind not in REPLICA_KINDS:
            raise ValueError(f"{kind!r} is not a replica fault kind; "
                             f"one of {REPLICA_KINDS}")
        for f in self.faults:
            if f.kind != kind or f.stage != replica:
                continue
            if kind == "kill_replica":
                if tick >= f.step:
                    return f
            elif f.covers(tick):
                return f
        return None

    def flood_prompt(self, i: int) -> list:
        """Deterministic junk prompt ``i`` for queue_flood (content from
        the plan seed, so floods are reproducible)."""
        import numpy as np
        rng = np.random.RandomState(self.seed * 1_000_003 + i)
        return [int(t) for t in rng.randint(1, 32, size=4)]


# ---------------------------------------------------------------------------
# Injection plumbing (train step)
# ---------------------------------------------------------------------------

# The codes live in the process, not in a thread: on a card, autograd runs
# the backward (and a checkpointed forward's recompute) on its own device
# thread, which must read the code the forward read.
_scope = {"code": None, "kill": None}


class inject_scope:
    """Context manager installing the step's inject code (a 0-dim int
    tensor, or an int) for the duration of one guarded step, forward and
    backward, so wrapped model fns (:func:`wrap_pre_fn`) can read it.
    ``code=None`` installs nothing (the wrapped fns are then the
    identity)."""

    def __init__(self, code):
        self.code = code

    def __enter__(self):
        self._prev = _scope["code"]
        _scope["code"] = self.code
        return self

    def __exit__(self, *exc):
        _scope["code"] = self._prev


def current_inject():
    """The inject code installed by :class:`inject_scope`, or None outside
    any scope (including every unguarded step)."""
    return _scope["code"]


class kill_scope:
    """Context manager installing a kill code (a stage index, or
    :data:`KILL_NONE`) so wrapped stage fns (:func:`wrap_stage_fn`) can read
    it; ``code=None`` installs nothing."""

    def __init__(self, code):
        self.code = code

    def __enter__(self):
        self._prev = _scope["kill"]
        _scope["kill"] = self.code
        return self

    def __exit__(self, *exc):
        _scope["kill"] = self._prev


def current_kill():
    """The kill code installed by :class:`kill_scope`, or None."""
    return _scope["kill"]


def _where(cond, a: float, b: float, like: torch.Tensor) -> torch.Tensor:
    """``a if cond else b`` as a float32 tensor on ``like``'s device, with
    no host sync when ``cond`` is a device tensor."""
    cond = torch.as_tensor(cond, device=like.device)
    return torch.where(cond, torch.tensor(a, device=like.device),
                       torch.tensor(b, device=like.device))


def apply_train_faults(inject, magnitude, loss, grads):
    """Apply the grad/loss fault selected by the ``inject`` code: the
    gradients are scaled in place (NaN, +inf or 1.0) and the scaled loss is
    returned with them, ``(loss, grads)``. ``inject`` and ``magnitude`` may
    be device tensors: the same kernels run whatever code they hold, and a
    scale of 1.0 leaves every bit as it was."""
    inject = torch.as_tensor(inject, device=loss.device)
    gscale = torch.where(
        inject == INJECT_NAN_GRADS,
        torch.tensor(float("nan"), device=loss.device),
        _where(inject == INJECT_INF_GRADS, float("inf"), 1.0, loss))
    grads = [g for g in grads if g is not None]
    if grads:
        torch._foreach_mul_(grads, gscale)
    lscale = torch.where(
        inject == INJECT_NAN_LOSS,
        torch.tensor(float("nan"), device=loss.device),
        torch.where(inject == INJECT_LOSS_SPIKE,
                    torch.as_tensor(magnitude, dtype=torch.float32,
                                    device=loss.device),
                    torch.tensor(1.0, device=loss.device)))
    return loss * lscale.to(loss.dtype), grads


def wrap_pre_fn(pre_fn):
    """Wrap a model ``pre_fn`` so INJECT_NAN_ACT poisons the activations
    it emits. Outside an :class:`inject_scope` the wrapper passes its
    result through untouched."""

    def chaos_pre_fn(*args, **kwargs):
        return poison_activations(pre_fn(*args, **kwargs))

    return chaos_pre_fn


def poison_activations(h: torch.Tensor) -> torch.Tensor:
    """``h`` scaled by NaN when the current inject code is INJECT_NAN_ACT,
    by 1.0 otherwise (bitwise ``h``); ``h`` itself outside a scope."""
    code = current_inject()
    if code is None:
        return h
    return h * _where(torch.as_tensor(code, device=h.device)
                      == INJECT_NAN_ACT, float("nan"), 1.0, h).to(h.dtype)


def kill_output(out, stage: int):
    """``out`` (a tensor, or a tuple or list of them) zeroed when the
    current kill code is ``stage``, scaled by 1.0 otherwise (bitwise
    ``out``); ``out`` itself outside a :class:`kill_scope`."""
    code = current_kill()
    if code is None:
        return out

    def scaled(o):
        if not isinstance(o, torch.Tensor):
            return o
        dead = torch.as_tensor(code, device=o.device) == stage
        return o * _where(dead, 0.0, 1.0, o).to(o.dtype)

    if isinstance(out, (tuple, list)):
        return type(out)(scaled(o) for o in out)
    return scaled(out)


def wrap_stage_fn(stage_fn):
    """Wrap a stage fn ``stage_fn(*args, ctx)`` so a kill code equal to
    ``ctx.stage`` zeroes the stage's whole output (a dead stage emits
    nothing). Outside a :class:`kill_scope` the wrapper passes its result
    through; multiplying by the 1.0 branch is bitwise exact."""

    def chaos_stage_fn(*args, **kwargs):
        out = stage_fn(*args, **kwargs)
        ctx = kwargs["ctx"] if "ctx" in kwargs else args[2]
        return kill_output(out, ctx.stage)

    return chaos_stage_fn
