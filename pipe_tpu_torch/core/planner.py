"""Profile-driven auto-planner: balance, schedule, and microbatching from
measured costs.

Counterpart of ``pipe_tpu/core/planner.py`` over the port's own
``obs/zb_model.py`` and ``core/{balance,memplan,partition,schedule}.py``:

1. **Calibrate** (:func:`profile_model` / :func:`profile_from_calibration`):
   per-layer forward/backward costs measured on the device
   (``core/balance.py:profile_times``, median-of-k, warm-up discarded) and
   per-layer activation/parameter sizes fold into a :class:`CostProfile`. A
   step-time calibration (``obs/zb_model.py:calibrate``, or on one device
   :func:`fit_step_costs` over whole measured steps) supplies the
   split-overhead ``sigma``, the per-cycle overhead ``o`` and its fit
   residual: a profile whose relative residual exceeds
   :data:`MAX_REL_RESIDUAL` is refused (:class:`CalibrationError`).

2. **Search** (:func:`search`): enumerate (stage cut points x schedule
   family x micro-batch count m x interleave v x split_stage). Every
   candidate's op table must verify (``verify_op_tables`` /
   ``verify_interleaved_op_tables`` and ``compile_phases``) before it is
   scored by :func:`predict_wall` (per-stage cost columns under the table)
   and ``core/memplan.py:estimate_memory``, and pruned against a memory cap.

3. **Plan** (:class:`Plan`): a JSON artifact, the same JSON as
   ``pipe_tpu``'s, that ``Pipe(plan=...)`` and ``Trainer(plan=...)`` consume.

The search is a pure function of the profile and its keyword knobs (no RNG,
no clock reads; ties break on (schedule name, m, v, split)), so for the same
profile it ranks the same plans as ``pipe_tpu``'s, JSON for JSON
(``tests/test_torch_planner.py``).

On one device every stage shares the card, so a step costs the sum of its
ops: the honest mode is ``serialized``, which ``Trainer(plan="auto")`` uses
(``pipe_tpu`` picks ``parallel`` on an accelerator, where a stage is a chip;
ROADMAP.md C.9). The ``Trainer``'s zb-h1 under ``never`` runs the
structural B/W split (``split_stage="auto"``), which ``split_stage=True``
plans price; ``Pipe(plan=)`` warns on such a plan and runs the stored-graph
split, as ``pipe_tpu``'s ``Pipe`` runs its stored-vjp one.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..obs.zb_model import OpCosts, fitted_op_costs
from .balance import _bottleneck_split, _layer_io, _nbytes, stage_costs
from .memplan import MemoryPlanInputs, estimate_memory
from .partition import BalanceError, split_balance
from .schedule import (BWD, FWD, WGRAD, Schedule, compile_phases,
                       get_schedule, verify_interleaved_op_tables,
                       verify_op_tables)

__all__ = ["CostProfile", "Plan", "CalibrationError", "MAX_REL_RESIDUAL",
           "profile_model", "profile_from_calibration", "uniform_profile",
           "fit_step_costs", "predict_wall", "search", "auto_plan",
           "spec_speedup",
           "spec_breakeven_acceptance"]

# Refuse to rank on a calibration whose relative fit residual exceeds
# this: a quarter of the signal unexplained means the linear cost model
# (op counts x per-op costs + cycles x overhead) is the wrong model for
# the machine, and ranking schedules on it would be astrology. The
# calibrations pipe_tpu committed sit well below (ZB_CROSSOVER_r05:
# <= 0.06).
MAX_REL_RESIDUAL = 0.25
# Rounds of the step fit's round-robin timing: each m's wall is the least
# of at least this many.
FIT_ROUNDS = 11

# pipe_tpu's defaults for profiles built without a fresh fit, from its
# virtual-CPU-mesh calibrations (ZB_CROSSOVER_r05.json, structural split:
# sigma <= 1.41; the stored-vjp split 1.90-2.33, ~1.45x worse, which is how
# split_stage=False zb candidates are priced when the profile carries no
# legacy sigma of its own). Kept so that the same profile ranks the same
# plans as pipe_tpu's; they were not measured on a CUDA card, and a profile
# calibrated there (profile_from_calibration) replaces them.
DEFAULT_SIGMA = 1.41
LEGACY_SIGMA_RATIO = 1.45


class CalibrationError(ValueError):
    """The cost-model calibration is not trustworthy enough to rank on."""


# ---------------------------------------------------------------------------
# CostProfile: what calibration measures, what the search consumes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """Measured per-layer costs + sizes, and the machine model constants.

    ``layer_fwd_s``/``layer_bwd_s`` are seconds per layer for one
    micro-batch of ``rows`` rows (bwd is the BACKWARD-only part; a fused
    BWD op costs ``bwd``, a split B or W op costs ``sigma * bwd / 2``).
    ``layer_act_bytes`` is each layer's OUTPUT activation size at ``rows``
    rows — boundary traffic and stash slots are priced off it.
    Costs and activation bytes scale linearly with rows-per-micro-batch
    when the search trades m against micro-batch size.
    """

    layer_fwd_s: Tuple[float, ...]
    layer_bwd_s: Tuple[float, ...]
    layer_param_bytes: Tuple[int, ...]
    layer_act_bytes: Tuple[int, ...]
    rows: int = 1
    sigma: float = DEFAULT_SIGMA        # split-backward overhead factor
    sigma_fused_split: Optional[float] = None   # legacy stored-vjp sigma
    o: float = 0.0                      # per-cycle machinery overhead, s
    mode: str = "serialized"            # serialized | parallel
    rel_residual: float = 0.0           # of the calibration behind sigma/o
    source: str = "unspecified"

    def __post_init__(self):
        n = len(self.layer_fwd_s)
        for f_ in ("layer_bwd_s", "layer_param_bytes", "layer_act_bytes"):
            if len(getattr(self, f_)) != n:
                raise ValueError(f"{f_} covers {len(getattr(self, f_))} "
                                 f"layers, layer_fwd_s covers {n}")
        if self.mode not in ("serialized", "parallel"):
            raise ValueError(f"mode must be serialized|parallel, "
                             f"got {self.mode!r}")
        if self.rel_residual > MAX_REL_RESIDUAL:
            warnings.warn(
                f"REFUSING to plan on this calibration: relative fit "
                f"residual {self.rel_residual:.3f} exceeds "
                f"{MAX_REL_RESIDUAL} — the linear cost model does not "
                f"describe this machine, so any schedule ranking built on "
                f"it would be noise. Re-measure (more iters, quieter "
                f"host), or pass analytic costs explicitly.", stacklevel=3)
            raise CalibrationError(
                f"calibration rel_residual {self.rel_residual:.3f} > "
                f"{MAX_REL_RESIDUAL}")

    @property
    def n_layers(self) -> int:
        return len(self.layer_fwd_s)

    @property
    def sigma_legacy(self) -> float:
        return (self.sigma_fused_split if self.sigma_fused_split is not None
                else self.sigma * LEGACY_SIGMA_RATIO)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "CostProfile":
        d = json.loads(text)
        for k in ("layer_fwd_s", "layer_bwd_s", "layer_param_bytes",
                  "layer_act_bytes"):
            d[k] = tuple(d[k])
        return cls(**d)


def profile_model(module, sample, *, repeat: int = 5,
                  warmup: int = 1, seed: int = 0,
                  sigma: float = DEFAULT_SIGMA, o: float = 0.0,
                  mode: str = "serialized",
                  rel_residual: float = 0.0) -> CostProfile:
    """The calibration pass over a real model: time each layer for a
    handful of synchronized runs (``core/balance.py:profile_times``) and
    fold the forward/backward costs plus parameter/activation sizes into a
    :class:`CostProfile`. ``sample`` must be ONE micro-batch of the rows the
    pipeline will see (the search scales costs linearly in rows when it
    trades m against micro-batch size).

    ``sigma``/``o``/``rel_residual`` come from a step-time calibration
    when one exists (:func:`obs.zb_model.calibrate` ->
    :func:`profile_from_calibration` merges them).
    """
    from .balance import profile_times

    fwd = profile_times(module, sample, backward=False, repeat=repeat,
                        warmup=warmup, seed=seed)
    tot = profile_times(module, sample, backward=True, repeat=repeat,
                        warmup=warmup, seed=seed)
    # profile_times(backward=True) measures fwd+bwd together; the
    # backward-only part clamps at one forward below (timer noise can
    # push tot under fwd for tiny layers; a backward cheaper than the
    # forward it differentiates is not physical for matmul chains).
    bwd = [max(t - f, f) for f, t in zip(fwd, tot)]
    io = _layer_io(module, sample)
    p_bytes = [_nbytes(layer.parameters()) for layer in module]
    a_bytes = [_nbytes(outputs) for _, outputs in io]
    first = io[0][0][0] if io else sample
    rows = int(first.shape[0]) if first.dim() else 1
    return CostProfile(
        layer_fwd_s=tuple(fwd), layer_bwd_s=tuple(bwd),
        layer_param_bytes=tuple(p_bytes), layer_act_bytes=tuple(a_bytes),
        rows=rows, sigma=sigma, o=o, mode=mode, rel_residual=rel_residual,
        source="profile_model")


def profile_from_calibration(calib: dict, *, n_layers: int, rows: int,
                             layer_param_bytes: Union[int, Sequence[int]] = 0,
                             layer_act_bytes: Union[int, Sequence[int]] = 0,
                             width: Optional[int] = None,
                             mode: str = "serialized") -> CostProfile:
    """A :class:`CostProfile` from a measured step-time calibration
    (:func:`obs.zb_model.calibrate` over real 1f1b/zb steps). The fit's
    per-STAGE forward cost ``f`` (at ``calib['n']`` stages) spreads
    uniformly over ``n_layers`` layers — exact for homogeneous stacks
    (the transformer zoo), which is the only thing a step-level fit can
    resolve anyway. Refuses (loudly) when the fit's relative residual
    exceeds :data:`MAX_REL_RESIDUAL` — see :class:`CalibrationError`."""
    costs: OpCosts = fitted_op_costs(calib, width)
    rr = float(calib.get("rel_residual",
                         max(calib["rel_residual_per_width"])))
    stages_at_fit = int(calib["n"])
    layer_f = costs.f * stages_at_fit / n_layers
    if isinstance(layer_param_bytes, int):
        layer_param_bytes = (layer_param_bytes,) * n_layers
    if isinstance(layer_act_bytes, int):
        layer_act_bytes = (layer_act_bytes,) * n_layers
    return CostProfile(
        layer_fwd_s=(layer_f,) * n_layers,
        layer_bwd_s=(2.0 * layer_f,) * n_layers,
        layer_param_bytes=tuple(int(b) for b in layer_param_bytes),
        layer_act_bytes=tuple(int(b) for b in layer_act_bytes),
        rows=rows, sigma=costs.sigma, o=max(costs.o, 0.0), mode=mode,
        rel_residual=rr, source="zb_model.calibrate")


def uniform_profile(n_layers: int, *, rows: int = 1, f: float = 1.0,
                    sigma: float = DEFAULT_SIGMA, o_over_f: float = 0.1,
                    layer_param_bytes: int = 0, layer_act_bytes: int = 0,
                    mode: str = "parallel") -> CostProfile:
    """Analytic fallback profile: uniform unit-cost layers, committed
    sigma, overhead as a fraction of ``f``. This is what
    ``Trainer(plan='auto')`` ranks on when no measured profile is given —
    correct RELATIVE costs for homogeneous stage bodies (PipelinedLM),
    which is all the argmin needs."""
    return CostProfile(
        layer_fwd_s=(f,) * n_layers, layer_bwd_s=(2.0 * f,) * n_layers,
        layer_param_bytes=(layer_param_bytes,) * n_layers,
        layer_act_bytes=(layer_act_bytes,) * n_layers,
        rows=rows, sigma=sigma, o=o_over_f * f, mode=mode,
        source="uniform")


# ---------------------------------------------------------------------------
# Heterogeneous wall model: per-stage cost columns under an op table
# ---------------------------------------------------------------------------


def predict_wall(op: np.ndarray, grp: Optional[np.ndarray],
                 stage_fwd_s: Sequence[float],
                 stage_bwd_s: Sequence[float], *, d: int, sigma: float,
                 o: float, mode: str, recompute: bool = False) -> float:
    """Predicted wall seconds of one step — the heterogeneous
    generalization of :func:`obs.zb_model.schedule_wall`: instead of one
    scalar ``f`` for every stage, each of the ``S = v*d`` virtual stages
    brings its own forward/backward cost (the per-stage vectors
    :func:`core.balance.stage_costs` produces for a candidate cut).
    Virtual stage ``s = grp[t, p] * d + p`` prices the op at ``(t, p)``:

    * ``FWD`` = ``f_s``; fused ``BWD`` = ``b_s`` (+ ``f_s`` recompute tax
      under non-'never' checkpointing);
    * split tables: B and W each ``sigma * b_s / 2`` — the same pricing
      :class:`obs.zb_model.OpCosts` uses, so with uniform cost columns
      and ``b = 2f`` this function equals ``schedule_wall`` exactly
      (pinned in ``tests/test_torch_planner.py``).
    """
    op = np.asarray(op)
    T, cols = op.shape
    if cols != d:
        raise ValueError(f"op table has {cols} device columns, d={d}")
    S = len(stage_fwd_s)
    if len(stage_bwd_s) != S or S % d:
        raise ValueError(f"stage cost vectors must cover v*d stages "
                         f"(got {S} and {len(stage_bwd_s)} for d={d})")
    grp = (np.zeros_like(op) if grp is None else np.asarray(grp))
    s_at = grp * d + np.arange(d)[None, :]
    f_at = np.asarray(stage_fwd_s, np.float64)[s_at]
    b_at = np.asarray(stage_bwd_s, np.float64)[s_at]
    split_table = bool((op == WGRAD).any())
    ct = np.zeros(op.shape, np.float64)
    ct[op == FWD] = f_at[op == FWD]
    if split_table:
        ct[op == BWD] = (sigma / 2.0) * b_at[op == BWD]
        ct[op == WGRAD] = (sigma / 2.0) * b_at[op == WGRAD]
    else:
        bb = b_at + (f_at if recompute else 0.0)
        ct[op == BWD] = bb[op == BWD]
    if mode == "parallel":
        return float(ct.max(axis=1).sum() + T * o)
    if mode == "serialized":
        return float(ct.sum() + T * o)
    raise ValueError(f"mode must be parallel|serialized, got {mode!r}")


# ---------------------------------------------------------------------------
# The Plan artifact
# ---------------------------------------------------------------------------

PLAN_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One verified, scored pipeline configuration — the planner's unit of
    output and the front doors' unit of input (``Pipe(plan=...)``,
    ``Trainer(plan=...)``). JSON-serializable; ``runners_up`` carries the
    ranked alternatives' summaries so a human
    can see what the winner beat and by how much."""

    schedule: str
    m: int
    v: int
    balance: Tuple[int, ...]
    split_stage: bool
    checkpoint: str
    n_devices: int
    mode: str
    predicted_step_s: float
    predicted_s_per_row: float
    predicted_peak_bytes: int
    phase_ok: bool
    profile_source: str = "unspecified"
    runners_up: Tuple[dict, ...] = ()
    # Bring-your-own-schedule plans carry the live object (not JSON-round-
    # trippable; reloading such a plan requires re-supplying the object).
    schedule_ref: Optional[Schedule] = dataclasses.field(
        default=None, compare=False, repr=False)

    def summary(self) -> dict:
        return {"schedule": self.schedule, "m": self.m, "v": self.v,
                "balance": list(self.balance),
                "split_stage": self.split_stage,
                "checkpoint": self.checkpoint,
                "predicted_step_s": self.predicted_step_s,
                "predicted_s_per_row": self.predicted_s_per_row,
                "predicted_peak_bytes": self.predicted_peak_bytes,
                "phase_ok": self.phase_ok}

    def schedule_obj(self) -> Schedule:
        """The live Schedule this plan prescribes."""
        if self.schedule_ref is not None:
            return self.schedule_ref
        if self.schedule == "interleaved-1f1b":
            return get_schedule("interleaved-1f1b", interleave=self.v)
        return get_schedule(self.schedule)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("schedule_ref")
        d["balance"] = list(self.balance)
        d["runners_up"] = list(self.runners_up)
        d["version"] = PLAN_VERSION
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        d = json.loads(text)
        ver = d.pop("version", PLAN_VERSION)
        if ver != PLAN_VERSION:
            raise ValueError(f"plan version {ver} != {PLAN_VERSION}")
        d["balance"] = tuple(d["balance"])
        d["runners_up"] = tuple(d.get("runners_up", ()))
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as fh:
            return cls.from_json(fh.read())


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def _balance_candidates(profile: CostProfile, n_stages: int,
                        uniform_only: bool) -> List[Tuple[int, ...]]:
    """Candidate stage cut points for one stage count: the uniform
    ceil-split, the bottleneck-optimal cut by measured time, and the
    bottleneck-optimal cut by bytes (deduped, deterministic order)."""
    L = profile.n_layers
    if n_stages > L:
        return []
    out: List[Tuple[int, ...]] = []
    if uniform_only:
        if L % n_stages:
            return []
        return [tuple(split_balance(L, n_stages))]
    for costs in (None,
                  [f + b for f, b in zip(profile.layer_fwd_s,
                                         profile.layer_bwd_s)],
                  [p + a for p, a in zip(profile.layer_param_bytes,
                                         profile.layer_act_bytes)]):
        try:
            cut = (tuple(split_balance(L, n_stages)) if costs is None
                   else tuple(_bottleneck_split(costs, n_stages)))
        except BalanceError:
            continue
        if sum(costs or [0]) == 0 and costs is not None:
            continue    # size profile absent: the cut is meaningless
        if cut not in out:
            out.append(cut)
    return out


def _schedule_candidates(spec, v_options: Sequence[int]):
    """Expand one schedule spec into (name, v, Schedule, is_custom)."""
    if isinstance(spec, Schedule):
        return [(spec.name, spec.v, spec, True)]
    name = {"interleaved": "interleaved-1f1b"}.get(spec, spec)
    if name == "interleaved-1f1b":
        return [(name, v, get_schedule(name, interleave=v), False)
                for v in v_options if v > 1]
    return [(name, 1, get_schedule(name), False)]


def _device_param_bytes(balance: Sequence[int], profile: CostProfile,
                        d: int) -> int:
    """Max per-device parameter bytes: virtual stage s lives on device
    s % d (device-major interleaving)."""
    per_stage = stage_costs(balance, profile.layer_param_bytes)
    dev = [0.0] * d
    for s, b in enumerate(per_stage):
        dev[s % d] += b
    return int(max(dev))


def search(profile: CostProfile, *, n_devices: int,
           m_candidates: Sequence[int],
           batch_rows: Optional[int] = None,
           schedules: Sequence[Union[str, Schedule]] = (
               "gpipe", "1f1b", "interleaved-1f1b", "zb-h1", "zb-h2"),
           interleave_candidates: Sequence[int] = (2,),
           checkpoint: str = "never",
           memory_cap_bytes: Optional[int] = None,
           uniform_only: bool = False,
           phase_gate: bool = True,
           max_plans: int = 8) -> List[Plan]:
    """Rank the plan space under the profile's cost model.

    For each (schedule family × interleave v × m × stage cut ×
    split_stage) candidate: emit the op table, PROVE it
    (``verify_op_tables`` / the interleaved verifier; construction or
    verification failure prunes silently — an invalid table is not a
    plan), phase-compile it (``compile_phases``; with ``phase_gate`` a
    rejected table is pruned too, so every emitted plan lowers to the
    switch-free executor when ``d > 1``), price it
    (:func:`predict_wall` + :func:`core.memplan.estimate_memory`), and
    drop it if it busts ``memory_cap_bytes``.

    ``batch_rows`` fixes the global batch: rows-per-micro-batch becomes
    ``batch_rows / m`` (non-dividing m are skipped) and costs scale
    linearly from the profile's measured rows — this is the m-vs-
    micro-batch-size tradeoff. Without it, each m keeps the profile's
    rows per micro-batch and ranking is per-ROW throughput either way
    (``predicted_s_per_row``), so small-m and large-m candidates stay
    comparable.

    Returns plans best-first; ``plans[0].runners_up`` summarizes the
    rest. Deterministic for a fixed profile (no RNG, stable tiebreak).
    """
    if not m_candidates:
        raise ValueError("m_candidates must be non-empty")
    d = int(n_devices)
    plans: List[Plan] = []
    for spec in schedules:
        for name, v, sched, is_custom in _schedule_candidates(
                spec, interleave_candidates):
            S = v * d
            split_opts = ([True, False] if sched.splits_backward
                          and checkpoint == "never" else [False])
            for m in sorted(set(int(m) for m in m_candidates)):
                if batch_rows is not None:
                    if batch_rows % m:
                        continue
                    rows_mb = batch_rows // m
                else:
                    rows_mb = profile.rows
                scale = rows_mb / profile.rows
                for balance in _balance_candidates(profile, S,
                                                   uniform_only):
                    try:
                        tables = sched.op_tables(m, d if v > 1 else S)
                    except Exception:
                        continue        # constructor refused this (m, n)
                    op, mbi = tables[0], tables[1]
                    grp = tables[2] if len(tables) > 2 else None
                    try:
                        if v > 1:
                            verify_interleaved_op_tables(
                                op, mbi, grp, m, d, v)
                        else:
                            verify_op_tables(
                                op, mbi, m, S,
                                stash_slots=sched.stash_slots(m, S),
                                wstash_slots=(
                                    sched.wstash_slots(m, S)
                                    if sched.splits_backward else None))
                    except AssertionError:
                        continue        # table failed its proof: not a plan
                    verdict = compile_phases(op, mbi, grp, m=m, d=d, v=v)
                    if phase_gate and d > 1 and not verdict.accepted:
                        continue
                    f_vec = [scale * c for c in stage_costs(
                        balance, profile.layer_fwd_s)]
                    b_vec = [scale * c for c in stage_costs(
                        balance, profile.layer_bwd_s)]
                    for split in split_opts:
                        sigma = (profile.sigma if split
                                 else profile.sigma_legacy)
                        wall = predict_wall(
                            op, grp, f_vec, b_vec, d=d, sigma=sigma,
                            o=profile.o, mode=profile.mode,
                            recompute=checkpoint != "never")
                        act = int(np.ceil(scale * max(
                            profile.layer_act_bytes, default=0)))
                        mem = estimate_memory(
                            MemoryPlanInputs(
                                v=v,
                                stash_slots=sched.stash_slots(
                                    m, d if v > 1 else S),
                                wstash_slots=(
                                    sched.wstash_slots(m, S)
                                    if sched.splits_backward else 0),
                                checkpoint=checkpoint,
                                split_stage=split),
                            act_bytes=act,
                            param_bytes=_device_param_bytes(
                                balance, profile, d))
                        if memory_cap_bytes is not None \
                                and mem > memory_cap_bytes:
                            continue
                        plans.append(Plan(
                            schedule=name, m=m, v=v, balance=balance,
                            split_stage=split, checkpoint=checkpoint,
                            n_devices=d, mode=profile.mode,
                            predicted_step_s=wall,
                            predicted_s_per_row=wall / (m * rows_mb),
                            predicted_peak_bytes=mem,
                            phase_ok=bool(verdict.accepted),
                            profile_source=profile.source,
                            schedule_ref=sched if is_custom else None))
    plans.sort(key=lambda p: (p.predicted_s_per_row, p.schedule, p.m,
                              p.v, not p.split_stage, p.balance))
    plans = plans[:max_plans]
    if plans:
        tail = tuple(p.summary() for p in plans[1:])
        plans[0] = dataclasses.replace(plans[0], runners_up=tail)
    return plans


def fit_step_costs(module, sample, profile: CostProfile, *, n_devices: int,
                   m_points: Sequence[int], batch_rows: Optional[int] = None,
                   checkpoint: str = "never", repeat: int = 3,
                   warmup: int = 1, seed: int = 0) -> CostProfile:
    """Fit ``profile`` to whole steps measured on one device: a forward and
    backward of ``Pipe(module, chunks=m)`` (gpipe, the uniform cut over
    ``n_devices`` stages) at each ``m`` of ``m_points``, against
    :func:`predict_wall`'s price of the same table.

    The per-layer profile times each layer alone at one micro-batch size
    and scales it linearly in rows, and with ``o`` = 0 a ``serialized``
    step at a fixed batch prices every m alike. A measured step also pays
    per op (host dispatch and launches) and runs small micro-batches less
    efficiently, so it grows with m. The least-squares fit of
    ``wall(m) = scale * priced(m) + cycles(m) * o`` (``scale`` > 0,
    ``o`` >= 0, ``cycles`` the table's length) gives the returned profile
    its scaled layer costs, ``o`` and the fit's relative residual, which
    :class:`CostProfile` refuses above :data:`MAX_REL_RESIDUAL`.

    The m points are timed round robin: ``warmup`` untimed steps of every
    m, then at least :data:`FIT_ROUNDS` (or ``repeat``) rounds of one timed
    step at each m; each m's wall is the least of its rounds. A busy host
    only lengthens a step, and only the steps it bounds: at a small m the
    step is device-bound and steady, at a large m host-bound, so a slow
    stretch of the host that spans several rounds still bends a median of
    them (``PERF.md`` §6, B.14), and the least is the step's own cost."""
    from ..pipe import Pipe
    from . import balance as _balance

    ms = sorted({int(m) for m in m_points})
    if len(ms) < 2:
        raise ValueError(f"m_points must hold two distinct m, got {m_points}")
    d = int(n_devices)
    balance = split_balance(profile.n_layers, d)
    table = get_schedule("gpipe")
    priced, cycles, steps = [], [], []
    for m in ms:
        rows = batch_rows if batch_rows is not None else m * profile.rows
        if rows % m:
            raise ValueError(f"m={m} does not divide the batch of {rows} rows")
        reps = -(-rows // sample.shape[0])
        x = sample.repeat((reps,) + (1,) * (sample.dim() - 1))[:rows]
        pipe = Pipe(module, chunks=m, checkpoint=checkpoint, balance=balance,
                    device=x.device)

        def step(pipe=pipe, x=x):
            module.zero_grad(set_to_none=True)
            pipe(x, train=True, seed=seed).float().square().mean().backward()

        steps.append(step)
        scale = rows / m / profile.rows
        op = table.op_tables(m, d)[0]
        priced.append(predict_wall(
            op, None, [scale * c for c in stage_costs(balance,
                                                      profile.layer_fwd_s)],
            [scale * c for c in stage_costs(balance, profile.layer_bwd_s)],
            d=d, sigma=profile.sigma_legacy, o=0.0, mode=profile.mode,
            recompute=checkpoint != "never"))
        cycles.append(float(op.shape[0]))
    # Round robin: untimed warm-ups of every m, then each round times one
    # step at every m.
    device = sample.device
    for _ in range(max(int(warmup), 1)):
        for step in steps:
            step()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    samples = [[] for _ in ms]
    for _ in range(max(int(repeat), FIT_ROUNDS)):
        for i, step in enumerate(steps):
            samples[i].append(_balance._time_once(step, device))
    walls = [min(s) for s in samples]
    module.zero_grad(set_to_none=True)
    a, w = np.array([priced, cycles]).T, np.array(walls)
    (k, o), *_ = np.linalg.lstsq(a, w, rcond=None)
    if o < 0:       # no growth with m: the layer costs alone, scaled
        k, o = float(w @ a[:, 0] / (a[:, 0] @ a[:, 0])), 0.0
    if k <= 0:
        warnings.warn(
            f"REFUSING to plan on this calibration: the step walls {walls} "
            f"at m={ms} grow faster than the table's cycles (scale "
            f"{k:.3g}), so the per-cycle overhead model does not describe "
            f"this machine.", stacklevel=2)
        raise CalibrationError(f"step fit scale {k:.3g} <= 0")
    rel = float(np.sqrt(np.mean((w - a @ np.array([k, o])) ** 2)) / w.mean())
    return dataclasses.replace(
        profile, layer_fwd_s=tuple(k * f for f in profile.layer_fwd_s),
        layer_bwd_s=tuple(k * b for b in profile.layer_bwd_s),
        o=float(o), rel_residual=rel, source=f"{profile.source}+steps")


def _fit_points(m_candidates: Sequence[int],
                batch_rows: Optional[int]) -> Tuple[int, ...]:
    """The smallest, the middle and the largest candidate m that divide the
    batch."""
    ms = sorted({int(m) for m in m_candidates
                 if batch_rows is None or batch_rows % int(m) == 0})
    return tuple(sorted({ms[0], ms[len(ms) // 2], ms[-1]})) if ms else ()


def auto_plan(module, sample, *, n_devices: int,
              m_candidates: Sequence[int], mode: str = "serialized",
              fit_m: Optional[Sequence[int]] = None, **search_kw) -> Plan:
    """Calibrate -> search -> best plan, in one call: profile the model's
    layers on the device (:func:`profile_model`) and hand the ranked winner
    back. ``mode`` defaults to ``serialized``: the port's stages share one
    device. There the profile is fitted to whole steps measured at the m of
    ``fit_m`` (default: the smallest, middle and largest candidate;
    :func:`fit_step_costs`), so that the per-op cost ``o`` ranks m. Raises
    :class:`BalanceError` only when no candidate survives the proofs and the
    memory cap."""
    profile = profile_model(module, sample, mode=mode)
    if mode == "serialized":
        points = (tuple(fit_m) if fit_m is not None else _fit_points(
            m_candidates, search_kw.get("batch_rows")))
        if len(set(points)) > 1:
            profile = fit_step_costs(
                module, sample, profile, n_devices=n_devices,
                m_points=points, batch_rows=search_kw.get("batch_rows"),
                checkpoint=search_kw.get("checkpoint", "never"))
    plans = search(profile, n_devices=n_devices,
                   m_candidates=m_candidates, **search_kw)
    if not plans:
        raise BalanceError(
            "the planner found no feasible plan: every candidate failed "
            "table verification, phase compilation, or the memory cap")
    return plans[0]


# ---------------------------------------------------------------------------
# speculative-decode cost model: acceptance x draft cost as a plan input
# ---------------------------------------------------------------------------
#
# The serving profile's analog of predict_wall: should a deployment turn
# the spec lane on, and at which draft? Inputs are the two numbers the
# obs plane ships per deployment — ``serve.spec.acceptance_rate`` (the
# measured per-drafted-position acceptance) and
# ``serve.spec.draft_cost_frac`` (the drafter's work-unit share of a
# round, ``inference/draft.py:DraftSource.draft_cost_frac``) — plus one
# machine fact: how much a K-row teacher-forced verify chunk costs
# relative to a 1-row decode step (``chunk_cost_ratio``, ~1 on
# overhead/memory-bound decode, -> K on pure-FLOP-bound decode; the
# serve bench measures it as spec-off s_per_tok vs the chunk wall).


def spec_speedup(acceptance: float, draft_cost_frac: float, K: int,
                 chunk_cost_ratio: float = 1.0) -> float:
    """Predicted spec-on tokens/s over spec-off tokens/s.

    Per round the lane emits ``1 + acceptance*(K-1)`` tokens (the
    accepted draft prefix plus the correction) and pays
    ``chunk_cost_ratio`` single-step walls of verify plus the draft
    overhead — ``draft_cost_frac = d/(d+v)`` gives the draft/verify
    wall ratio ``f/(1-f)``, so a round costs ``chunk_cost_ratio/(1-f)``
    single steps. The spec-off baseline is 1 token per single step."""
    if K < 2:
        raise ValueError(f"spec needs K >= 2, got {K}")
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    if not 0.0 <= draft_cost_frac < 1.0:
        raise ValueError(
            f"draft_cost_frac must be in [0, 1), got {draft_cost_frac}")
    if chunk_cost_ratio <= 0.0:
        raise ValueError(
            f"chunk_cost_ratio must be > 0, got {chunk_cost_ratio}")
    emitted = 1.0 + acceptance * (K - 1)
    round_cost = chunk_cost_ratio / (1.0 - draft_cost_frac)
    return emitted / round_cost


def spec_breakeven_acceptance(draft_cost_frac: float, K: int,
                              chunk_cost_ratio: float = 1.0) -> float:
    """The acceptance rate at which :func:`spec_speedup` crosses 1.0 —
    below it the lane is a slowdown and the plan should keep spec off.
    Returns a value clipped to [0, 1]; 1.0 means the draft can never
    pay for itself at this K (e.g. FLOP-bound verify with an expensive
    draft), 0.0 means any acceptance wins (free draft, free chunk)."""
    if K < 2:
        raise ValueError(f"spec needs K >= 2, got {K}")
    if not 0.0 <= draft_cost_frac < 1.0:
        raise ValueError(
            f"draft_cost_frac must be in [0, 1), got {draft_cost_frac}")
    if chunk_cost_ratio <= 0.0:
        raise ValueError(
            f"chunk_cost_ratio must be > 0, got {chunk_cost_ratio}")
    a = (chunk_cost_ratio / (1.0 - draft_cost_frac) - 1.0) / (K - 1)
    return float(min(max(a, 0.0), 1.0))
