"""What the ranks of tests/test_torch_elastic.py's gloo world run.

Each function runs on every rank of a 4-rank world spawned by
``pipe_tpu_torch.runtime.World`` on the CPU and returns numpy results for
the test process. This module imports neither JAX nor ``pipe_tpu``.
"""

import dataclasses

import numpy as np
import torch

from pipe_tpu_torch import convert
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.parallel.mesh import make_mesh, survivor_mesh
from pipe_tpu_torch.resilience import (ChaosPlan, ElasticConfig, Fault,
                                       ResilienceConfig, restack_state,
                                       train_elastic)
from pipe_tpu_torch.train.loop import Trainer, TrainerConfig
from pipe_tpu_torch.train.state import state_manifest

# tests/test_elastic.py's drill: 12 layers regroup over 4 and 3 stages
DRILL_CFG = LMConfig(vocab=67, d_model=16, nhead=2, d_ff=32, n_layers=12,
                     seq_len=32, dropout=0.0, attn_impl="xla")
DRILL_RC = ResilienceConfig(warmup_steps=100, rewind_after=3,
                            snapshot_every=3, data_backoff_s=0.0,
                            rewind_backoff_s=0.0)
DRILL_STEPS = 10
DRILL_KILL = dict(step=6, stage=1)
# tests/test_torch_resilience.py's model and guard, for the 2 x 2 chaos run
GUARD_CFG = dataclasses.replace(DRILL_CFG, n_layers=4)
GUARD_RC = ResilienceConfig(warmup_steps=1, rewind_after=2, snapshot_every=2,
                            data_backoff_s=0.0, rewind_backoff_s=0.0)
GUARD_FAULTS = (("nan_grads", 1, dict(count=2)), ("loss_spike", 4, {}),
                ("data_raise", 5, {}))
GUARD_STEPS = 7


def drill_config(n_stages=4, **kw):
    base = dict(batch_size=8, bptt=16, chunks=4, n_stages=n_stages,
                schedule="gpipe", checkpoint="never", lr=0.01,
                resilience=DRILL_RC,
                elastic=ElasticConfig(snapshot_every=3, dead_after=2))
    return TrainerConfig(**{**base, **kw})


def guard_config(**kw):
    return TrainerConfig(batch_size=8, bptt=16, chunks=2, n_stages=2,
                         schedule="1f1b", checkpoint="except_last", lr=0.01,
                         resilience=GUARD_RC, **kw)


def guard_plan():
    return ChaosPlan([Fault(kind, step, **kw)
                      for kind, step, kw in GUARD_FAULTS], seed=3)


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def mesh_drill(params, source):
    """The drill over 4 stage ranks from ``pipe_tpu``'s initial params: a
    ``kill_stage`` fault on stage 1 at step 6, 10 steps under
    ``train_elastic``. The retired rank says so; the survivors return the
    recovery record, the losses by step and their new stage, and the
    survivors' lead the whole state gathered over the survivors' own group
    (the one-device trainer's: the model and Adam's moments)."""
    mesh = make_mesh(4, 1)
    tr = Trainer(DRILL_CFG, drill_config(), device="cpu",
                 chaos=ChaosPlan([Fault("kill_stage", **DRILL_KILL)]))
    convert.load_pipelined_lm_params(tr.pipe, params)
    lines = []
    tr2, state, info = train_elastic(tr, source, state=tr._capture(0),
                                     max_steps=DRILL_STEPS,
                                     log_fn=lines.append)
    out = {"rank": mesh.rank, "lines": lines}
    if tr2 is None:
        out.update(retired=info["retired"],
                   recoveries=info["recoveries"])
        return out
    full = tr2._full_state(state)
    out.update(
        stage=tr2.mesh.stage, n_stages=tr2.mesh.n_stages,
        manifest=None if full is None else state_manifest(full),
        loss_by_step=info["loss_by_step"],
        recoveries=[{k: v for k, v in r.items() if k != "recovery_s"}
                    for r in info["recoveries"]],
        state=None if full is None else {
            "model": _np(full.model),
            "moments": {g: _np({k: st[k] for k in ("exp_avg",
                                                   "exp_avg_sq")})
                        for g, st in full.optimizer["state"].items()}})
    return out


def mesh_reference(params, source):
    """The drill's reference on the same ranks: 4 stage ranks train
    unkilled to the snapshot step (5), the whole state is gathered and
    restacked, and a trainer born with 3 stages on the survivor mesh
    finishes steps 6-9. The survivors' lead returns the final state's
    manifest and every survivor its losses by step."""
    import torch.distributed as dist

    mesh = make_mesh(4, 1)
    tr = Trainer(DRILL_CFG, drill_config(elastic=None), device="cpu")
    convert.load_pipelined_lm_params(tr.pipe, params)
    state, _ = tr.train_epoch(source, state=tr._capture(0),
                              max_steps=DRILL_KILL["step"], log_every=0)
    whole = [tr._full_state(state)]
    dist.broadcast_object_list(whole, src=mesh.lead)
    new = survivor_mesh(mesh, DRILL_KILL["stage"])
    if new is None:
        return {"rank": mesh.rank, "retired": True}
    narrow = Trainer(DRILL_CFG, drill_config(3, elastic=None), device="cpu",
                     mesh=new)
    state, info = narrow.train_epoch(
        source, state=restack_state(whole[0], 4, 3),
        max_steps=DRILL_STEPS, start_step=DRILL_KILL["step"], log_every=0)
    full = narrow._full_state(state)
    return {"rank": mesh.rank,
            "loss_by_step": {DRILL_KILL["step"] + i: l
                             for i, l in enumerate(info["losses"])},
            "manifest": None if full is None else state_manifest(full)}


def mesh_guarded(params, source):
    """The guarded step over a 2 x 2 mesh with ZeRO's sharded moments
    under the chaos plan (a rewind, a loss spike, a data fault): the
    anomalies, rewinds and per-step losses."""
    make_mesh(2, 2)
    tr = Trainer(GUARD_CFG, guard_config(n_data=2, zero=True), device="cpu",
                 chaos=guard_plan())
    convert.load_pipelined_lm_params(tr.pipe, params)
    _, info = tr.train_epoch(source, state=tr._capture(0),
                             max_steps=GUARD_STEPS, log_every=0,
                             log_fn=lambda m: None)
    return {k: info[k] for k in ("anomalies", "rewinds", "losses", "steps")}


def mesh_drill_data(source):
    """The drill over 3 stages x 2 data ranks with ZeRO's sharded moments,
    from the seed's weights: a ``kill_stage`` fault on stage 1 at step 6
    drops both of its data
    replicas, and 2 stages x 2 data survive. The retired ranks say so; the
    survivors return the record, the losses by step, and the survivors'
    lead the whole state gathered over the survivors' group."""
    mesh = make_mesh(3, 2)
    tr = Trainer(DRILL_CFG, drill_config(3, n_data=2, zero=True),
                 device="cpu",
                 chaos=ChaosPlan([Fault("kill_stage", **DRILL_KILL)]))
    tr2, state, info = train_elastic(tr, source, state=tr._capture(0),
                                     max_steps=DRILL_STEPS,
                                     log_fn=lambda m: None)
    out = {"rank": mesh.rank, "stage": mesh.stage, "data": mesh.data}
    if tr2 is None:
        out["retired"] = info["retired"]
        return out
    full = tr2._full_state(state)
    out.update(
        grid=tr2.mesh.grid.tolist(), loss_by_step=info["loss_by_step"],
        recoveries=[{k: v for k, v in r.items() if k != "recovery_s"}
                    for r in info["recoveries"]],
        state=None if full is None else {
            "model": _np(full.model),
            "moments": {g: _np({k: st[k] for k in ("exp_avg",
                                                   "exp_avg_sq")})
                        for g, st in full.optimizer["state"].items()}})
    return out
