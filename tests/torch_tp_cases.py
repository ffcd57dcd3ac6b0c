"""What the ranks of the tensor-parallel tests' gloo worlds run
(tests/test_torch_tp.py, tests/test_torch_tp_gen.py).

Each function runs on every rank of a 4-rank world of CPU ranks spawned by
``pipe_tpu_torch.runtime.World`` and returns numpy results for the test
process, which holds them to ``pipe_tpu`` and to the port's one-device
paths. A mesh spans the whole world: a model axis of 2 runs as two stage
(or data) replicas of a 2-rank model line. This module imports neither JAX
nor ``pipe_tpu``: the ranks never load them.
"""

import torch

from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig
from pipe_tpu_torch.inference.tp import TPShardedGenerator
from pipe_tpu_torch.models.tp_lm import TPPipelinedLM
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline


def _np(t):
    return t.detach().cpu().numpy().copy()


def mesh_of(shape):
    """``make_mesh(stages, data, n_model=m)`` over the world."""
    s, d, m = shape
    return make_mesh(s, d, n_model=m)


def mesh_units(shape):
    """This rank's coordinates, grid and neighbours, sums over the model
    line, the data group and the plane, a gather over the model line, the
    group sizes and the stats they counted."""
    mesh = mesh_of(shape)
    mesh.reset_stats()
    me = torch.tensor([float(mesh.rank)])
    out = {}
    for name, over in (("model", MODEL_AXIS), ("data", "data"),
                       ("plane", ("data", "context")), ("stage", "stage"),
                       ("world", "world")):
        t = me.clone()
        mesh.all_reduce(t, over)
        out[f"sum_{name}"] = float(t)
        out[f"size_{name}"] = mesh.group_size(over)
    gathered = mesh.all_gather(me, MODEL_AXIS)
    return dict(out, rank=mesh.rank, stage=mesh.stage, data=mesh.data,
                model=mesh.model, grid=mesh.grid.tolist(), prev=mesh.prev,
                next=mesh.next, axis_names=list(mesh.axis_names),
                gathered=[float(g) for g in gathered],
                rank_of=mesh.rank_of(0, 0, model=mesh.n_model - 1),
                stats=mesh.stats.as_dict(), repr=repr(mesh))


def _model(cfg_kw, shape, params, dropout=0.0):
    """This rank's ``TPPipelinedLM`` with ``pipe_tpu``'s whole params
    loaded into its stage (the rest on ``meta``)."""
    mesh = mesh_of(shape)
    cfg = LMConfig(**dict(cfg_kw, dropout=dropout))
    model = TPPipelinedLM(cfg, shape[0], mesh=mesh, device="cpu")
    convert.load_ring_stage(model, params, mesh.stage, mesh.n_stages)
    return mesh, model


def _pipe(model, mesh, schedule="1f1b", checkpoint="except_last", **kw):
    return ScheduledPipeline(
        model.stage_fn, model.pre_fn, model.loss_post_fn,
        n_stages=mesh.n_stages, module=model, checkpoint=checkpoint,
        schedule=schedule, device="cpu", mesh=mesh,
        stage_param_specs=model.stage_param_specs(), **kw)


def tp_step(params, cfg_kw, shape, x, w, checkpoint="except_last",
            dropout=0.0, seed=0, walks=("serialized",)):
    """``ScheduledPipeline(stage_param_specs=)`` over ``TPPipelinedLM`` at
    ``shape``, one 1f1b ``loss_and_grad`` per walk (serialized, overlapped,
    phase-compiled): each walk's loss, this rank's local gradients by name
    and, for the first walk, the gradients gathered over the model line
    into whole leaves."""
    mesh, model = _model(cfg_kw, shape, params, dropout)
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    wt = torch.from_numpy(w)
    kws = {"serialized": dict(overlap_transport=False, phase_compile=False),
           "overlapped": dict(overlap_transport=True, phase_compile=False),
           "phase": dict(phase_compile=True)}
    out = dict(rank=mesh.rank, stage=mesh.stage, data=mesh.data,
               model=mesh.model, walks={})
    for name in walks:
        pipe = _pipe(model, mesh, checkpoint=checkpoint, **kws[name])
        model.zero_grad(set_to_none=True)
        mesh.reset_stats()
        loss, grads = pipe.loss_and_grad(xt, wt, seed=seed)
        out["walks"][name] = dict(
            loss=float(loss), transport=pipe.memory_plan(
                x["tokens"].shape[0])["transport"],
            grads={k: _np(g) for k, g in grads.items()},
            stats=mesh.stats.as_dict())
        if "full" not in out:
            out["full"] = {k: _np(g) for k, g in
                           pipe.gather_model_grads(grads).items()}
            out["sharded"] = sorted(
                n for n, spec in pipe._param_specs.items()
                if spec.dim_of(MODEL_AXIS) is not None)
    return out


def spec_mismatch(params, cfg_kw, shape):
    """The structure error of a spec tree that does not match the stage's
    blocks, as ``(type, message)``; and that of ``split_stage`` with
    specs."""
    mesh, model = _model(cfg_kw, shape, params)
    out = {}
    for name, kw in (("structure", dict(stage_param_specs={"wrong": "shape"})),
                     ("split", dict(schedule="zb-h1", checkpoint="never",
                                    split_stage="auto",
                                    stage_param_specs=model
                                    .stage_param_specs()))):
        try:
            ScheduledPipeline(model.stage_fn, model.pre_fn,
                              model.loss_post_fn, n_stages=mesh.n_stages,
                              module=model, device="cpu", mesh=mesh, **kw)
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out


def refusals(shape):
    """The mesh-level refusals of a model mesh, as ``(type, message)``."""
    from pipe_tpu_torch.parallel.mesh import carve_meshes, survivor_mesh

    mesh = mesh_of(shape)
    out = {}
    for name, fn in (
            ("survivor", lambda: survivor_mesh(mesh, 0)),
            ("carve", lambda: carve_meshes([mesh.grid])),
            ("n_model", lambda: make_mesh(1, 1, n_model=0)),
            ("divides", lambda: make_mesh(1, n_model=3)),
            ("shape", lambda: make_mesh(1, 1, n_model=2)),
            ("unsharded", lambda: _unsharded_block(mesh))):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out


def _unsharded_block(mesh):
    """A TP block with whole heads over a model line of 2 (no cut)."""
    from pipe_tpu_torch.ops.tp_layers import TPBlock
    blk = TPBlock(8, 2, 16, mesh=mesh, device="cpu")
    blk(torch.zeros(1, 2, 8))


def generate(params, cfg_kw, shape, prompt, gen_kw, seed=0):
    """``TPShardedGenerator`` over ``shape``'s mesh: ``generate``'s
    tokens, and with beams ``generate_with_scores``' too."""
    mesh = mesh_of(shape)
    model = TPPipelinedLM(LMConfig(**cfg_kw), 1, device="cpu")
    convert.load_pipelined_lm(model, params)
    g = TPShardedGenerator(mesh, model, GenerationConfig(**gen_kw))
    out = dict(rank=mesh.rank, model=mesh.model,
               heads=int(model.blocks[0].wqkv.shape[2]),
               cache=tuple(model.blocks[0].attn.make_cache(1, 4)["k"].shape))
    out["tokens"] = _np(g.generate(torch.from_numpy(prompt), seed=seed))
    if gen_kw.get("num_beams", 1) > 1:
        toks, scores = g.generate_with_scores(torch.from_numpy(prompt))
        out["beam"], out["scores"] = _np(toks), _np(scores)
    return out


def generator_refusals(cfg_kw, shape):
    """``TPShardedGenerator``'s three validations and the beam guard, as
    ``(type, message)``; ``shape``: a mesh whose model axis ``cfg_kw``'s
    heads divide over and 2 heads do not."""
    mesh = mesh_of(shape)
    cfg = LMConfig(**cfg_kw)
    out = {}
    for name, fn in (
            ("tp_axis", lambda: TPShardedGenerator(
                mesh, TPPipelinedLM(cfg, 1, tp_axis=None, device="cpu"))),
            ("axis", lambda: TPShardedGenerator(
                make_mesh(4, 1), TPPipelinedLM(cfg, 1, device="cpu"))),
            ("nhead", lambda: TPShardedGenerator(
                mesh, TPPipelinedLM(LMConfig(**dict(cfg_kw, nhead=2,
                                                    d_model=cfg.d_model)),
                                    1, device="cpu"))),
            ("beams", lambda: TPShardedGenerator(
                mesh, TPPipelinedLM(cfg, 1, device="cpu"),
                GenerationConfig(max_new_tokens=2)).generate_with_scores(
                    torch.zeros(2, 4, dtype=torch.int64)))):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out
