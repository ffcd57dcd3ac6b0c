"""What the ranks of the MoE tests' gloo worlds run (tests/test_torch_moe.py,
tests/test_torch_moe_gen.py).

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
from pipe_tpu_torch.models.moe_lm import MoELMConfig, MoEPipelinedLM
from pipe_tpu_torch.ops.moe import moe_ffn_apply, moe_ffn_specs
from pipe_tpu_torch.parallel.mesh import (MODEL_AXIS, flat_specs,
                                          gather_model_shards, make_mesh,
                                          shard_params)
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline


def _np(t):
    return t.detach().cpu().numpy().copy()


def mesh_of(shape):
    """``make_mesh(stages, data, n_model=m)`` over the world."""
    s, d, m = shape
    return make_mesh(s, d, n_model=m)


def ep_layer(params, h, n_experts, k, capacity_factor, shape=(2, 1, 2)):
    """``moe_ffn_apply`` over this rank's model line on its expert slice of
    ``pipe_tpu``'s whole ``moe_ffn_init`` params: the output, the aux loss,
    the gradients of ``sum(out ** 2) + 0.01 * aux`` (the local leaves',
    gathered over the line into whole leaves, and the input's), and the
    model line's all-reduces (forward and backward)."""
    mesh = mesh_of(shape)
    mod = torch.nn.Module()
    for name, v in params.items():
        mod.register_parameter(name, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    specs = flat_specs(moe_ffn_specs())
    shard_params(mod, specs, mesh)
    p = dict(mod.named_parameters())
    x = torch.from_numpy(h.copy()).requires_grad_()
    mesh.reset_stats()
    out, aux = moe_ffn_apply(p, x, n_experts=n_experts, k=k,
                             capacity_factor=capacity_factor, mesh=mesh)
    fwd = mesh.stats.as_dict()["model_collectives"]
    ((out ** 2).sum() + 0.01 * aux).backward()
    stats = mesh.stats.as_dict()
    grads = gather_model_shards(mesh, {n: q.grad for n, q in p.items()},
                                specs)
    return dict(rank=mesh.rank, model=mesh.model, out=_np(out),
                aux=float(aux), grads={n: _np(g) for n, g in grads.items()},
                local={n: tuple(q.shape) for n, q in p.items()},
                h_grad=_np(x.grad), fwd_allreduces=fwd,
                allreduces=stats["model_collectives"],
                collectives=stats["collectives"])


def _model(cfg_kw, shape, params, dropout=0.0, device="cpu"):
    """This rank's ``MoEPipelinedLM`` with ``pipe_tpu``'s whole params
    loaded into its stage (the rest on ``meta``), on ``device`` (``cuda``:
    the rank's card)."""
    mesh = mesh_of(shape)
    cfg = MoELMConfig(**dict(cfg_kw, dropout=dropout))
    model = MoEPipelinedLM(cfg, shape[0], mesh=mesh, device=mesh.device
                           if device == "cuda" else device)
    convert.load_ring_stage(model, params, mesh.stage, mesh.n_stages)
    return mesh, model


def _pipe(model, mesh, schedule="1f1b", checkpoint="except_last",
          specs=None, **kw):
    return ScheduledPipeline(
        model.stage_fn, model.pre_fn, model.loss_post_fn,
        n_stages=mesh.n_stages, module=model, checkpoint=checkpoint,
        schedule=schedule, mesh=mesh,
        stage_param_specs=specs or model.stage_param_specs(), **kw)


def moe_step(params, cfg_kw, shape, x, w, checkpoint="except_last",
             dropout=0.0, seed=0, device="cpu"):
    """``ScheduledPipeline(stage_param_specs=)`` over ``MoEPipelinedLM`` at
    ``shape``, one 1f1b ``loss_and_grad``: the loss, this rank's local
    gradients by name, the gradients gathered over the model line into
    whole leaves, the names the executor cut and their local shapes, and
    the device types of the rank's parameters and gradients."""
    mesh, model = _model(cfg_kw, shape, params, dropout, device)
    pipe = _pipe(model, mesh, checkpoint=checkpoint)
    model.zero_grad(set_to_none=True)
    mesh.reset_stats()
    dev = mesh.device
    loss, grads = pipe.loss_and_grad({k: torch.from_numpy(v).to(dev)
                                      for k, v in x.items()},
                                     torch.from_numpy(w).to(dev), seed=seed)
    devices = sorted({t.device.type for t in [*model.parameters(),
                                              *grads.values()]
                      if t.device.type != "meta"})
    sharded = sorted(n for n, spec in pipe._param_specs.items()
                     if spec.dim_of(MODEL_AXIS) is not None)
    shapes = dict(model.named_parameters())
    return dict(rank=mesh.rank, stage=mesh.stage, data=mesh.data,
                model=mesh.model, loss=float(loss),
                grads={k: _np(g) for k, g in grads.items()},
                full={k: _np(g) for k, g in
                      pipe.gather_model_grads(grads).items()},
                sharded=sharded,
                local={n: tuple(shapes[n].shape) for n in sharded
                       if shapes[n].device.type != "meta"},
                stats=mesh.stats.as_dict(), devices=devices)


def spec_refusals(params, cfg_kw, shape):
    """The MoE model's refusals, as ``(type, message)``: a block with whole
    experts over a line of 2 (before any executor cuts them), a spec tree
    that does not match the stage's blocks, ``split_stage`` with specs."""
    mesh, model = _model(cfg_kw, shape, params)
    out = {}
    for name, fn in (
            ("whole", lambda: model.blocks[0](
                torch.zeros(1, 2, cfg_kw["d_model"]))),
            ("structure", lambda: _pipe(model, mesh,
                                        specs=[{"moe": "flat"}])),
            ("split", lambda: _pipe(model, mesh, schedule="zb-h1",
                                    checkpoint="never", split_stage="auto"))):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out


def generate(params, cfg_kw, shape, prompt, gen_kw, seed=0):
    """``TPShardedGenerator`` over ``MoEPipelinedLM`` at ``shape``'s mesh:
    ``generate``'s tokens, and with beams ``generate_with_scores``' too; the
    heads and experts this rank holds, and the model line's all-reduces of
    the greedy call."""
    mesh = mesh_of(shape)
    model = MoEPipelinedLM(MoELMConfig(**cfg_kw), 1, device="cpu")
    convert.load_pipelined_lm(model, params)
    g = TPShardedGenerator(mesh, model, GenerationConfig(**gen_kw))
    blk = model.blocks[0]
    out = dict(rank=mesh.rank, model=mesh.model,
               heads=int(blk.wqkv.shape[2]), experts=int(blk.moe.w1.shape[0]),
               cache=tuple(blk.attn.make_cache(1, 4)["k"].shape))
    mesh.reset_stats()
    out["tokens"] = _np(g.generate(torch.from_numpy(prompt), seed=seed))
    out["allreduces"] = mesh.stats.as_dict()["model_collectives"]
    if gen_kw.get("num_beams", 1) > 1:
        toks, scores = g.generate_with_scores(torch.from_numpy(prompt))
        out["beam"], out["scores"] = _np(toks), _np(scores)
    return out


def generator_refusals(cfg_kw, shape):
    """``TPShardedGenerator``'s validations over the MoE model, as ``(type,
    message)``; ``shape``: a mesh whose model axis ``cfg_kw``'s heads and
    experts divide over, and 6 experts do not."""
    mesh = mesh_of(shape)
    cfg = MoELMConfig(**cfg_kw)
    out = {}
    for name, fn in (
            ("ep_axis", lambda: TPShardedGenerator(
                mesh, MoEPipelinedLM(cfg, 1, ep_axis=None, device="cpu"))),
            ("experts", lambda: TPShardedGenerator(
                mesh, MoEPipelinedLM(MoELMConfig(**dict(cfg_kw, n_experts=6)),
                                     1, device="cpu"))),
            ("nhead", lambda: TPShardedGenerator(
                mesh, MoEPipelinedLM(MoELMConfig(**dict(cfg_kw, nhead=2)),
                                     1, device="cpu")))):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out


def seeded_step(cfg_kw, shape, x, w):
    """A one-stage MoE step on the rank's card over a model line: the model
    drawn from seed 0 on the card (the same bits on every rank sharing
    it), cut by the executor; the loss, the gradients gathered over the
    line and the device types of the rank's parameters and gradients."""
    mesh = mesh_of(shape)
    model = MoEPipelinedLM(MoELMConfig(**cfg_kw), 1, mesh=mesh,
                           device=mesh.device,
                           generator=torch.Generator(device=mesh.device)
                           .manual_seed(0))
    pipe = _pipe(model, mesh)
    loss, grads = pipe.loss_and_grad(
        {k: torch.from_numpy(v).to(mesh.device) for k, v in x.items()},
        torch.from_numpy(w).to(mesh.device))
    return dict(loss=float(loss),
                grads={k: _np(g) for k, g in
                       pipe.gather_model_grads(grads).items()},
                devices=sorted({t.device.type for t in
                                [*model.parameters(), *grads.values()]}),
                experts=int(model.blocks[0].moe.w1.shape[0]))
