"""What the ranks of the context-parallel tests' gloo worlds run
(tests/test_torch_context_attention.py, tests/test_torch_long_context.py,
tests/test_torch_long_context_gen.py).

Each function runs on every rank of a 4-rank world of CPU ranks spawned by
``pipe_tpu_torch.runtime.World`` and returns numpy results for the test
process, which holds them to ``pipe_tpu`` and to the port's one-device
paths. A mesh spans the whole world: a context axis of 2 runs as two data
(or stage) replicas of a 2-rank context line. This module imports neither
JAX nor ``pipe_tpu``: the ranks never load them.
"""

import contextlib
import io

import numpy as np
import torch

from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig
from pipe_tpu_torch.inference.long_context import ContextShardedGenerator
from pipe_tpu_torch.models.long_context_lm import ContextParallelLM
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.parallel.context import context_parallel_attention
from pipe_tpu_torch.parallel.mesh import make_mesh


def _np(t):
    return t.detach().cpu().numpy().copy()


def mesh_of(shape):
    """``make_mesh(stages, data, n_context=c)`` over the world."""
    s, d, c = shape
    return make_mesh(s, d, n_context=c)


def mesh_units(shape):
    """This rank's coordinates, grid and neighbours, a context shift each
    way, a tiled all-to-all both ways, a sum and a max over the line and
    a plane sum, and the stats they counted."""
    mesh = mesh_of(shape)
    mesh.reset_stats()
    me = torch.tensor([float(mesh.rank)])
    fwd = mesh.context_shift(me, 1)
    back = mesh.context_shift(me, -1)
    x = torch.arange(mesh.context_size * 3, dtype=torch.float32
                     ).reshape(1, mesh.context_size * 3) + 100 * mesh.context
    a2a = mesh.all_to_all(x.reshape(1, mesh.context_size, 3), 1, 2)
    a2a_back = mesh.all_to_all(a2a, 2, 1)
    total = me.clone()
    mesh.all_reduce(total, "context")
    top = me.clone()
    mesh.all_reduce(top, "context", op="max")
    plane = me.clone()
    mesh.all_reduce(plane, ("data", "context"))
    return dict(rank=mesh.rank, stage=mesh.stage, data=mesh.data,
                context=mesh.context, grid=mesh.grid.tolist(),
                prev=mesh.prev, next=mesh.next,
                axis_names=list(mesh.axis_names), fwd=float(fwd),
                back=float(back), a2a=_np(a2a), a2a_back=_np(a2a_back),
                x=_np(x), sum=float(total), max=float(top),
                plane=float(plane), stats=mesh.stats.as_dict())


def attention(shape, q, k, v, causal, impl, force_flash=False,
              first_shard_only=False, device="cpu"):
    """``context_parallel_attention`` on this rank's shard of the global
    ``q``/``k``/``v`` ``[b, s, h, d]``; then the gradients of
    ``sum(o ** 2)`` over the global output (over context rank 0's shard
    only, with ``first_shard_only``), on ``device``. Returns the output shard, the
    input gradients' shards and, with ``force_flash``, how often the three
    flash wrappers ran (Ulysses' attention through ``flash_attention``,
    whose plain versions run on the CPU)."""
    from pipe_tpu_torch.ops import flash_attention as tfa

    mesh = mesh_of(shape)
    c = mesh.context_size
    s_local = q.shape[1] // c
    sl = slice(mesh.context * s_local, (mesh.context + 1) * s_local)
    ins = [torch.from_numpy(np.ascontiguousarray(a[:, sl])).to(device)
           .requires_grad_() for a in (q, k, v)]
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    with contextlib.ExitStack() as stack:
        if force_flash:
            saved = {n: getattr(tfa, n) for n in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")}
            for key, name in (("fwd", "flash_attention_fwd"),
                              ("dq", "flash_attention_bwd_dq"),
                              ("dkv", "flash_attention_bwd_dkv")):
                def counted(*a, _f=saved[name], _k=key, **kw):
                    calls[_k] += 1
                    return _f(*a, **kw)
                setattr(tfa, name, counted)
            stack.callback(lambda: [setattr(tfa, n, f)
                                    for n, f in saved.items()])
            from pipe_tpu_torch.ops import layers as tl
            real = tl.flash_auto_ok
            tl.flash_auto_ok = lambda s, *a, **kw: tfa.supports(s)
            stack.callback(lambda: setattr(tl, "flash_auto_ok", real))
        o = context_parallel_attention(mesh, *ins, causal=causal, impl=impl)
        loss = (o.float() ** 2).sum()
        if first_shard_only and mesh.context:
            loss = loss * 0.0
        loss.backward()
    return dict(context=mesh.context, o=_np(o), stats=mesh.stats.as_dict(),
                grads=[_np(t.grad) for t in ins], calls=calls,
                finite=all(bool(torch.isfinite(t.grad).all()) for t in ins))


def refusals(shape):
    """The refusals of the context layer, as ``(type, message)``."""
    from pipe_tpu_torch.ops.ulysses_attention import ulysses_attention
    from pipe_tpu_torch.parallel.mesh import survivor_mesh

    mesh = mesh_of(shape)
    out = {}
    x = torch.zeros(1, 2, 3, 4)
    for name, fn in (
            ("heads", lambda: ulysses_attention(x, x, x, mesh)),
            ("impl", lambda: context_parallel_attention(mesh, x, x, x,
                                                        impl="nope")),
            ("survivor", lambda: survivor_mesh(mesh, 0)),
            ("model", lambda: make_mesh(1, 1, n_model=2))):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out


# --- the long-context LM ---

def _lm(cfg_kw, shape, params, sp_impl):
    mesh = mesh_of(shape)
    cfg = LMConfig(attn_impl="xla", **cfg_kw)
    model = ContextParallelLM(cfg, shape[0], sp_impl, mesh=mesh,
                              device="cpu")
    convert.load_ring_stage(model, params, mesh.stage, mesh.n_stages)
    return mesh, model


def spmd_step(params, cfg_kw, shape, x, sp_impl):
    """``SpmdPipeline(context_axis="context")`` over ``ContextParallelLM``
    at ``shape``: the per-row losses of the forward and one
    ``loss_and_grad`` with unit row weights (this rank's gradients, by
    name)."""
    from pipe_tpu_torch.parallel.spmd import SpmdPipeline

    mesh, model = _lm(cfg_kw, shape, params, sp_impl)
    pipe = SpmdPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                        n_stages=mesh.n_stages, module=model,
                        post_with_batch=True, mesh=mesh, device="cpu",
                        context_axis="context")
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        per_row = pipe(xt)
    m, rows = x["tokens"].shape[:2]
    model.zero_grad(set_to_none=True)
    loss, grads = pipe.loss_and_grad(xt, torch.ones(m, rows))
    return dict(per_row=_np(per_row), loss=float(loss),
                grads={k: _np(g) for k, g in grads.items()},
                stage=mesh.stage, context=mesh.context)


def table_steps(params, cfg_kw, shape, x, sp_impl="ring"):
    """One step of the 1f1b table (except_last) with ``context_axis`` under
    each walk (serialized, overlapped, phase-compiled) and the gpipe step
    of ``SpmdPipeline``: each one's loss and this rank's gradients."""
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.parallel.spmd import SpmdPipeline

    mesh, model = _lm(cfg_kw, shape, params, sp_impl)
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    w = torch.ones(x["tokens"].shape[:2])
    out = {}
    for name, kw in (("serialized", {}),
                     ("overlapped", dict(overlap_transport=True)),
                     ("phase", dict(phase_compile=True))):
        pipe = ScheduledPipeline(
            model.stage_fn, model.pre_fn, model.loss_post_fn,
            n_stages=mesh.n_stages, module=model, checkpoint="except_last",
            schedule="1f1b", device="cpu", mesh=mesh,
            context_axis="context", **kw)
        model.zero_grad(set_to_none=True)
        loss, grads = pipe.loss_and_grad(xt, w)
        out[name] = dict(loss=float(loss), transport=pipe.memory_plan(
            x["tokens"].shape[0])["transport"],
            grads={k: _np(g) for k, g in grads.items()})
    gp = SpmdPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                      n_stages=mesh.n_stages, module=model,
                      post_with_batch=True, mesh=mesh, device="cpu",
                      context_axis="context")
    model.zero_grad(set_to_none=True)
    loss, grads = gp.loss_and_grad(xt, w)
    out["gpipe"] = dict(loss=float(loss),
                        grads={k: _np(g) for k, g in grads.items()})
    return out


def debug_check(params, cfg_kw, shape, x):
    """``debug_context_check``: the model's averaged loss passes untouched;
    a post that returns each shard's first token (context-variant) is
    poisoned with NaN and prints one line (on context rank 0)."""
    from pipe_tpu_torch.parallel.spmd import SpmdPipeline

    mesh, model = _lm(cfg_kw, shape, params, "ring")
    xt = {k: torch.from_numpy(v) for k, v in x.items()}

    def bad_post(h, x_mb, ctx):
        return x_mb["tokens"][:, 0].to(torch.float32)

    out = {}
    for name, post in (("good", model.loss_post_fn), ("bad", bad_post)):
        pipe = SpmdPipeline(model.stage_fn, model.pre_fn, post,
                            n_stages=mesh.n_stages, module=model,
                            post_with_batch=True, mesh=mesh, device="cpu",
                            context_axis="context", debug_context_check=True)
        buf = io.StringIO()
        with torch.no_grad(), contextlib.redirect_stdout(buf):
            res = pipe(xt)
        out[name] = dict(out=_np(res), printed=buf.getvalue())
    out["context"] = mesh.context
    return out


# --- the context-sharded generator ---

def generate(params, cfg_kw, shape, prompt, gen_kw, seed=0):
    """``ContextShardedGenerator`` over a ``shape`` mesh holding every
    weight: tokens (and scores for beams), every rank; the prompt cache's
    collectives counted."""
    mesh = mesh_of(shape)
    cfg = LMConfig(attn_impl="xla", **cfg_kw)
    model = ContextParallelLM(cfg, 1, mesh=mesh, device="cpu")
    convert.load_pipelined_lm(model, params)
    g = ContextShardedGenerator(mesh, model, GenerationConfig(**gen_kw))
    mesh.reset_stats()
    if gen_kw.get("num_beams", 1) > 1:
        toks, scores = g.generate_with_scores(prompt)
        routed = g.generate(prompt)
        return dict(tokens=_np(toks), scores=_np(scores),
                    routed=_np(routed))
    toks = g.generate(prompt, seed=seed)
    return dict(tokens=_np(toks), stats=mesh.stats.as_dict())


def generator_refusals(params, cfg_kw, shape):
    """The generator's validations, as ``(type, message)``."""
    mesh = mesh_of(shape)
    cfg = LMConfig(attn_impl="xla", **cfg_kw)
    model = ContextParallelLM(cfg, 1, mesh=mesh, device="cpu")
    convert.load_pipelined_lm(model, params)
    g = ContextShardedGenerator(mesh, model,
                                GenerationConfig(max_new_tokens=2))
    out = {}
    for name, fn in (
            ("divide", lambda: g.generate(np.zeros((1, 7), np.int64))),
            ("beams", lambda: g.generate_with_scores(
                np.zeros((1, 8), np.int64))),
            ("mesh", lambda: ContextShardedGenerator(
                make_mesh(4, 1), model, GenerationConfig(max_new_tokens=2))),
            ("positions", lambda: g.generate(np.zeros((1, 5000), np.int64)))):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 -- reported
            out[name] = (type(e).__name__, str(e))
    return out


def axis_refusal():
    """``context_axis`` over a mesh without the axis: JAX's words."""
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    mesh = make_mesh(2, 2)
    model = ContextParallelLM(LMConfig().tiny(), 2, device="cpu")
    try:
        ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                          n_stages=2, module=model, mesh=mesh,
                          context_axis="context")
    except ValueError as e:
        return str(e)
    return None


def seeded_step(cfg_kw, shape, x, sp_impl, device):
    """One ``SpmdPipeline(context_axis=)`` step of a ``ContextParallelLM``
    whose weights every rank draws from seed 0 on ``device`` (no JAX
    params): the loss and this rank's gradients, by name."""
    import torch

    from pipe_tpu_torch.parallel.spmd import SpmdPipeline

    mesh = mesh_of(shape)
    model = ContextParallelLM(
        LMConfig(**cfg_kw), 1, sp_impl, mesh=mesh, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    pipe = SpmdPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                        n_stages=1, module=model, post_with_batch=True,
                        mesh=mesh, device=device, context_axis="context")
    xt = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    loss, grads = pipe.loss_and_grad(
        xt, torch.ones(x["tokens"].shape[:2], device=device))
    return dict(loss=float(loss), grads={k: _np(g) for k, g in grads.items()})
