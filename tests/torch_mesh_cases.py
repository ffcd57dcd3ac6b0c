"""What the ranks of the mesh tests' gloo worlds run (tests/test_torch_mesh*.py).

Each function runs on every rank of a 4-rank world spawned by
``pipe_tpu_torch.runtime.World`` on the CPU and returns numpy results for the
test process, which holds them to ``pipe_tpu`` (or to the port's one-device
executors). This module imports neither JAX nor ``pipe_tpu``: the ranks never
load them.
"""

import dataclasses

import numpy as np
import torch

import pipe_tpu_torch as pt
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.models.common import per_row_ce
from pipe_tpu_torch.parallel.mesh import make_mesh


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def tiny_lm(vocab=101, **kw):
    return dataclasses.replace(tlm.LMConfig().tiny(), vocab=vocab,
                               attn_impl="xla", **kw)


def lm_pipe_step(schedule, checkpoint, n_parts, state_dicts, x, y,
                 shape=(2, 2), seed=None, dropout=0.0):
    """``Pipe(mesh=...)`` over the tiny LM: load the given per-partition
    state dicts (``shard_params``), one ``loss_and_grad`` and one eval
    forward. Returns the loss, every partition's gradients
    (``unshard_grads``), the forward's outputs and this rank's packed rows'
    shapes."""
    mesh = make_mesh(*shape)
    cfg = tiny_lm(dropout=dropout)
    pipe = pt.Pipe(tlm.build_sequential(cfg, device="cpu"), chunks=4,
                   n_stages=n_parts, checkpoint=checkpoint, schedule=schedule,
                   mesh=mesh)
    packed = pipe.shard_params(state_dicts)
    loss, grads = pipe.loss_and_grad(torch.from_numpy(x),
                                     targets=torch.from_numpy(y),
                                     loss_fn=per_row_ce, seed=seed)
    with torch.no_grad():
        out = pipe(torch.from_numpy(x))
    return dict(loss=float(loss), grads=pipe.unshard_grads(grads),
                out=_np(out), rows={k: tuple(v.shape)
                                    for k, v in packed.items()},
                stage=mesh.stage, data=mesh.data,
                plan=pipe.memory_plan())


def seq_pipe_step(kind, n_parts, state_dicts, x, y, schedule="1f1b",
                  chunks=2, shape=(2, 2)):
    """A ``Pipe(mesh=...)`` step of a small model with a cross-stage skip
    (``kind="skip"``: GPT-2 tiny with the embedding skip) or deferred
    BatchNorm (``kind="bn"``): loss, every partition's gradients, and this
    rank's partitions' buffers after the step."""
    from pipe_tpu_torch.models import gpt2

    mesh = make_mesh(*shape)
    if kind == "skip":
        gcfg = dataclasses.replace(gpt2.GPT2Config().tiny(), attn_impl="xla")
        seq = gpt2.build_sequential(gcfg, embed_skip=True, device="cpu")
        kw, loss_fn = {}, per_row_ce
    else:
        seq = bn_stack()
        kw = dict(deferred_batch_norm=True)

        def loss_fn(out, tgt):
            return (out - tgt).square().mean(-1)
    pipe = pt.Pipe(seq, chunks=chunks, n_stages=n_parts, schedule=schedule,
                   mesh=mesh, **kw)
    pipe.shard_params(state_dicts)
    loss, grads = pipe.loss_and_grad(torch.from_numpy(x),
                                     targets=torch.from_numpy(y),
                                     loss_fn=loss_fn, seed=None)
    bufs = {n: b for n, b in pipe.named_buffers() if b.device.type != "meta"}
    return dict(loss=float(loss), grads=pipe.unshard_grads(grads),
                buffers=_np(bufs), plan=pipe.memory_plan())


def bn_stack(width=6):
    """``[Linear -> BatchNorm] x 2 -> Linear(3)``, the BN model of the mesh
    tests, built the same way in the test process."""
    from pipe_tpu_torch.extras.norm import BatchNorm
    from pipe_tpu_torch.ops.layers import Linear

    g = torch.Generator().manual_seed(0)
    return pt.Sequential([Linear(width, width, device="cpu", generator=g),
                          BatchNorm(width, device="cpu"),
                          Linear(width, width, device="cpu", generator=g),
                          BatchNorm(width, device="cpu"),
                          Linear(width, 3, device="cpu", generator=g)])


def table_step(schedule, checkpoint, x, w, seed, shape=(2, 2),
               dropout=0.3, interleave=2):
    """One ``ScheduledPipeline`` step of the tiny LM (weights from a seed);
    on a mesh with ``shape``, one device without (``shape=None``). Returns
    the loss and the gradients of this process's parameters by name."""
    from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
    from pipe_tpu_torch.parallel.mesh import localize
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    cfg = tiny_lm(dropout=dropout)
    v = interleave if schedule == "interleaved-1f1b" else 1
    sched = (InterleavedOneFOneBSchedule(interleave=v) if v > 1
             else schedule)
    model = tlm.PipelinedLM(cfg, 2 * v, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    mesh = make_mesh(*shape) if shape else None
    if mesh is not None:
        keep = [model.stage_blocks(s) for s in range(2 * v)
                if s % 2 == mesh.stage]
        keep += ([model.embed, model.posenc] if mesh.stage == 0
                 else [model.decoder])
        localize(model, keep, "cpu")
    ex = ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                           n_stages=2, module=model, checkpoint=checkpoint,
                           schedule=sched, device="cpu", mesh=mesh)
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    loss, grads = ex.loss_and_grad(x, torch.from_numpy(w), seed=seed)
    return dict(loss=float(loss), grads=_np(grads),
                stats=mesh.stats.as_dict() if mesh else None)


def trainer_run(schedule, checkpoint, params, steps, source, zero=False,
                mu_dtype=None, interleave=2, save_dir=None,
                telemetry_dir=None):
    """A mesh ``Trainer`` over the tiny LM (dropout 0) from ``pipe_tpu``'s
    params (the ``PipelinedLM`` triple, stacked as ``pipe_tpu``'s trainer
    stacks it), ``steps`` steps over ``source``: the losses, and this rank's
    parameters by the one-device ``Pipe``'s names. ``save_dir``: save the
    checkpoint there after the steps (rank 0 writes it); ``telemetry_dir``:
    each rank's event log under ``rank{r}``."""
    from pipe_tpu_torch import convert
    from pipe_tpu_torch.train import Trainer, TrainerConfig

    cfg = tiny_lm(vocab=int(params[1]["embed"]["table"].shape[0]))
    tc = TrainerConfig(batch_size=8, bptt=cfg.seq_len, chunks=4,
                       n_stages=2, n_data=2, schedule=schedule,
                       checkpoint=checkpoint, lr=1e-2, zero=zero,
                       mu_dtype=mu_dtype, interleave=interleave,
                       telemetry_dir=telemetry_dir)
    tr = Trainer(cfg, tc, device="cpu")
    convert.load_pipelined_lm_params(
        tr.pipe, params, interleaved_devices=2 if schedule in (
            "interleaved", "interleaved-1f1b") else None)
    state = tr._capture(0)
    losses = []
    for b in range(steps):
        state, info = tr.train_epoch(source, state=state, max_steps=b + 1,
                                     start_step=b, log_every=0)
        losses.append(info["loss"])
    if save_dir is not None:
        tr.save(save_dir, state)
    return dict(losses=losses, params=_np({
        k: v for k, v in tr.pipe.state_dict().items()
        if v.device.type != "meta"}))


def dropout_pair(seed=9):
    """The tiny LM's 1f1b step with dropout 0.3 on a mesh; its loss and
    gradients, by name (the test runs the one-device step itself)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 101, (4, 4, 16)).astype(np.int64)
    x = {"tokens": toks, "targets": np.roll(toks, -1, -1)}
    w = np.ones((4, 4), np.float32)
    return table_step("1f1b", "except_last", x, w, seed=7)


def raise_on_rank(rank):
    """Rank ``rank`` raises while the others wait in an all-reduce."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


def ranks_and_grid(n_stages, n_data):
    """This rank's coordinates and the grid of :func:`make_mesh`, and its
    coordinates in ``global_pipeline_mesh``'s placement."""
    from pipe_tpu_torch.runtime.distributed import global_pipeline_mesh

    mesh = make_mesh(n_stages, n_data)
    g = global_pipeline_mesh(n_stages, n_data)
    return dict(rank=mesh.rank, stage=mesh.stage, data=mesh.data,
                grid=mesh.grid.tolist(), prev=mesh.prev, next=mesh.next,
                global_stage=g.stage, global_data=g.data)


def init_sharded(seed, n_parts=2):
    """``Pipe(mesh=...).init_sharded(seed)`` over the tiny LM: every
    partition's drawn parameters (``unshard_params``) and this rank's own."""
    mesh = make_mesh(2, 2)
    pipe = pt.Pipe(tlm.build_sequential(tiny_lm(), device="cpu"), chunks=4,
                   n_stages=n_parts, mesh=mesh)
    rows = pipe.init_sharded(seed)
    own = {f"partitions.{j}.{n}": p for j, part in enumerate(pipe.partitions)
           for n, p in part.named_parameters() if p.device.type != "meta"}
    return dict(all=pipe.unshard_params(rows), own=_np(own))
