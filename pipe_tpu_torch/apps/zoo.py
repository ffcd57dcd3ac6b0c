"""Model-zoo entry point: train a BASELINE config family on the card.

Counterpart of ``pipe_tpu/apps/zoo.py``:
``python -m pipe_tpu_torch.apps.zoo gpt2|bert|vit [options]`` builds the
family's pipelined factorization (random weights from a seed) and trains it
for a few steps on random data from a seed through the one-device table
executor (``parallel/scheduled.py``) with Adam:

* ``gpt2``: causal LM (config #3; pair with ``--schedule 1f1b``);
* ``bert``: masked-LM pretraining with 80/10/10 masking (config #4; pair
  with ``--schedule interleaved-1f1b``), the rows weighted by
  ``mlm_weights``;
* ``vit``: image classification on random images and labels (config #5).

Every schedule runs on the tables: on one device the table ``gpipe`` stands
in for ``pipe_tpu``'s ``SpmdPipeline``; ``1f1b``, ``zb-h1`` and
``interleaved-1f1b`` (``--stages`` x ``--interleave`` virtual stages) are the
tables of ``pipe_tpu``. ``--tiny`` keeps it CPU-sized; ``--device cpu`` runs
every kernel's plain version.

``--world N`` (N = ``--stages``; ``pipe_tpu``'s ``make_mesh(args.stages,
1)`` over its ``--cpu N`` virtual mesh) spawns N stage ranks
(``runtime.distributed.launch``, backend ``gloo``; on the card they share
it): ``gpipe`` trains through ``SpmdPipeline(mesh=)``, the other schedules
through ``ScheduledPipeline(mesh=)``, as ``pipe_tpu`` picks them. Each rank
builds the model from the seed and keeps its stage (``parallel.mesh.
localize``); rank 0 prints the lines of the one-device run.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def synthetic_batch(family: str, cfg, rows: int, step: int, device):
    """The zoo's random batch of ``step`` (a generator seeded ``1000 +
    step`` on ``device``): ViT images and labels; tokens, for BERT masked by
    :func:`~pipe_tpu_torch.models.bert.mask_tokens` with targets and
    ``mlm_weights``, for GPT-2 with their shifted targets."""
    import torch

    from pipe_tpu_torch.models.bert import mask_tokens

    gen = torch.Generator(device=device).manual_seed(1000 + step)
    if family == "vit":
        images = torch.randn((rows, cfg.image_size, cfg.image_size,
                              cfg.channels), generator=gen, device=device)
        labels = torch.randint(0, cfg.n_classes, (rows,), generator=gen,
                               device=device)
        return {"images": images, "labels": labels}
    tokens = torch.randint(2, cfg.vocab, (rows, cfg.seq_len), generator=gen,
                           device=device)
    if family == "bert":
        masked, weights = mask_tokens(gen, tokens, cfg)
        return {"tokens": masked, "targets": tokens, "mlm_weights": weights}
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, -1)}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("family", choices=["gpt2", "bert", "vit"])
    p.add_argument("--checkpoint", default="except_last",
                   choices=["never", "except_last", "always"])
    p.add_argument("--schedule", default="1f1b",
                   choices=["gpipe", "1f1b", "zb-h1", "interleaved-1f1b"])
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--interleave", type=int, default=2,
                   help="virtual stages per device (interleaved-1f1b)")
    p.add_argument("--steps", type=int, default=8,
                   help="training steps (>= 1)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--world", type=int, default=1,
                   help="stage ranks spawned here over gloo, one a stage "
                        "(must equal --stages)")
    return p


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.steps < 1:
        parser.error("--steps must be >= 1")
    if args.stages < 1 or args.interleave < 1:
        parser.error("--stages and --interleave must be >= 1")
    if args.world > 1:
        if args.world != args.stages:
            print(f"--world {args.world} must equal --stages {args.stages} "
                  f"(one rank a stage)", file=sys.stderr)
            return 2
        out = run_world(list(sys.argv[1:] if argv is None else argv))[0]
        sys.stdout.write(out["stdout"])
        return 0
    train(args)
    return 0


def run_world(argv, timeout: float = 3600.0) -> list:
    """Spawn ``--world`` stage ranks and run :func:`train` on each: their
    result dicts in rank order (rank 0's with its printed lines under
    ``stdout``)."""
    from pipe_tpu_torch.runtime.distributed import launch

    args = build_argparser().parse_args(argv)
    threads = (max(1, (os.cpu_count() or 1) // args.world)
               if args.device == "cpu" else 0)
    return launch(_rank_main, args.world, list(argv), device=args.device,
                  backend="gloo", timeout=timeout, threads=threads)


def _rank_main(argv) -> dict:
    """One stage rank of ``--world``: :func:`train` over the world's mesh,
    rank 0's lines captured."""
    import contextlib
    import io

    from pipe_tpu_torch.parallel.mesh import make_mesh

    args = build_argparser().parse_args(argv)
    mesh = make_mesh(args.stages, 1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out if mesh.rank == 0
                                    else io.StringIO()):
        res = train(args, mesh)
    res["stdout"] = out.getvalue()
    return res


def _local_modules(model, mesh, n_virtual: int) -> list:
    """What this stage rank runs of ``model``: the blocks of its virtual
    stages ``s % d == stage``, the embedding on stage 0, the head on the
    last."""
    d, p = mesh.n_stages, mesh.stage
    keep = [model.stage_blocks(s) for s in range(n_virtual) if s % d == p]
    if p == 0:
        keep += [m for name, m in model.named_children()
                 if name not in ("blocks", model.post_key)]
    if p == d - 1:
        keep.append(model.head)
    return keep


def train(args, mesh=None) -> dict:
    """The zoo's training flow on this process: one device, or with ``mesh``
    this stage rank's part of the world. Prints the step lines; returns the
    losses, the ms per step and the model's layer count."""
    import dataclasses
    import warnings

    import torch

    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
    from pipe_tpu_torch.models import (BertConfig, GPT2Config, PipelinedBERT,
                                       PipelinedGPT2, PipelinedViT,
                                       ViTConfig)
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.parallel.spmd import SpmdPipeline
    from pipe_tpu_torch.utils.platform import resolve_device

    device = mesh.device if mesh is not None else resolve_device(args.device)
    v = args.interleave if args.schedule == "interleaved-1f1b" else 1
    n_virtual = args.stages * v

    cfg_cls = {"gpt2": GPT2Config, "bert": BertConfig,
               "vit": ViTConfig}[args.family]
    cfg = cfg_cls()
    if args.tiny:
        cfg = cfg.tiny()
    # the model must factor into the virtual stage count
    if cfg.n_layers % n_virtual:
        adjusted = max(1, cfg.n_layers // n_virtual) * n_virtual
        print(f"note: n_layers {cfg.n_layers} -> {adjusted} to factor into "
              f"{n_virtual} virtual stages")
        cfg = dataclasses.replace(cfg, n_layers=adjusted)
    model_cls = {"gpt2": PipelinedGPT2, "bert": PipelinedBERT,
                 "vit": PipelinedViT}[args.family]
    model = model_cls(cfg, n_virtual, device=device,
                      generator=torch.Generator(device=device)
                      .manual_seed(0))
    if mesh is not None:
        from pipe_tpu_torch.parallel.mesh import localize
        localize(model, _local_modules(model, mesh, n_virtual), device)

    if args.schedule == "interleaved-1f1b" and v == 1:
        print("note: --interleave 1 makes interleaved-1f1b the plain 1f1b "
              "schedule")
    sched_obj = (InterleavedOneFOneBSchedule(interleave=v)
                 if args.schedule == "interleaved-1f1b" else args.schedule)
    with warnings.catch_warnings():
        # zb-h1 under a recompute mode warns that W carries no compute;
        # pipe_tpu's zoo passes the mode through all the same
        warnings.simplefilter("ignore")
        if mesh is not None and args.schedule == "gpipe":
            sched = SpmdPipeline(model.stage_fn, model.pre_fn,
                                 model.loss_post_fn, args.stages, module=model,
                                 checkpoint=args.checkpoint,
                                 post_with_batch=True, mesh=mesh)
        else:
            sched = ScheduledPipeline(model.stage_fn, model.pre_fn,
                                      model.loss_post_fn,
                                      n_stages=args.stages, module=model,
                                      checkpoint=args.checkpoint,
                                      schedule=sched_obj, device=device,
                                      mesh=mesh)
    opt = torch.optim.Adam([p for p in model.parameters()
                            if p.device.type != "meta"], lr=args.lr)

    n_params = sum(p.numel() for p in model.parameters())
    where = (f"{args.stages} stage ranks" if mesh is not None
             else f"{args.stages} stages of 1 device")
    print(f"{args.family}: {n_params:,} params, {n_virtual} virtual stages "
          f"on {where}, schedule={args.schedule}, "
          f"checkpoint={args.checkpoint}")
    t_start = t0 = time.perf_counter()
    losses = []
    for b in range(args.steps):
        x, n_rows = mb.stack_scatter(
            synthetic_batch(args.family, cfg, args.batch, b, device),
            args.chunks)
        # zero-weight the rows stack_scatter padded
        w = mb.valid_row_mask(x, n_rows)
        opt.zero_grad(set_to_none=True)
        loss, _ = sched.loss_and_grad(x, w, seed=b)
        opt.step()
        l = loss.item()
        losses.append(l)
        if b == 0:
            t0 = time.perf_counter()  # timing from step 2 (skip warm-up)
        print(f"| step {b + 1}/{args.steps} | loss {l:.4f}")
    if args.steps > 1:
        ms = (time.perf_counter() - t0) / (args.steps - 1) * 1000
    else:
        ms = (time.perf_counter() - t_start) * 1000  # warm-up inclusive
    print(f"final loss {l:.4f} ({ms:.1f} ms/step)")
    return {"losses": losses, "ms_per_step": ms, "n_layers": cfg.n_layers}


if __name__ == "__main__":
    raise SystemExit(main())
