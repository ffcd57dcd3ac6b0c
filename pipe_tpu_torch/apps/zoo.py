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

Every schedule runs on the tables: the table ``gpipe`` stands in for
``pipe_tpu``'s ``SpmdPipeline`` (ROADMAP.md: A.8); ``1f1b``, ``zb-h1`` and
``interleaved-1f1b`` (``--stages`` x ``--interleave`` virtual stages) are the
tables of ``pipe_tpu``. ``--tiny`` keeps it CPU-sized; ``--device cpu`` runs
every kernel's plain version (``pipe_tpu``'s ``--cpu N`` virtual mesh has no
counterpart on one device).
"""

from __future__ import annotations

import argparse
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
    return p


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.steps < 1:
        parser.error("--steps must be >= 1")
    if args.stages < 1 or args.interleave < 1:
        parser.error("--stages and --interleave must be >= 1")

    import dataclasses
    import warnings

    import torch

    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
    from pipe_tpu_torch.models import (BertConfig, GPT2Config, PipelinedBERT,
                                       PipelinedGPT2, PipelinedViT,
                                       ViTConfig)
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
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

    if args.schedule == "interleaved-1f1b" and v == 1:
        print("note: --interleave 1 makes interleaved-1f1b the plain 1f1b "
              "schedule")
    sched_obj = (InterleavedOneFOneBSchedule(interleave=v)
                 if args.schedule == "interleaved-1f1b" else args.schedule)
    with warnings.catch_warnings():
        # zb-h1 under a recompute mode warns that W carries no compute;
        # pipe_tpu's zoo passes the mode through all the same
        warnings.simplefilter("ignore")
        sched = ScheduledPipeline(model.stage_fn, model.pre_fn,
                                  model.loss_post_fn, n_stages=args.stages,
                                  module=model, checkpoint=args.checkpoint,
                                  schedule=sched_obj, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"{args.family}: {n_params:,} params, {n_virtual} virtual stages "
          f"on {args.stages} stages of 1 device, schedule={args.schedule}, "
          f"checkpoint={args.checkpoint}")
    t_start = t0 = time.perf_counter()
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
        if b == 0:
            t0 = time.perf_counter()  # timing from step 2 (skip warm-up)
        print(f"| step {b + 1}/{args.steps} | loss {l:.4f}")
    if args.steps > 1:
        ms = (time.perf_counter() - t0) / (args.steps - 1) * 1000
    else:
        ms = (time.perf_counter() - t_start) * 1000  # warm-up inclusive
    print(f"final loss {l:.4f} ({ms:.1f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
