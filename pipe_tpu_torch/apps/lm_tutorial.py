"""Tutorial entry point: the reference ``main.py`` flow on a CUDA card.

Counterpart of ``pipe_tpu/apps/lm_tutorial.py``: corpus → tokenizer → vocab →
batchify (``main.py:76-105``) → Transformer LM (emsize 2048, nhid 2048,
nlayers 16, nhead 32, dropout 0.2, ``main.py:115-120``) → ``Pipe`` over
stages with chunks=4 (``main.py:162-171``) → Adam + StepLR + clip, ~8·bptt
tokens (``main.py:182-234``).

Usage (mirrors ``python main.py <checkpoint-mode>``, ``main.py:164-169``):
    python -m pipe_tpu_torch.apps.lm_tutorial <never|except_last|always>
        [--corpus FILE] [--steps N] [--epochs N] [--stages N] [--chunks N]
        [--schedule gpipe|1f1b|zb-h1|interleaved-1f1b] [--interleave V]
        [--lr LR] [--plan auto|PLAN.json] [--tiny] [--profile DIR]
        [--save DIR] [--resume DIR] [--autosave DIR] [--device cuda|cpu]
        [--world N]

``--schedule gpipe`` trains through ``Pipe``; ``1f1b``, ``zb-h1`` and
``interleaved-1f1b`` (``--interleave`` virtual stages a stage) through the
table executor (``parallel/scheduled.py``; zb-h1 under ``never`` with the
structural B/W split), ``interleaved`` through the
interleaved wavefront's tables (``parallel/interleaved.py``).
``--plan`` resolves a planner plan (``core/planner.py``; ``auto`` searches
schedule x chunks over the cost model and overrides ``--schedule`` and
``--chunks``) and prints it; ``--profile DIR`` writes a ``torch.profiler``
Chrome trace of the training into ``DIR/trace.json``; ``--autosave DIR``
checkpoints into ``DIR`` on SIGTERM after the step in flight and exits.
``--device cpu`` runs every kernel's plain version.

``--world N``, the counterpart of the JAX entry point's ``--cpu N`` virtual
mesh, spawns ``N`` ranks (``runtime.distributed.launch``, backend ``gloo``,
each rank on ``--device``: on the card they share it) and trains the same
flow over a ``--stages`` x ``N / --stages`` mesh; rank 0 prints, and saves
the one-device trainer's checkpoint with ``--save``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint", choices=["never", "except_last", "always"],
                   help="activation-checkpoint mode (main.py:164-169)")
    p.add_argument("--corpus", default=None,
                   help="text file; default: deterministic synthetic corpus")
    p.add_argument("--steps", type=int, default=8,
                   help="train steps (~8·bptt tokens like main.py:194)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--schedule",
                   choices=["gpipe", "1f1b", "zb-h1", "interleaved",
                            "interleaved-1f1b"],
                   default="gpipe")
    p.add_argument("--interleave", type=int, default=2,
                   help="virtual stages per stage (interleaved-1f1b)")
    p.add_argument("--lr", type=float, default=None,
                   help="override the reference's Adam lr=5.0 (main.py:183), "
                        "which diverges at full scale; try 1e-4")
    p.add_argument("--plan", default=None,
                   help="auto-planner front door: 'auto' searches schedule "
                        "x chunks x interleave under the planner's cost "
                        "model and overrides --schedule/--chunks; a path "
                        "loads a saved plan json")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CI / CPU-sized)")
    p.add_argument("--profile", default=None,
                   help="torch.profiler trace dir (main.py:196-204 "
                        "equivalent)")
    p.add_argument("--save", default=None, help="checkpoint dir to save into")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume")
    p.add_argument("--autosave", default=None,
                   help="checkpoint dir for preemption-aware autosave "
                        "(SIGTERM finishes the step, saves, exits cleanly)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--world", type=int, default=1,
                   help="ranks of a (--stages x N/--stages) mesh, spawned "
                        "here over gloo (the JAX entry point's --cpu N)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.world > 1:
        if args.world % args.stages:
            print(f"--world {args.world} does not divide into --stages "
                  f"{args.stages}", file=sys.stderr)
            return 2
        run_world(list(sys.argv[1:] if argv is None else argv))
        return 0
    train(args)
    return 0


def run_world(argv, timeout: float = 3600.0) -> list:
    """Spawn ``--world`` ranks and run :func:`train` on each: their result
    dicts, in rank order."""
    from pipe_tpu_torch.runtime.distributed import launch

    args = build_argparser().parse_args(argv)
    # CPU ranks share the host's cores; on the card torch's default
    threads = (max(1, (os.cpu_count() or 1) // args.world)
               if args.device == "cpu" else 0)
    return launch(_rank_main, args.world, list(argv), device=args.device,
                  backend="gloo", timeout=timeout, threads=threads)


def _rank_main(argv) -> dict:
    import torch.distributed as dist
    return train(build_argparser().parse_args(argv),
                 rank0=dist.get_rank() == 0)


def train(args, rank0: bool = True) -> dict:
    """The tutorial flow on this process (one rank of a world when
    ``--world`` > 1); prints on ``rank0`` only. Returns the per-step losses,
    the validation loss and the ms per step."""
    import contextlib

    def say(*a):
        if rank0:
            print(*a, flush=True)

    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    from pipe_tpu_torch.obs.meters import profile_trace
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig, plan_line

    train_lines, val_lines, _ = lm_text.load_corpus(args.corpus)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, train_lines))
    train_ids = lm_text.data_process(train_lines, vocab)
    val_ids = lm_text.data_process(val_lines, vocab)

    model_cfg = LMConfig(vocab=max(len(vocab), 2))
    if args.tiny:
        model_cfg = dataclasses.replace(
            model_cfg.tiny(), vocab=max(len(vocab), 2),
            n_layers=2 * args.stages)
    cfg = TrainerConfig(chunks=args.chunks, checkpoint=args.checkpoint,
                        n_stages=args.stages, schedule=args.schedule,
                        interleave=args.interleave, plan=args.plan,
                        n_data=max(args.world // args.stages, 1))
    if args.tiny:
        cfg = dataclasses.replace(cfg, batch_size=8, eval_batch_size=8,
                                  bptt=model_cfg.seq_len, lr=1e-3)
    if args.lr is not None:  # explicit --lr beats the tiny default
        cfg = dataclasses.replace(cfg, lr=args.lr)
    if args.schedule in ("interleaved", "interleaved-1f1b") and args.tiny:
        model_cfg = dataclasses.replace(
            model_cfg, n_layers=args.stages * args.interleave)

    train_data = lm_text.batchify(train_ids, cfg.batch_size)
    val_data = lm_text.batchify(val_ids, cfg.eval_batch_size)

    trainer = Trainer(model_cfg, cfg, device=args.device)
    if args.plan:
        say(plan_line(trainer.cfg))
    if args.autosave:
        trainer.install_autosave(args.autosave)
    state = trainer.init_state()
    if args.resume:
        state = trainer.restore(args.resume, state)
        say(f"resumed from step {state.step}")
    say(f"Total parameters in model: {trainer.num_params(state):,}")
    if trainer.mesh is not None:
        from pipe_tpu_torch.runtime.distributed import process_summary
        say(f"mesh {cfg.n_stages} x {cfg.n_data}: {process_summary()}")

    metrics = {"loss": float("nan"), "sec_per_step": float("nan")}
    losses = []
    profile = args.profile
    if profile and trainer.mesh is not None:
        profile = os.path.join(profile, f"rank{trainer.mesh.rank}")
    with (profile_trace(profile) if profile
          else contextlib.nullcontext()):
        for epoch in range(args.epochs):
            state, metrics = trainer.train_epoch(
                train_data, epoch=epoch, state=state, max_steps=args.steps,
                log_every=max(args.steps // 4, 1),
                log_fn=say)
            losses += metrics["losses"]
            if trainer._autosave_pending():
                break  # preemption: checkpoint written, exit cleanly
    if args.profile:
        say(f"profiler trace written to {args.profile}")

    val_loss = None
    if val_data.shape[0] > cfg.bptt:
        val_loss = trainer.evaluate(val_data, state, max_steps=4)
        say(f"val loss {val_loss:.3f}")
    if args.save:
        trainer.save(args.save, state)
        say(f"checkpoint saved to {args.save} @ step {state.step}")
    say(f"final train loss {metrics['loss']:.3f} "
        f"({metrics['sec_per_step']*1000:.1f} ms/step)")
    return {"losses": losses, "val_loss": val_loss,
            "sec_per_step": metrics["sec_per_step"]}


if __name__ == "__main__":
    sys.exit(main())
