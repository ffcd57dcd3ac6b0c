"""Tutorial entry point: the reference ``main.py`` flow on a CUDA card.

Counterpart of ``pipe_tpu/apps/lm_tutorial.py``: corpus → tokenizer → vocab →
batchify (``main.py:76-105``) → Transformer LM (emsize 2048, nhid 2048,
nlayers 16, nhead 32, dropout 0.2, ``main.py:115-120``) → ``Pipe`` over
stages with chunks=4 (``main.py:162-171``) → Adam + StepLR + clip, ~8·bptt
tokens (``main.py:182-234``).

Usage (mirrors ``python main.py <checkpoint-mode>``, ``main.py:164-169``):
    python -m pipe_tpu_torch.apps.lm_tutorial <never|except_last|always>
        [--corpus FILE] [--steps N] [--epochs N] [--stages N] [--chunks N]
        [--lr LR] [--tiny] [--save DIR] [--resume DIR] [--device cuda|cpu]

Only the GPipe schedule is ported: ``--schedule`` anything else raises
``NotImplementedError``. The planner (``--plan``), the profiler trace
(``--profile``), autosave and the virtual CPU mesh (``--cpu``) of the JAX
entry point are not ported; ``--device cpu`` runs every kernel's plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--lr", type=float, default=None,
                   help="override the reference's Adam lr=5.0 (main.py:183), "
                        "which diverges at full scale; try 1e-4")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CI / CPU-sized)")
    p.add_argument("--save", default=None, help="checkpoint dir to save into")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig
    from pipe_tpu_torch.train.state import restore_checkpoint

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
                        n_stages=args.stages, schedule=args.schedule)
    if args.tiny:
        cfg = dataclasses.replace(cfg, batch_size=8, eval_batch_size=8,
                                  bptt=model_cfg.seq_len, lr=1e-3)
    if args.lr is not None:  # explicit --lr beats the tiny default
        cfg = dataclasses.replace(cfg, lr=args.lr)

    train_data = lm_text.batchify(train_ids, cfg.batch_size)
    val_data = lm_text.batchify(val_ids, cfg.eval_batch_size)

    trainer = Trainer(model_cfg, cfg, device=args.device)
    state = trainer.init_state()
    if args.resume:
        state = restore_checkpoint(args.resume, state)
        print(f"resumed from step {state.step}")
    print(f"Total parameters in model: {trainer.num_params(state):,}")

    metrics = {"loss": float("nan"), "sec_per_step": float("nan")}
    for epoch in range(args.epochs):
        state, metrics = trainer.train_epoch(
            train_data, epoch=epoch, state=state, max_steps=args.steps,
            log_every=max(args.steps // 4, 1))

    if val_data.shape[0] > cfg.bptt:
        val_loss = trainer.evaluate(val_data, state, max_steps=4)
        print(f"val loss {val_loss:.3f}")
    if args.save:
        trainer.save(args.save, state)
        print(f"checkpoint saved to {args.save} @ step {state.step}")
    print(f"final train loss {metrics['loss']:.3f} "
          f"({metrics['sec_per_step']*1000:.1f} ms/step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
