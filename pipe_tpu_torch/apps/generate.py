"""Generation entry point: sample from a (trained or fresh) tutorial LM.

Counterpart of the single-device paths of ``pipe_tpu/apps/generate.py``:
restore the weights of a ``Trainer`` checkpoint (``train/state.py``; the
training stage count need not match) or draw fresh ones from ``--seed``,
then sample continuations with the KV-cached ``Generator`` on one device.
``--prompts-file`` serves every prompt of a file (comma-separated ids, one
prompt a line) through the continuous-batching engine (``serve/``) with
``--slots`` decode slots instead, and prints one row per prompt.

Usage:
    python -m pipe_tpu_torch.apps.generate [--resume DIR] [--prompt "ids,..."]
        [--prompts-file F [--slots S]] [--batch N] [--max-new N]
        [--temperature T] [--top-k K] [--beams K] [--eos ID] [--int8]
        [--tiny] [--seed S] [--device cuda|cpu]

A restored model takes its vocabulary from the checkpoint. Not ported yet,
each refused with rc 2: ``--stages > 1`` (the ring decoder),
``--context-shards > 1`` and ``--family gpt2``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

# (flag, is it set away from its default?, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("--stages > 1", lambda a: a.stages > 1,
     "A.8, the ring-pipelined decoder over a stage mesh"),
    ("--context-shards > 1", lambda a: a.context_shards > 1,
     "A.10, the context-sharded generator"),
    ("--family gpt2", lambda a: a.family != "lm",
     "A.10, the GPT-2 family"),
)

_PIPE_KEY = re.compile(r"^partitions\.(\d+)\.layers\.(\d+)\.(.+)$")


class UsageError(Exception):
    """User-input problem: print the message, exit rc=2."""


def sequential_state(pipe_state: dict) -> dict:
    """A ``Trainer``'s ``Pipe`` state (``partitions.{stage}.layers.{i}.*``,
    cut by ``pipelined_lm_balance``) as the state of the tutorial LM's
    ``Sequential`` (``layers.{n}.*``), whatever the training stage count.
    The stage count and depth are read from the keys: every stage holds
    parameters, and every layer but the positional encoding does."""
    from pipe_tpu_torch.models.transformer_lm import pipelined_lm_balance

    parsed = []
    for key, value in pipe_state.items():
        m = _PIPE_KEY.match(key)
        if m is None:
            raise UsageError(f"checkpoint tensor {key} is not a Pipe layer's")
        parsed.append((int(m.group(1)), int(m.group(2)), m.group(3), value))
    n_stages = 1 + max(s for s, *_ in parsed)
    n_blocks = len({(s, i) for s, i, *_ in parsed}) - 2
    try:
        balance = pipelined_lm_balance(n_blocks, n_stages)
    except ValueError as e:
        raise UsageError(f"checkpoint of {n_stages} stages: {e}")
    offset = [sum(balance[:s]) for s in range(n_stages)]
    return {f"layers.{offset[s] + i}.{rest}": value
            for s, i, rest, value in parsed}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resume", default=None,
                   help="Trainer checkpoint dir (train/state.py layout); "
                        "default: fresh random weights from --seed")
    p.add_argument("--prompt", default="1,2,3,4",
                   help="comma-separated prompt token ids (one sequence; "
                        "repeated to fill the batch)")
    p.add_argument("--prompts-file", default=None,
                   help="serve these prompts (comma-separated ids per "
                        "line) through the slot engine, one row each")
    p.add_argument("--slots", type=int, default=4,
                   help="--prompts-file: decode slots of the serve engine")
    p.add_argument("--eos", type=int, default=None,
                   help="eos token id: a finished row emits pad after it")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--beams", type=int, default=1,
                   help=">1: beam search (deterministic)")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only quantized block weights "
                        "(inference/quant.py)")
    p.add_argument("--family", choices=["lm", "gpt2"], default="lm",
                   help="model family; only lm is ported")
    p.add_argument("--stages", type=int, default=1,
                   help="not ported yet beyond 1 (the ring decoder)")
    p.add_argument("--context-shards", type=int, default=1,
                   help="not ported yet beyond 1")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="weights are drawn from seed, sampling from seed + 1")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _check_args(args, model_cfg):
    """The prompt and generation checks, before any model is built: returns
    the prompts and the generation config, or raises UsageError."""
    from pipe_tpu_torch.inference import GenerationConfig

    if args.prompts_file:
        from pipe_tpu_torch.apps.serve import read_prompts

        prompts = read_prompts(args.prompts_file, model_cfg.vocab)
        if args.beams > 1 or args.context_shards > 1:
            raise UsageError("--prompts-file serves through the slot "
                             "engine: beams and context shards are "
                             "single-shot-generator-only")
        if args.slots < 1:
            raise UsageError(f"--slots must be >= 1, got {args.slots}")
    else:
        try:
            ids = [int(t) for t in args.prompt.split(",") if t.strip()]
        except ValueError:
            raise UsageError(
                "prompt must be comma-separated integer token ids")
        if not ids or any(i < 0 or i >= model_cfg.vocab for i in ids):
            raise UsageError(f"prompt ids must be in [0, {model_cfg.vocab})")
        prompts = [ids]
    if args.eos is not None and (args.eos < 0 or args.eos >= model_cfg.vocab):
        raise UsageError(f"--eos must be in [0, {model_cfg.vocab})")
    if args.eos is not None and args.beams > 1:
        raise UsageError("--eos with beam search is not implemented")
    if args.batch < 1:
        raise UsageError(f"--batch must be >= 1, got {args.batch}")
    try:
        gen_cfg = GenerationConfig(max_new_tokens=args.max_new,
                                   temperature=args.temperature,
                                   top_k=args.top_k, num_beams=args.beams,
                                   eos_token_id=args.eos)
    except ValueError as e:
        raise UsageError(str(e))
    return prompts, gen_cfg


def _checkpoint_state(resume: str) -> dict:
    """The checkpoint's weights as a ``Sequential`` state, or UsageError."""
    from pipe_tpu_torch.train.state import CheckpointCorrupt, restore_params

    if not os.path.isdir(resume):
        raise UsageError(f"--resume {resume}: no such directory")
    try:
        return sequential_state(restore_params(resume))
    except (FileNotFoundError, CheckpointCorrupt) as e:
        raise UsageError(f"--resume {resume}: {e}")


def model_source(args, model_cfg):
    """``(config, checkpoint state or None)`` for ``--resume``: the config
    takes the checkpoint's vocabulary. UsageError for a checkpoint that
    cannot be read or holds another depth."""
    if not args.resume:
        return model_cfg, None
    import dataclasses

    state = _checkpoint_state(args.resume)
    model_cfg = dataclasses.replace(
        model_cfg, vocab=state["layers.0.weight"].shape[0])
    n_blocks = len({k.split(".")[1] for k in state}) - 2
    if n_blocks != model_cfg.n_layers:
        raise UsageError(
            f"checkpoint holds {n_blocks} blocks but the model has "
            f"{model_cfg.n_layers} layers")
    return model_cfg, state


def build_model(args, model_cfg, state):
    """The ``PipelinedLM`` on ``--device``: weights drawn from ``--seed``,
    then the checkpoint's (``state``) loaded over them; int8 block weights
    with ``--int8``. UsageError for a checkpoint tensor of another shape."""
    import torch

    from pipe_tpu_torch.inference import quantize_params
    from pipe_tpu_torch.models.transformer_lm import (PipelinedLM,
                                                      build_sequential)
    from pipe_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    seq = build_sequential(
        model_cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    if state is not None:
        try:
            seq.load_state_dict(state)
        except RuntimeError as e:        # a shape the config does not have
            raise UsageError(f"--resume {args.resume}: {e}")
    model = PipelinedLM.from_sequential(model_cfg, seq)
    return quantize_params(model) if args.int8 else model


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from pipe_tpu_torch.inference import Generator
    from pipe_tpu_torch.models.transformer_lm import LMConfig

    model_cfg = LMConfig().tiny() if args.tiny else LMConfig()
    try:
        for flag, is_set, item in _NOT_PORTED:
            if is_set(args):
                raise UsageError(f"{flag} is not ported to pipe_tpu_torch "
                                  f"yet (ROADMAP.md {item})")
        model_cfg, state = model_source(args, model_cfg)
        prompts, gen_cfg = _check_args(args, model_cfg)
        model = build_model(args, model_cfg, state)
    except UsageError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.prompts_file:
        # the serve engine: bucketed prefill + one shared decode step for
        # the whole set (tests/test_torch_serve.py holds it to per-prompt
        # generator calls)
        from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                          SingleDeviceSlotBackend)
        longest = max(len(p) for p in prompts)
        buckets = BucketSpec.pow2(min_len=min(8, longest), max_len=longest)
        backend = SingleDeviceSlotBackend(
            model, num_slots=args.slots,
            max_len=buckets.max_len + args.max_new, gen=gen_cfg,
            buckets=buckets)
        eng = ServeEngine(backend)
        for resp in eng.serve(prompts, seeds=[args.seed + 1] * len(prompts)):
            print(",".join(str(int(t)) for t in resp.tokens))
        return 0

    prompt = torch.tensor(prompts * args.batch, dtype=torch.int64)
    out = Generator(model, gen_cfg).generate(prompt, seed=args.seed + 1)
    for row in out.tolist():
        print(",".join(str(t) for t in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
