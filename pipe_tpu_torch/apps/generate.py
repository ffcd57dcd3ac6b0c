"""Generation entry point: sample from a (trained or fresh) LM or GPT-2.

Counterpart of the single-device paths of ``pipe_tpu/apps/generate.py``:
restore the weights of a ``Trainer`` checkpoint (``train/state.py``; the
training stage count need not match) or draw fresh ones from ``--seed``,
then sample continuations with the KV-cached ``Generator`` on one device.
``--family gpt2`` samples from ``PipelinedGPT2`` (fresh weights from
``--seed``; the ``Trainer`` checkpoints hold the tutorial LM).
``--prompts-file`` serves every prompt of a file (comma-separated ids, one
prompt a line) through the continuous-batching engine (``serve/``) with
``--slots`` decode slots instead, and prints one row per prompt.

``--stages N`` (N > 1) decodes over a ring of N stage ranks, each holding
only its stage's weights, as ``pipe_tpu`` decodes over a stage mesh: the
app spawns its own world of N ranks (``runtime.distributed.launch``,
backend ``gloo``; on the card they share it) and runs the ring-pipelined
``PipelinedGenerator`` (``inference/pipelined.py``; ``--batch``, default
N, must divide into N ring groups), or with ``--prompts-file`` the ring
backend (``serve/ring.py``) under the engine, whose N slots are the ring's
groups. Rank 0 prints.

Usage:
    python -m pipe_tpu_torch.apps.generate [--resume DIR] [--prompt "ids,..."]
        [--prompts-file F [--slots S]] [--batch N] [--max-new N]
        [--temperature T] [--top-k K] [--beams K] [--eos ID] [--int8]
        [--family lm|gpt2] [--stages N] [--tiny] [--seed S]
        [--device cuda|cpu]

A restored model takes its vocabulary from the checkpoint. A request past
the model's positional table exits 2. Not ported yet, refused with rc 2:
``--context-shards > 1``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

# (flag, is it set away from its default?, the ROADMAP.md item that ports it)
_NOT_PORTED = (
    ("--context-shards > 1", lambda a: a.context_shards > 1,
     "A.10, the context-sharded generator"),
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
    p.add_argument("--batch", type=int, default=None,
                   help="rows (default: --stages, one a ring group)")
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
                   help="model family: the tutorial LM (sinusoid positions, "
                        "post-LN) or GPT-2 (learned positions, pre-LN)")
    p.add_argument("--stages", type=int, default=1,
                   help=">1: decode over a ring of this many stage ranks")
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
    if args.batch is None:
        args.batch = max(args.stages, 1)
    if args.batch < 1:
        raise UsageError(f"--batch must be >= 1, got {args.batch}")
    if args.stages > 1:
        _check_ring(args, model_cfg)
    try:
        gen_cfg = GenerationConfig(max_new_tokens=args.max_new,
                                   temperature=args.temperature,
                                   top_k=args.top_k, num_beams=args.beams,
                                   eos_token_id=args.eos)
    except ValueError as e:
        raise UsageError(str(e))
    return prompts, gen_cfg


def _check_ring(args, model_cfg) -> None:
    """``pipe_tpu``'s checks of ``--stages > 1``, with its messages."""
    n = args.stages
    if not args.prompts_file and args.batch % n:
        raise UsageError(f"--batch {args.batch} must divide into --stages "
                         f"{n} ring groups")
    if args.beams > 1:
        raise UsageError("--beams > 1 is single-device only (the ring "
                         "decoder does not reorder beams)")
    if model_cfg.n_layers % n:
        raise UsageError(f"--stages {n} must divide the model's "
                         f"{model_cfg.n_layers} layers")


def position_limit(args, model_cfg) -> int:
    """The positional table's rows of the ``--family`` model, from its
    config (the ring's parent process builds no model)."""
    if args.family == "gpt2":
        return model_cfg.seq_len
    return max(5000, model_cfg.seq_len)


def _checkpoint_state(resume: str) -> dict:
    """The checkpoint's weights as a ``Sequential`` state, or UsageError."""
    from pipe_tpu_torch.train.state import CheckpointCorrupt, restore_params

    if not os.path.isdir(resume):
        raise UsageError(f"--resume {resume}: no such directory")
    try:
        return sequential_state(restore_params(resume))
    except (FileNotFoundError, CheckpointCorrupt) as e:
        raise UsageError(f"--resume {resume}: {e}")


def family_config(args):
    """The ``--family`` config, ``tiny()`` with ``--tiny``."""
    from pipe_tpu_torch.models import GPT2Config, LMConfig

    cfg = {"lm": LMConfig, "gpt2": GPT2Config}[args.family]()
    return cfg.tiny() if args.tiny else cfg


def model_source(args, model_cfg):
    """``(config, checkpoint state or None)`` for ``--resume``: the config
    takes the checkpoint's vocabulary. UsageError for a checkpoint that
    cannot be read or holds another depth, or for GPT-2 (the ``Trainer``
    checkpoints hold the tutorial LM)."""
    if not args.resume:
        return model_cfg, None
    if args.family != "lm":
        raise UsageError(f"--resume holds a Trainer checkpoint of the "
                         f"tutorial LM; --family {args.family} draws fresh "
                         f"weights from --seed")
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


def build_model(args, model_cfg, state, n_stages: int = 1):
    """The ``PipelinedLM`` (or ``PipelinedGPT2``) of ``n_stages`` stages on
    ``--device``: weights drawn from ``--seed``, then the checkpoint's
    (``state``) loaded over them; int8 block weights with ``--int8``.
    UsageError for a checkpoint tensor of another shape."""
    import torch

    from pipe_tpu_torch.inference import quantize_params
    from pipe_tpu_torch.models.gpt2 import PipelinedGPT2
    from pipe_tpu_torch.models.transformer_lm import (PipelinedLM,
                                                      build_sequential)
    from pipe_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.family == "gpt2":
        model = PipelinedGPT2(model_cfg, n_stages, device=device,
                              generator=gen)
    else:
        seq = build_sequential(model_cfg, device=device, generator=gen)
        if state is not None:
            try:
                seq.load_state_dict(state)
            except RuntimeError as e:    # a shape the config does not have
                raise UsageError(f"--resume {args.resume}: {e}")
        model = PipelinedLM.from_sequential(model_cfg, seq, n_stages)
    return quantize_params(model) if args.int8 else model


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from pipe_tpu_torch.inference import Generator, check_positions

    try:
        for flag, is_set, item in _NOT_PORTED:
            if is_set(args):
                raise UsageError(f"{flag} is not ported to pipe_tpu_torch "
                                  f"yet (ROADMAP.md {item})")
        model_cfg, state = model_source(args, family_config(args))
        prompts, gen_cfg = _check_args(args, model_cfg)
        longest = max(len(p) for p in prompts)
        if args.stages > 1:      # the ranks build the model
            import types
            model = types.SimpleNamespace(
                max_position=lambda: position_limit(args, model_cfg))
        else:
            model = build_model(args, model_cfg, state)
        try:
            check_positions(model, longest, gen_cfg.max_new_tokens)
        except ValueError as e:
            raise UsageError(str(e))
    except UsageError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.stages > 1:
        from pipe_tpu_torch.runtime.distributed import launch
        threads = (max(1, (os.cpu_count() or 1) // args.stages)
                   if args.device == "cpu" else 0)
        rows = launch(_ring_rank, args.stages,
                      list(sys.argv[1:] if argv is None else argv),
                      device=args.device, backend="gloo",
                      threads=threads)[0]
        for row in rows:
            print(",".join(str(int(t)) for t in row))
        return 0

    if args.prompts_file:
        # the serve engine: bucketed prefill + one shared decode step for
        # the whole set (tests/test_torch_serve.py holds it to per-prompt
        # generator calls)
        from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                          SingleDeviceSlotBackend)
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


def _ring_rank(argv) -> list:
    """One rank of ``--stages N``: its stage of the model (the weights
    drawn from ``--seed`` or restored, as on one device, then the rest
    freed), then the ring decoder, or the ring engine with
    ``--prompts-file``. Rank 0 returns the rows; the others an empty
    list."""
    import torch

    from pipe_tpu_torch.inference.pipelined import (PipelinedGenerator,
                                                    localize_stage)
    from pipe_tpu_torch.parallel.mesh import make_mesh

    args = build_argparser().parse_args(argv)
    model_cfg, state = model_source(args, family_config(args))
    prompts, gen_cfg = _check_args(args, model_cfg)
    mesh = make_mesh(args.stages, 1)
    model = localize_stage(build_model(args, model_cfg, state, args.stages),
                           mesh)
    if args.prompts_file:
        from pipe_tpu_torch.serve import (BucketSpec, RingSlotBackend,
                                          ServeEngine, drive_ring)
        longest = max(len(p) for p in prompts)
        buckets = BucketSpec.pow2(min_len=min(8, longest), max_len=longest)
        backend = RingSlotBackend(
            mesh, model, max_len=buckets.max_len + args.max_new,
            gen=gen_cfg, buckets=buckets)
        resps = drive_ring(backend, lambda b: ServeEngine(b).serve(
            prompts, seeds=[args.seed + 1] * len(prompts)))
        return [] if resps is None else [r.tokens for r in resps]
    prompt = torch.tensor(prompts * args.batch, dtype=torch.int64)
    out = PipelinedGenerator(mesh, model, gen_cfg).generate(
        prompt, seed=args.seed + 1)
    return out.tolist() if mesh.stage == 0 else []


if __name__ == "__main__":
    sys.exit(main())
