"""What the ranks of the ring tests' gloo worlds run
(tests/test_torch_pipelined.py, tests/test_torch_serve_ring.py).

Each function runs on every rank of a 4-rank world of CPU ranks spawned by
``pipe_tpu_torch.runtime.World`` and returns numpy results for the test
process, which holds them to ``pipe_tpu`` and to the port's one-device
paths. The weights arrive as ``pipe_tpu``'s ``PipelinedLM`` triple in
numpy, stage-stacked (``stack_stage_params``; an int8 ``QuantLeaf`` as a
namespace of ``q`` and ``scale``). This module imports neither JAX nor
``pipe_tpu``: the ranks never load them.
"""


from pipe_tpu_torch import convert
from pipe_tpu_torch.inference import GenerationConfig, quantize_params
from pipe_tpu_torch.inference.pipelined import PipelinedGenerator
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.parallel.mesh import make_mesh
from pipe_tpu_torch.serve import (BucketSpec, RingSlotBackend, ServeEngine,
                                  drive_ring)


def ring_model(params, cfg_kw, mesh, int8=False):
    """The port's LM holding this rank's stage of ``params`` (the rest on
    the meta device)."""
    cfg = tlm.LMConfig(attn_impl="xla", **cfg_kw)
    model = tlm.PipelinedLM(cfg, mesh.n_stages, device="cpu")
    if int8:
        model = quantize_params(model)
    convert.load_ring_stage(model, params, mesh.stage, mesh.n_stages)
    return model


def ring_generate(params, cfg_kw, shape, prompt, gen_kw, seed=0,
                  int8=False):
    """``PipelinedGenerator`` on a ``shape`` mesh: greedy or sampled
    tokens (with lengths), or beam tokens and scores."""
    mesh = make_mesh(*shape)
    model = ring_model(params, cfg_kw, mesh, int8)
    pg = PipelinedGenerator(mesh, model, GenerationConfig(**gen_kw))
    if gen_kw.get("num_beams", 1) > 1:
        toks, scores = pg.generate_with_scores(prompt)
        return dict(tokens=toks.numpy(), scores=scores.numpy())
    toks, lens = pg.generate_with_lengths(prompt, seed=seed)
    return dict(tokens=toks.numpy(), lengths=lens.numpy(),
                stage=mesh.stage)


def ring_refusal(params, cfg_kw, shape, prompt):
    """The batch-divisibility refusal's message, on every rank."""
    mesh = make_mesh(*shape)
    pg = PipelinedGenerator(mesh, ring_model(params, cfg_kw, mesh),
                            GenerationConfig(max_new_tokens=2))
    try:
        pg.generate(prompt)
    except ValueError as e:
        return str(e)
    return None


def trainer_generate(params, cfg_kw, schedule, prompt, max_new):
    """A mesh ``Trainer`` (2 stages x 2 data) holding ``pipe_tpu``'s
    trainer params (stacked as its trainer stacks them) generates."""
    from pipe_tpu_torch.train import Trainer, TrainerConfig

    interleaved = schedule in ("interleaved", "interleaved-1f1b")
    cfg = tlm.LMConfig(attn_impl="xla", **cfg_kw)
    tc = TrainerConfig(batch_size=4, bptt=cfg.seq_len, chunks=4,
                       n_stages=2, n_data=2, schedule=schedule,
                       interleave=2)
    tr = Trainer(cfg, tc, device="cpu")
    convert.load_pipelined_lm_params(
        tr.pipe, params, interleaved_devices=2 if interleaved else None)
    state = tr._capture(0)
    return tr.generate(state, prompt, max_new_tokens=max_new).numpy()


def _staggered(eng, prompts, seeds):
    """tests/test_serve.py's arrivals: one request, a tick, two more, a
    tick, the rest, then ticks until idle."""
    ids = [eng.submit(prompts[0], seed=seeds[0]).id]
    eng.tick()
    ids += [eng.submit(p, seed=s).id for p, s in zip(prompts[1:3],
                                                      seeds[1:3])]
    eng.tick()
    ids += [eng.submit(p, seed=s).id for p, s in zip(prompts[3:],
                                                      seeds[3:])]
    eng.run_until_idle()
    return ids


def ring_serve(params, cfg_kw, shape, prompts, seeds, gen_kw, backend_kw,
               buckets=(4, 8)):
    """The ring engine over ``prompts`` arriving staggered: each
    response's status, reason and tokens, and the driver's counters (None
    on the follower ranks)."""
    mesh = make_mesh(*shape)
    model = ring_model(params, cfg_kw, mesh)
    reg = get_registry()
    names = ("serve.ring.decode_traces", "serve.ring.resident_traces",
             "serve.ring.prefill_traces", "serve.ring.prefill_chunk_traces",
             "serve.engine.spec_rounds", "serve.engine.spec_emitted")
    before = {k: reg.counter(k).value for k in names}
    backend = RingSlotBackend(mesh, model,
                              gen=GenerationConfig(**gen_kw),
                              buckets=(None if buckets is None
                                       else BucketSpec.of(*buckets)),
                              **backend_kw)

    def run(b):
        eng = ServeEngine(b)
        ids = _staggered(eng, prompts, seeds)
        resps = [eng.response(i) for i in ids]
        out = dict(tokens=[list(map(int, r.tokens)) for r in resps],
                   status=[r.status for r in resps],
                   reason=[r.finish_reason for r in resps],
                   counters={k: reg.counter(k).value - before[k]
                             for k in names},
                   stats=b.program_stats(),
                   transport=mesh.stats.as_dict())
        if b.paged:
            out["pool_free"] = b.pool.free_blocks + b.pool.evictable_blocks
            out["pool_total"] = b.pool.allocatable
        return out

    return drive_ring(backend, run)


def ring_refusals(params, cfg_kw, kws):
    """``RingSlotBackend``'s refusal for each keyword set: (type name,
    message), or None when it builds."""
    mesh = make_mesh(2, 2)
    model = ring_model(params, cfg_kw, mesh)
    out = []
    for kw in kws:
        kw = dict(kw)
        gen = GenerationConfig(**kw.pop("gen", {"max_new_tokens": 4}))
        try:
            RingSlotBackend(mesh, model, max_len=16, gen=gen,
                            buckets=BucketSpec.of(4, 8), **kw)
            out.append(None)
        except (ValueError, NotImplementedError, TypeError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def ring_follower_raises(params, cfg_kw):
    """Rank 1 (stage 1 of the first ring) raises instead of following;
    the driver meanwhile waits in the first prefill's ring pass."""
    import torch.distributed as dist

    mesh = make_mesh(2, 2)
    model = ring_model(params, cfg_kw, mesh)
    backend = RingSlotBackend(mesh, model, max_len=16,
                              gen=GenerationConfig(max_new_tokens=4),
                              buckets=BucketSpec.of(4, 8))
    if dist.get_rank() == mesh.rank_of(1, 0):
        raise RuntimeError("stage 1 fails on purpose")
    if backend.is_driver:
        backend.prefill(0, [1, 2, 3], 0)
    else:
        backend.follow()
    return None
