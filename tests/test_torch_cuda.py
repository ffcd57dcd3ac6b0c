"""pipe_tpu_torch on a CUDA card: the kernels (flash forward, dQ, dK/dV, with
and without dropout) against their plain versions, the Pipe slice and a
training step through them, a table-executor step (1f1b, zb-h1) against the
emulator's, the GPT-2 skip lane through the tables against the emulator,
deferred BatchNorm, a ``dots_saveable`` step against the policy-free one,
the kernels at BERT-large's shape, GPT-2 served against its ``Generator``,
KV-cached generation (which runs no kernel) against the Pipe forward, and
the training telemetry's readers of the card (memory peaks, the H100's peak
FLOP/s, a profiled emulator step's per-stage timeline from the device
trace). Skipped without a card.

This file imports only torch and pipe_tpu_torch, so it runs on a machine
without JAX; there, skip the repo's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

import pipe_tpu_torch as pt
from pipe_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

TOL = 1e-4   # fp32; the kernel sums in another order than the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bh,s,d,causal", [
    (64, 128, 64, True), (3, 24, 8, True), (8, 256, 128, False),
    (2, 200, 64, True), (2, 96, 96, False)])
def test_flash_kernel_matches_plain_version(cuda, bh, s, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = [torch.randn((bh, s, d), generator=gen, device=cuda)
               for _ in range(3)]
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal, 0.125)
    assert (o - o_ref).abs().max().item() <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                                x, x, causal=True, scale=1.0)
    with pytest.raises(TypeError):
        y = x.double()
        tfa.flash_attention_fwd(y, y, y, causal=True, scale=1.0)
    z = torch.zeros(1, 8, 136, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_fwd(z, z, z, causal=True, scale=1.0)


def test_flash_pipe_refuses_dropout(cuda):
    """The tiny pipe under dropout 0.2 on the card: the forward kernel runs
    it (no refusal any more), and a seed gives the same output twice and
    another seed another output."""
    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash",
                              dropout=0.2)
    pipe = pt.Pipe(pt.build_sequential(cfg, device=cuda), chunks=2,
                   device=cuda)
    tokens = torch.zeros(2, cfg.seq_len, dtype=torch.long, device=cuda)
    with torch.no_grad():
        before = tfa.flash_attention_fwd.launches
        a = pipe(tokens, train=True, seed=0)
        assert tfa.flash_attention_fwd.launches - before == cfg.n_layers * 2
        assert torch.equal(a, pipe(tokens, train=True, seed=0))
        assert not torch.equal(a, pipe(tokens, train=True, seed=1))
    assert torch.isfinite(a).all()


SHAPES = [(256, 128, 64, True), (3, 24, 8, True), (2, 8, 16, False),
          (4, 40, 48, True), (2, 200, 64, True), (2, 96, 96, False),
          (5, 136, 32, False),
          # ragged for the 64-row tiles and the k8 steps of the tensor-core
          # kernels
          (3, 72, 8, True), (2, 136, 48, False), (2, 200, 96, True),
          (1, 128, 128, True)]


def _inputs(cuda, bh, s, d, n=4):
    gen = torch.Generator(device=cuda).manual_seed(bh * 1000 + s + d)
    return [torch.randn((bh, s, d), generator=gen, device=cuda)
            for _ in range(n)]


def _close(got, want):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("bh,s,d,causal", SHAPES)
def test_backward_kernels_match_plain_versions(cuda, bh, s, d, causal, rate):
    q, k, v, do = _inputs(cuda, bh, s, d)
    seed, scale = 99, 1.0 / d ** 0.5
    keep = tfa.dropout_keep(seed, rate, bh, s, device=cuda) if rate else None
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     seed=seed, rate=rate)
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal, scale, keep)
    _close(o, o_ref)
    _close(lse, lse_ref)
    delta = tfa.attention_delta(o_ref, do)
    kw = dict(causal=causal, scale=scale, seed=seed, rate=rate)
    counts = [tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches]
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    assert [tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches] == [c + 1 for c in counts]
    ref = dict(causal=causal, scale=scale, keep=keep)
    _close(dq, tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse_ref, delta,
                                              **ref))
    for got, want in zip((dk, dv), tfa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse_ref, delta, **ref)):
        _close(got, want)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_at_the_gpt2_shape(cuda, rate):
    """GPT-2-small's training shape: (b*h, s, d) = (2 x 12, 1024, 64),
    causal, its attention dropout 0.1: 8 key tiles per causal row block."""
    test_backward_kernels_match_plain_versions(cuda, 24, 1024, 64, True,
                                               rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_at_the_bert_shape(cuda, rate):
    """BERT-large's training shape: (b*h, s, d) = (1 x 16, 512, 64),
    non-causal, its attention dropout 0.1: 8 row blocks of 64, all 8 key
    tiles each."""
    test_backward_kernels_match_plain_versions(cuda, 16, 512, 64, False,
                                               rate)


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved-1f1b"])
def test_dots_saveable_step_on_the_card(cuda, schedule):
    """One except_last step of the tiny LM at dropout 0.1 through the table
    executor, with and without ``remat_policy="dots_saveable"``: the same
    loss and gradients (the same masks), the same kernel launches (a policy
    cannot save a kernel's output), fewer matrix products."""
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.remat import count_dots
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash",
                              dropout=0.1)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    x, rows = mb.stack_scatter({"tokens": tokens,
                                "targets": tokens.roll(-1, -1)}, 4)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    runs = []
    for policy in (None, "dots_saveable"):
        model = pt.PipelinedLM(cfg, 4, device=cuda,
                               generator=torch.Generator(device=cuda)
                               .manual_seed(5))
        table = ScheduledPipeline(model.stage_fn, model.pre_fn,
                                  model.loss_post_fn, n_stages=2,
                                  module=model, checkpoint="except_last",
                                  schedule=schedule, device=cuda,
                                  remat_policy=policy)
        before = [c.launches for c in counters]
        with count_dots() as dots:
            loss, grads = table.loss_and_grad(x, mb.valid_row_mask(x, rows),
                                              seed=3)
            torch.cuda.synchronize()
        moved = [c.launches - b for c, b in zip(counters, before)]
        passes = table.stage_passes(4)
        lps = model.layers_per_stage
        assert moved == [lps * passes["forward"], lps * passes["backward"],
                         lps * passes["backward"]]
        runs.append((loss.item(), grads, moved, dots.count))
    (l0, g0, m0, d0), (l1, g1, m1, d1) = runs
    assert m0 == m1 and d1 < d0
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for name, g in g0.items():
        assert (g1[name] - g).abs().max().item() <= \
            TOL * max(1.0, g.abs().max().item()), name


def test_gpt2_engine_equals_generator_on_the_card(cuda):
    """GPT-2 tiny served by the slot engine (decode captured in a CUDA
    graph) gives the batch-1 ``Generator``'s greedy tokens bit for bit."""
    from pipe_tpu_torch.inference import GenerationConfig, Generator
    from pipe_tpu_torch.models.gpt2 import GPT2Config, PipelinedGPT2
    from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                      SingleDeviceSlotBackend)

    model = PipelinedGPT2(GPT2Config().tiny(), 2, device=cuda)
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = [[5, 9, 2], [7, 1, 8, 3, 4], [11, 6, 2, 9]]
    eng = ServeEngine(SingleDeviceSlotBackend(
        model, num_slots=2, max_len=8 + 6, gen=gen,
        buckets=BucketSpec.of(4, 8), resident=False))
    resps = eng.serve(prompts)
    ref = Generator(model, gen)
    for p, r in zip(prompts, resps):
        assert r.status == "ok"
        assert r.tokens == ref.generate([p])[0].tolist()


def test_flash_attention_gradients_match_plain_autograd(cuda):
    """``flash_attention``'s autograd gradient on the card (the forward, dQ and
    dK/dV kernels, dropout 0.2) against torch autograd through the plain
    forward fed the same Philox keep mask."""
    b, s, h, d = 4, 128, 4, 64
    seed, rate, scale = 2024, 0.2, d ** -0.5
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, g = [torch.randn((b, s, h, d), generator=gen, device=cuda)
                  for _ in range(4)]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = [c.launches for c in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)]
    out = tfa.flash_attention(*leaves, causal=True, scale=scale,
                              dropout_rate=rate, dropout_seed=seed)
    got = torch.autograd.grad(out, leaves, g)
    assert [c.launches for c in (tfa.flash_attention_fwd,
                                 tfa.flash_attention_bwd_dq,
                                 tfa.flash_attention_bwd_dkv)] == [
        n + 1 for n in counts]

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, s, d)

    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    keep = tfa.dropout_keep(seed, rate, b * h, s, device=cuda)
    o3, _ = tfa.flash_attention_ref(*(to3(x) for x in plain), True, scale,
                                    keep)
    o_plain = o3.reshape(b, h, s, d).transpose(1, 2)
    _close(out, o_plain)
    want = torch.autograd.grad(o_plain, plain, g)
    for a, w in zip(got, want):
        _close(a, w)


def test_mask_bits_equal_across_kernels_for_one_seed(cuda):
    """Each kernel regenerates the same Philox mask: fed the plain mask of the
    seed, every plain version agrees with its kernel (a different mask would
    move each result by far more than TOL), and each kernel run again gives
    the same bits."""
    bh, s, d = 16, 128, 64
    q, k, v, do = _inputs(cuda, bh, s, d)
    seed, rate, scale = (1 << 40) + 3, 0.2, 0.125
    keep = tfa.dropout_keep(seed, rate, bh, s, device=cuda)
    o_ref, lse = tfa.flash_attention_ref(q, k, v, True, scale, keep)
    delta = tfa.attention_delta(o_ref, do)
    kw = dict(causal=True, scale=scale, seed=seed, rate=rate)
    runs = [(tfa.flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                     seed=seed, rate=rate)[0],
             tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
             *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    ref = dict(causal=True, scale=scale, keep=keep)
    wants = (o_ref,
             tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **ref),
             *tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, **ref))
    for got, want in zip(runs[0], wants):
        _close(got, want)


def test_tiny_trainer_step_launches_the_kernels(cuda):
    """One training step of the tiny LM under except_last: per step the
    forward kernel runs n_layers x (chunks + chunks - 1) times, dQ and dK/dV
    n_layers x chunks times each."""
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig

    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash",
                              dropout=0.2)
    tcfg = TrainerConfig(batch_size=8, bptt=cfg.seq_len, chunks=4,
                         n_stages=2, lr=1e-2)
    trainer = Trainer(cfg, tcfg, device=cuda)
    ids = torch.randint(0, cfg.vocab, (4096,),
                        generator=torch.Generator().manual_seed(0)).numpy()
    source = lm_text.batchify(ids, tcfg.batch_size)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    _, info = trainer.train_epoch(source, max_steps=1, log_every=0)
    moved = [c.launches - b for c, b in zip(counters, before)]
    n, m = cfg.n_layers, tcfg.chunks
    assert moved == [n * (2 * m - 1), n * m, n * m]
    assert info["steps"] == 1 and info["loss"] == info["loss"]


@pytest.mark.parametrize("schedule,checkpoint", [("1f1b", "except_last"),
                                                 ("zb-h1", "never")])
def test_table_executor_step_matches_the_emulator(cuda, schedule, checkpoint):
    """One step of the tiny LM through the table executor on the card,
    against the emulator ``Pipe`` path's ``lm_loss`` backward from the same
    weights at dropout 0, with the kernel launches its tables imply
    (``stage_passes`` x layers per stage)."""
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.train.loop import lm_loss

    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash")
    seq = pt.build_sequential(
        cfg, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(5))
    pipe = pt.Pipe(seq, chunks=4, n_stages=2, device=cuda)
    model = pt.PipelinedLM.from_sequential(cfg, seq, 2)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    targets = tokens.roll(-1, -1)
    want = lm_loss(pipe, tokens, targets, train=True, seed=0)
    want.backward()
    ref = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    table = ScheduledPipeline(model.stage_fn, model.pre_fn,
                              model.loss_post_fn, n_stages=2, module=model,
                              checkpoint=checkpoint, schedule=schedule,
                              device=cuda)
    x, rows = mb.stack_scatter({"tokens": tokens, "targets": targets}, 4)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    loss, grads = table.loss_and_grad(x, mb.valid_row_mask(x, rows))
    moved = [c.launches - b for c, b in zip(counters, before)]
    passes = table.stage_passes(4)
    lps = model.layers_per_stage
    assert moved == [lps * passes["forward"], lps * passes["backward"],
                     lps * passes["backward"]]
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for name, g in ref.items():
        assert (grads[name] - g).abs().max().item() <= \
            TOL * max(1.0, g.abs().max().item()), name


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_gpt2_skip_lane_step_matches_the_emulator(cuda, schedule):
    """The tiny embed-skip GPT-2 on the card at dropout 0.1: one step of the
    table walk with the skip on a lane gives the emulator ``Pipe``'s loss
    and gradients (the same kernels, the same masks), with the launches
    its tables imply; deferred BN commits on the card too."""
    from pipe_tpu_torch.models import gpt2
    from pipe_tpu_torch.models.common import per_row_ce
    from pipe_tpu_torch.parallel.hetero_scheduled import \
        HeteroScheduledPipeline

    cfg = dataclasses.replace(gpt2.GPT2Config().tiny(), dropout=0.1,
                              attn_impl="flash")
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    targets = tokens.roll(-1, -1)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    results = []
    for table in (False, True):
        seq = gpt2.build_sequential(
            cfg, embed_skip=True, device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(5))
        pipe = pt.Pipe(seq, chunks=4, balance=[2, 2, 2, 2], device=cuda)
        before = [c.launches for c in counters]
        if table:
            ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout,
                                         4, "except_last", schedule,
                                         device=cuda)
            loss, _ = ex.loss_and_grad(tokens, targets=targets,
                                       loss_fn=per_row_ce, seed=3)
        else:
            loss = per_row_ce(pipe(tokens, train=True, seed=3),
                              targets).mean()
            loss.backward()
        moved = [c.launches - b for c, b in zip(counters, before)]
        # except_last, 4 micro-batches: 4 forwards and 3 recomputes a block
        assert moved == [cfg.n_layers * 7, cfg.n_layers * 4,
                         cfg.n_layers * 4]
        results.append((loss.item(), [p.grad for p in pipe.parameters()]))
    (l_e, g_e), (l_t, g_t) = results
    assert abs(l_t - l_e) <= 1e-5 * abs(l_e)
    for a, b in zip(g_t, g_e):
        assert (a - b).abs().max().item() <= TOL * max(1.0,
                                                       b.abs().max().item())


def test_deferred_batch_norm_commits_on_the_card(cuda):
    from pipe_tpu_torch.extras.norm import BatchNorm

    gen = torch.Generator(device=cuda).manual_seed(0)
    seq = pt.Sequential([pt.Linear(16, 16, device=cuda, generator=gen),
                         BatchNorm(16, device=cuda)])
    pipe = pt.Pipe(seq, chunks=4, n_stages=2, deferred_batch_norm=True,
                   device=cuda)
    x = torch.randn(32, 16, device=cuda, generator=gen)
    with torch.no_grad():
        pipe(x, train=True)
        h = pipe[0](x)
    n = h.shape[0]
    torch.testing.assert_close(pipe[1].mean, 0.1 * h.mean(0),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        pipe[1].var, 0.9 + 0.1 * h.var(0, unbiased=False) * n / (n - 1),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved", "zb-h1"])
def test_pipe_takes_every_schedule_on_the_card(cuda, schedule):
    """``Pipe(schedule=...)`` on the card: a wavefront schedule's eval
    forward through the kernel equals GPipe's bit for bit (the same
    cycles); a table-only one raises from ``cycles``."""
    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash")
    seq = pt.build_sequential(cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(2))
    gpipe = pt.Pipe(seq, chunks=4, n_stages=2, device=cuda)
    other = pt.Pipe(seq, chunks=4, n_stages=2, schedule=schedule,
                    device=cuda)
    with torch.inference_mode():
        want = gpipe(tokens)
        if schedule == "zb-h1":
            with pytest.raises(NotImplementedError, match="op_tables"):
                other(tokens)
            return
        before = tfa.flash_attention_fwd.launches
        got = other(tokens)
        assert tfa.flash_attention_fwd.launches - before == cfg.n_layers * 4
    assert torch.equal(got, want)


def test_tiny_pipe_slice_goes_through_the_kernel(cuda):
    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash")
    seq = pt.build_sequential(cfg, device=cuda)
    pipe = pt.Pipe(seq, chunks=4, n_stages=2, device=cuda)
    twin_seq = pt.build_sequential(dataclasses.replace(cfg, attn_impl="xla"),
                                   device=cuda)
    twin_seq.load_state_dict(seq.state_dict())
    twin = pt.Pipe(twin_seq, chunks=4, n_stages=2, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.inference_mode():
        before = tfa.flash_attention_fwd.launches
        got = pipe(tokens)
        assert tfa.flash_attention_fwd.launches - before == cfg.n_layers * 4
        want = twin(tokens)
    assert (got - want).abs().max().item() <= TOL


def _tiny_lm(cuda, impl="flash"):
    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl=impl)
    seq = pt.build_sequential(
        cfg, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(3))
    return cfg, seq, pt.PipelinedLM.from_sequential(cfg, seq)


def test_cached_logits_match_the_pipe_forward_on_the_card(cuda):
    """Prefill plus one-token steps through the KV caches on the card: the
    logits of a fixed sequence against the Pipe eval forward through the
    flash kernel; the cached path launches no kernel."""
    from pipe_tpu_torch.inference import generate as tgen

    cfg, seq, model = _tiny_lm(cuda)
    tokens = torch.randint(0, cfg.vocab, (4, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    p = cfg.seq_len // 2
    with torch.inference_mode():
        want = pt.Pipe(seq, chunks=2, device=cuda)(tokens)
        before = tfa.flash_attention_fwd.launches
        caches = [b.attn.make_cache(4, cfg.seq_len) for b in model.blocks]
        h = model.embed_at(tokens[:, :p], 0)
        for l, b in enumerate(model.blocks):
            h, caches[l] = b.decode(h, caches[l], 0)
        got = [tgen.head_logits(model, h)]
        for t in range(p, cfg.seq_len):
            h = model.embed_at(tokens[:, t:t + 1], t)
            for l, b in enumerate(model.blocks):
                h, caches[l] = b.decode(h, caches[l], t)
            got.append(tgen.head_logits(model, h))
        assert tfa.flash_attention_fwd.launches == before
    assert (torch.cat(got, 1) - want).abs().max().item() <= TOL


def test_generation_modes_on_the_card(cuda):
    """Greedy against the argmax of the forward on its own output; the same
    seed gives the same samples; beam scores equal the sequence log-probs;
    int8 and EOS runs give tokens of the right shape and lengths."""
    from pipe_tpu_torch.inference import (GenerationConfig, Generator,
                                          quantize_params)

    cfg, seq, model = _tiny_lm(cuda)
    prompt = torch.randint(0, cfg.vocab, (3, 5), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(2))
    greedy = Generator(model, GenerationConfig(max_new_tokens=8,
                                               temperature=0.0))
    out = greedy.generate(prompt)
    with torch.inference_mode():
        logits = pt.Pipe(seq, device=cuda)(torch.cat([prompt, out], 1))
    top2 = torch.topk(logits[:, 4:-1], 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    assert torch.equal(logits[:, 4:-1].argmax(-1)[clear], out[clear])

    sampled = Generator(model, GenerationConfig(max_new_tokens=8,
                                                temperature=0.8, top_k=10))
    a = sampled.generate(prompt, seed=5)
    assert torch.equal(a, sampled.generate(prompt, seed=5))
    assert not torch.equal(a, sampled.generate(prompt, seed=6))

    toks, scores = Generator(model, GenerationConfig(
        max_new_tokens=6, num_beams=3)).generate_with_scores(prompt)
    with torch.inference_mode():
        logp = torch.log_softmax(pt.Pipe(seq, device=cuda)(
            torch.cat([prompt, toks], 1))[:, 4:-1].float(), -1)
    ext = torch.gather(logp, -1, toks[..., None])[..., 0].sum(-1)
    assert torch.allclose(scores, ext, rtol=1e-4, atol=1e-4)

    q = Generator(quantize_params(model), GenerationConfig(max_new_tokens=8,
                                                           temperature=0.0))
    assert q.generate(prompt).shape == (3, 8)
    eos = int(out[0, 2])
    _, lengths = Generator(model, GenerationConfig(
        max_new_tokens=8, temperature=0.0,
        eos_token_id=eos)).generate_with_lengths(prompt)
    assert int(lengths[0]) <= 3


def _serve_model(cuda):
    cfg = dataclasses.replace(pt.LMConfig().tiny(), n_layers=2)
    seq = pt.build_sequential(
        cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    return pt.PipelinedLM.from_sequential(cfg, seq)


def _serve_prompts(n, lo=3, hi=14):
    gen = torch.Generator().manual_seed(5)
    lens = torch.randint(lo, hi, (n,), generator=gen).tolist()
    return [torch.randint(1, 101, (k,), generator=gen).tolist() for k in lens]


def _staggered_serve(backend, prompts, seeds):
    from pipe_tpu_torch.serve import ServeEngine

    eng = ServeEngine(backend)
    ids = [eng.submit(p, seed=s).id for p, s in zip(prompts[:2], seeds)]
    for p, s in zip(prompts[2:], seeds[2:]):
        eng.tick()
        ids.append(eng.submit(p, seed=s).id)
    eng.run_until_idle()
    return [eng.response(i).tokens for i in ids]


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_serve_engine_captures_once_and_equals_eager(cuda, temperature):
    """A tiny engine on the card over staggered mixed-length traffic: the
    decode step is captured once (``decode_traces`` + 1) and replayed every
    tick, launches no flash kernel, and gives the tokens of the same engine
    run eagerly on the card (same shapes, same kernels)."""
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.serve import BucketSpec, SingleDeviceSlotBackend

    model = _serve_model(cuda)
    gen = GenerationConfig(max_new_tokens=12, temperature=temperature,
                           top_k=20)
    prompts = _serve_prompts(9)
    seeds = list(range(9))
    kw = dict(num_slots=3, max_len=28, gen=gen, buckets=BucketSpec.of(8, 16),
              resident=False)
    reg = get_registry()
    traces = reg.counter("serve.engine.decode_traces").value
    launches = tfa.flash_attention_fwd.launches
    graph = SingleDeviceSlotBackend(model, **kw)
    got = _staggered_serve(graph, prompts, seeds)
    assert reg.counter("serve.engine.decode_traces").value - traces == 1
    assert tfa.flash_attention_fwd.launches == launches
    assert graph.program_stats()["decode_graph"]
    assert graph.program_stats()["prefill_programs"] == 2
    eager = SingleDeviceSlotBackend(model, cuda_graph=False, **kw)
    assert _staggered_serve(eager, prompts, seeds) == got
    assert not eager.program_stats()["decode_graph"]
    assert all(len(t) == 12 for t in got)


def test_serve_graph_replay_reads_the_new_slots_cache(cuda):
    """One slot: request A runs to its end, then B is admitted into the same
    slot, and the replayed graph decodes B from B's cache: B's tokens are
    those of B served alone by a fresh engine."""
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                      SingleDeviceSlotBackend)

    model = _serve_model(cuda)
    gen = GenerationConfig(max_new_tokens=10, temperature=0.0)
    a, b = _serve_prompts(2, lo=6, hi=12)
    kw = dict(num_slots=1, max_len=26, gen=gen, buckets=BucketSpec.of(16),
              resident=False)
    backend = SingleDeviceSlotBackend(model, **kw)
    both = ServeEngine(backend).serve([a, b])
    alone = ServeEngine(SingleDeviceSlotBackend(model, **kw)).serve([b])
    assert both[1].tokens == alone[0].tokens
    assert both[0].tokens != both[1].tokens


_LAYOUTS = {"slab": dict(buckets=None), "paged": dict(kv_block_size=4,
                                                      prefill_chunk=4)}


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_serve_programs_captured_once_equal_eager(cuda, layout, resident,
                                                  temperature):
    """Each layout's programs on the card over staggered traffic: the
    decode (or resident) program captured once, the paged chunk program
    once for every prompt length, and the tokens of the same engine run
    eagerly on the card (same shapes, same kernels), bit for bit."""
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.serve import BucketSpec, SingleDeviceSlotBackend

    model = _serve_model(cuda)
    gen = GenerationConfig(max_new_tokens=12, temperature=temperature,
                           top_k=20)
    prompts = _serve_prompts(9)
    seeds = list(range(9))
    lay = dict(_LAYOUTS[layout])
    if layout == "slab":
        lay["buckets"] = BucketSpec.of(8, 16)
    kw = dict(num_slots=3, max_len=28, gen=gen, resident=resident,
              resident_chunks=3, **lay)
    reg = get_registry()
    names = ("serve.engine.resident_traces" if resident
             else "serve.engine.decode_traces",
             "serve.engine.prefill_chunk_traces")
    before = [reg.counter(n).value for n in names]
    graph = SingleDeviceSlotBackend(model, **kw)
    got = _staggered_serve(graph, prompts, seeds)
    after = [reg.counter(n).value - b for n, b in zip(names, before)]
    assert after == [1, 1 if layout == "paged" else 0]
    eager = SingleDeviceSlotBackend(model, cuda_graph=False, **kw)
    assert _staggered_serve(eager, prompts, seeds) == got
    assert all(len(t) == 12 for t in got)
    if layout == "paged":
        assert graph.pool.stats()["blocks_in_use"] == 0


def test_resident_auto_on_the_card_equals_the_tick_path(cuda):
    """``resident="auto"`` picks the resident loop on the card, and its
    tokens equal the single-chunk tick path's, paged, with an EOS."""
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.serve import SingleDeviceSlotBackend

    model = _serve_model(cuda)
    prompts = _serve_prompts(6)
    free = _staggered_serve(SingleDeviceSlotBackend(
        model, num_slots=2, max_len=28, resident=False,
        gen=GenerationConfig(max_new_tokens=12, temperature=0.0),
        **_LAYOUTS["paged"]), prompts, [0] * 6)
    gen = GenerationConfig(max_new_tokens=12, temperature=0.0,
                           eos_token_id=free[0][4])
    kw = dict(num_slots=2, max_len=28, gen=gen, **_LAYOUTS["paged"])
    auto = SingleDeviceSlotBackend(model, **kw)
    assert auto.resident
    got = _staggered_serve(auto, prompts, [0] * 6)
    want = _staggered_serve(SingleDeviceSlotBackend(
        model, resident=False, **kw), prompts, [0] * 6)
    assert got == want
    assert got[0][-1] == free[0][4] and len(got[0]) <= 5


_SPEC_CASES = ([("ngram", k, False) for k in (2, 3, 4)]
               + [("truncated", 4, False), ("tree", 4, False),
                  ("ngram", 4, True)])


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("draft,K,adaptive", _SPEC_CASES,
                         ids=[f"{d}-K{k}{'-adaptive' if a else ''}"
                              for d, k, a in _SPEC_CASES])
def test_spec_rungs_captured_once_equal_eager(cuda, layout, draft, K,
                                              adaptive):
    """The speculative lane on the card, each rung (K 2, 3, 4; the
    truncated and tree drafts at 4; the adaptive ladder): every rung the
    traffic picks is captured once, a second drive captures nothing, and
    the tokens equal the same engine run eagerly on the card, bit for
    bit."""
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.serve import SingleDeviceSlotBackend

    base = _serve_model(cuda)
    model = pt.PipelinedLM.from_sequential(
        base.cfg, [base.embed, base.posenc, *base.blocks, base.head], 2)
    gen = GenerationConfig(max_new_tokens=12, temperature=0.9, top_k=20)
    prompts = _serve_prompts(7)
    prompts[1] = [5, 6, 7] * 4
    seeds = list(range(7))
    kw = dict(num_slots=3, max_len=32, gen=gen, resident=True,
              resident_chunks=3, **_LAYOUTS[layout])
    spec = dict(spec_tokens=K, spec_adaptive=adaptive)
    if draft != "ngram":
        spec.update(draft=draft, spec_branches=2 if draft == "tree" else None)
    reg = get_registry()
    name = "serve.engine.resident_traces"
    t0 = reg.counter(name).value
    graph = SingleDeviceSlotBackend(model, **kw, **spec)
    got = _staggered_serve(graph, prompts, seeds)
    rungs = graph.program_stats()["spec_rungs_ready"]
    assert reg.counter(name).value - t0 == rungs >= 1
    assert graph.program_stats()["resident_graph"]
    assert _staggered_serve(graph, prompts, seeds) == got
    assert reg.counter(name).value - t0 == rungs
    eager = SingleDeviceSlotBackend(model, cuda_graph=False, **kw, **spec)
    assert _staggered_serve(eager, prompts, seeds) == got
    assert all(len(t) == 12 for t in got)
    if layout == "paged":
        assert graph.pool.stats()["blocks_in_use"] == 0


def test_device_memory_peaks_read_torch_cuda(cuda):
    from pipe_tpu_torch.obs.telemetry import device_memory_peaks

    torch.cuda.reset_peak_memory_stats()
    x = torch.empty(1 << 24, device=cuda)
    got = device_memory_peaks(cuda)[f"cuda:{torch.cuda.current_device()}"]
    assert got == {"bytes_in_use": torch.cuda.memory_allocated(),
                   "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
                   "bytes_limit": torch.cuda.mem_get_info()[1]}
    assert got["peak_bytes_in_use"] >= x.numel() * 4


def test_peak_flops_on_the_h100(cuda):
    from pipe_tpu_torch.obs.telemetry import (card_name_and_power_limit,
                                              peak_flops_per_chip)

    assert "H100" in torch.cuda.get_device_name(0)
    assert peak_flops_per_chip(torch.float32, cuda) == 66.9e12
    assert peak_flops_per_chip(torch.bfloat16, cuda) == 989.4e12
    assert "H100" in card_name_and_power_limit()


def test_profile_trace_of_an_emulator_step_has_a_cuda_timeline(cuda,
                                                                tmp_path):
    from pipe_tpu_torch.obs import meters

    cfg = dataclasses.replace(pt.LMConfig().tiny(), seq_len=128)
    pipe = pt.Pipe(pt.build_sequential(cfg, device=cuda), chunks=4,
                   n_stages=2, device=cuda)
    x = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda)
    pipe(x, train=True, seed=1).sum().backward()        # warm-up
    with meters.profile_trace(str(tmp_path)):
        pipe(x, train=True, seed=1).sum().backward()
    tl = meters.stage_timeline_from_trace(str(tmp_path))
    assert tl["source"] == "cuda"
    assert {j: sorted(s["chunks"]) for j, s in tl["stages"].items()} == \
        {0: [0, 1, 2, 3], 1: [0, 1, 2, 3]}
    busy = meters.stage_busy_from_trace(str(tmp_path))
    lo, hi = tl["span"]
    assert sum(s["busy_sec"] for s in tl["stages"].values()) <= \
        min(busy["_span"], (hi - lo) / 1e9) + 1e-9
