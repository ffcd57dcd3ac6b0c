"""pipe_tpu_torch's GPT-2 (models/gpt2.py, apps/zoo.py) against pipe_tpu's,
at ``GPT2Config().tiny()``, from converted weights and the same numpy tokens.

* ``build_sequential(embed_skip=True)`` through the emulator ``Pipe`` at
  balance [2, 2, 2, 2] (embed + stash | 2 blocks | 2 blocks | join + head,
  BASELINE config #3's composition) against pipe_tpu's emulator and mesh
  ``Pipe``: logits within 2e-5; the port's table walk
  (``HeteroScheduledPipeline.forward``) gives the same logits.
* ``PipelinedGPT2`` against the plain chain and pipe_tpu's ``loss_post_fn``.
* One 1f1b step of the port's ``ScheduledPipeline`` over ``PipelinedGPT2``
  against pipe_tpu's at dropout 0: loss within 1e-5 relative, gradients
  within rtol 1e-4 / atol 1e-5.
* The embed-skip ``Pipe`` at dropout 0.1 through the gpipe and 1f1b tables
  with the skip on a lane: one step equals the emulator's (the same masks;
  loss within 1e-5 relative, gradients within 1e-4 x max(1, max|g|)), and
  the attention kernels' launches follow ``stage_passes`` x the blocks of
  each stage.
* ``apps.zoo gpt2 --tiny --device cpu`` trains, and so do ``bert``, ``vit``
  and ``--schedule interleaved-1f1b``, which exited 2 naming their ROADMAP
  items until they landed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
from pipe_tpu.core import microbatch as jmb
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.models import gpt2 as jgpt2
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import zoo
from pipe_tpu_torch.core import microbatch as tmb
from pipe_tpu_torch.models import common as tcommon
from pipe_tpu_torch.models import gpt2 as tgpt2
from pipe_tpu_torch.ops import flash_attention as tfa
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

TOL_LOGITS = dict(rtol=2e-5, atol=2e-5)
# The table walk against the emulator, the same masks: only the order in
# which micro-batches' gradients add up differs (chip_smoke.py's gates).
TOL_TWIN_LOSS = 1e-5
TOL_TWIN_GRAD = 1e-4        # of max(1, max|g|) per parameter
BALANCE = [2, 2, 2, 2]
JCFG = jgpt2.GPT2Config().tiny()
TCFG = tgpt2.GPT2Config().tiny()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(rows=4, seed=1):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab, (rows, JCFG.seq_len)).astype(np.int32)


def stage_mesh(n):
    return make_mesh(n, 1, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def jax_embed_skip():
    """pipe_tpu's embed-skip GPT-2: per-stage params and the logits of its
    emulator and mesh ``Pipe``."""
    seq = jgpt2.build_sequential(JCFG, embed_skip=True)
    emu = pipe_tpu.Pipe(seq, chunks=2, checkpoint="never", balance=BALANCE)
    mesh = pipe_tpu.Pipe(seq, chunks=2, checkpoint="never",
                         mesh=stage_mesh(4), balance=BALANCE)
    params = mesh.init(jax.random.key(0),
                       jnp.zeros((2, JCFG.seq_len), jnp.int32))
    tokens = jnp.asarray(_tokens())
    return (_np(params), np.asarray(emu(params, tokens)),
            np.asarray(mesh(params, tokens)))


def _tpipe(cfg=TCFG, **kw):
    seq = tgpt2.build_sequential(cfg, embed_skip=True, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    kw.setdefault("chunks", 2)
    return pipe_tpu_torch.Pipe(seq, balance=BALANCE, device="cpu", **kw)


def test_embed_skip_pipe_matches_pipe_tpu(jax_embed_skip):
    params, emu_logits, mesh_logits = jax_embed_skip
    np.testing.assert_allclose(mesh_logits, emu_logits, **TOL_LOGITS)
    pipe = _tpipe(checkpoint="never")
    convert.load_stage_params(pipe, params)
    assert [type(l).__name__ for l in pipe.partitions[0]] == [
        "GPT2Embed", "_StashEmbed"]
    assert pipe.skip_layout.requires_copy(0, 3)
    tokens = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        got = pipe(tokens)
        table = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, 2,
                                        "never", "1f1b", device="cpu"
                                        ).forward(tokens)
    np.testing.assert_allclose(got.numpy(), emu_logits, **TOL_LOGITS)
    np.testing.assert_allclose(table.numpy(), emu_logits, **TOL_LOGITS)


def test_pipelined_gpt2_matches_plain_chain_and_pipe_tpu():
    jm = jgpt2.PipelinedGPT2(JCFG, n_stages=4)
    sp, prep, postp = jm.init(jax.random.key(0))
    tokens = _tokens()
    targets = np.roll(tokens, -1, axis=-1)
    h = jm.pre_fn(prep, {"tokens": jnp.asarray(tokens)}, JCtx())
    for blocks in sp:
        h = jm.stage_fn(blocks, h, JCtx())
    want = np.asarray(jm.loss_post_fn(postp, h,
                                      {"targets": jnp.asarray(targets)},
                                      JCtx()))
    tm = tgpt2.PipelinedGPT2(TCFG, 4, device="cpu")
    convert.load_pipelined_lm(tm, _np((sp, prep, postp)))
    x = {"tokens": torch.from_numpy(tokens).long(),
         "targets": torch.from_numpy(targets).long()}
    with torch.no_grad():
        th = tm.pre_fn(x)
        for s in range(4):
            th = tm.stage_fn(s, th)
        got = tm.loss_post_fn(th, x).numpy()
        plain = tcommon.per_row_ce(tm.post_fn(th), x["targets"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    assert tm.max_position() == TCFG.seq_len
    with torch.no_grad():
        np.testing.assert_allclose(
            tm.embed_at(x["tokens"][:, 3:5], 3).numpy(),
            np.asarray(jm.embed_at(prep, jnp.asarray(tokens[:, 3:5]), 3)),
            rtol=1e-6, atol=1e-6)


def test_one_1f1b_step_matches_pipe_tpu():
    m, n = 4, 2
    jm = jgpt2.PipelinedGPT2(JCFG, n_stages=n)
    sp, prep, postp = jm.init(jax.random.key(0))
    tokens = _tokens(rows=8)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=-1)}
    x, _ = jmb.stack_scatter(jax.tree_util.tree_map(jnp.asarray, batch), m)
    w = jnp.ones(x["tokens"].shape[:2], jnp.float32)
    jpipe = JPipeline(stage_mesh(n), jm.stage_fn, pre_fn=jm.pre_fn,
                      post_fn=jm.loss_post_fn, checkpoint="except_last",
                      schedule="1f1b")
    loss, (gs, gpre, gpost) = jax.jit(jpipe.loss_and_grad)(
        stack_stage_params(sp), prep, postp, x, w, key=jax.random.key(2))
    tm = tgpt2.PipelinedGPT2(TCFG, n, device="cpu")
    convert.load_pipelined_lm(tm, _np((sp, prep, postp)))
    want = convert.pipelined_lm_arrays(tm, _np((gs, gpre, gpost)))
    pipe = ScheduledPipeline(tm.stage_fn, tm.pre_fn, tm.loss_post_fn,
                             n_stages=n, module=tm, checkpoint="except_last",
                             schedule="1f1b", device="cpu")
    tx, rows = tmb.stack_scatter(
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, m)
    got_loss, grads = pipe.loss_and_grad(tx, tmb.valid_row_mask(tx, rows))
    assert got_loss.item() == pytest.approx(float(loss), rel=1e-5)
    assert sorted(grads) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(grads[name].numpy(), arr, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _lm_loss(logits, targets):
    return tcommon.per_row_ce(logits, targets)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_embed_skip_tables_equal_emulator_under_dropout(monkeypatch,
                                                        schedule):
    """Dropout 0.1, except_last: the table walk with the embedding skip on
    a lane gives the emulator's loss and gradients (one seed, the same
    masks), and each attention layer calls the kernels' wrappers
    ``stage_passes`` times per step."""
    cfg = dataclasses.replace(TCFG, dropout=0.1)
    tokens = torch.from_numpy(_tokens(rows=8)).long()
    targets = torch.roll(tokens, -1, -1)
    # route attention as on the card, so the wrappers (their plain versions
    # on the CPU) are the path taken, and count their calls
    monkeypatch.setattr(tl, "_flash_route", lambda *a, **k: True)
    calls = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"), 0)
    for name in calls:
        def counted(*a, _f=getattr(tfa, name), _k=name, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    results = []
    for table in (False, True):
        pipe = _tpipe(cfg, chunks=4, checkpoint="except_last")
        calls.update(dict.fromkeys(calls, 0))
        if table:
            ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout,
                                         4, "except_last", schedule,
                                         device="cpu")
            assert ex.memory_plan()["skip_lanes"] == 1
            loss, _ = ex.loss_and_grad(tokens, targets=targets,
                                       loss_fn=_lm_loss, seed=3)
            passes = ex.stage_passes()
            per_stage = {k: v // 4 for k, v in passes.items()}
            assert calls == {
                "flash_attention_fwd": cfg.n_layers * per_stage["forward"],
                "flash_attention_bwd_dq": cfg.n_layers * per_stage["backward"],
                "flash_attention_bwd_dkv":
                    cfg.n_layers * per_stage["backward"]}
        else:
            loss = _lm_loss(pipe(tokens, train=True, seed=3), targets).mean()
            loss.backward()
        # 4 micro-batches and 3 recomputes a block, 4 backwards
        assert calls == {"flash_attention_fwd": cfg.n_layers * 7,
                         "flash_attention_bwd_dq": cfg.n_layers * 4,
                         "flash_attention_bwd_dkv": cfg.n_layers * 4}
        results.append((loss.item(),
                        [p.grad.clone() for p in pipe.parameters()]))
    (l_e, g_e), (l_t, g_t) = results
    assert l_t == pytest.approx(l_e, rel=TOL_TWIN_LOSS)
    for a, b in zip(g_t, g_e):
        assert (a - b).abs().max().item() <= \
            TOL_TWIN_GRAD * max(1.0, b.abs().max().item())


def test_zoo_gpt2_tiny_trains_on_cpu(capsys):
    assert zoo.main(["gpt2", "--tiny", "--device", "cpu", "--steps", "2",
                     "--stages", "2", "--chunks", "2", "--batch", "4"]) == 0
    out = capsys.readouterr().out
    losses = [float(l.split("loss ")[1]) for l in out.splitlines()
              if l.startswith("| step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "final loss" in out and "ms/step" in out


@pytest.mark.parametrize("argv,item", [
    (["bert"], "A.10"), (["vit"], "A.10"),
    (["gpt2", "--schedule", "interleaved-1f1b"], "A.8")])
def test_zoo_refuses_what_is_not_ported(capsys, argv, item):
    """The families and the schedule that waited for ``item`` (A.10's BERT
    and ViT, the interleaved-1F1B table once filed under A.8) have landed:
    each runs now, and nothing names a ROADMAP item."""
    assert zoo.main(argv + ["--tiny", "--device", "cpu", "--steps", "1",
                            "--batch", "4", "--chunks", "2"]) == 0
    out = capsys.readouterr()
    assert "ROADMAP.md" not in out.err and "final loss" in out.out
