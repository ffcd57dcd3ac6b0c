"""pipe_tpu_torch's BERT (models/bert.py, apps/zoo.py bert) against
pipe_tpu's, at ``BertConfig().tiny()``, from converted weights and the same
numpy inputs.

* ``PipelinedBERT`` run as a plain chain against pipe_tpu's: per-row
  masked-mean losses within 1e-5 and every gradient within rtol 1e-4 /
  atol 1e-5 (tests/test_torch_scheduled.py's tolerances); the loss counts
  the masked positions only (a target changed elsewhere changes nothing).
* BASELINE config #4's pairing, the interleaved-1F1B table: the port's
  ``ScheduledPipeline`` with ``InterleavedOneFOneBSchedule(interleave=2)``
  over 2 stages (4 virtual stages) under ``except_last`` against pipe_tpu's
  on a 2-device CPU mesh (tests/test_model_zoo.py's
  ``test_bert_through_interleaved_1f1b``): loss within 1e-5 relative of
  JAX's and of the plain chain, gradients within the same tolerances.
* ``mask_tokens``: tests/test_model_zoo.py's statistics (JAX's bits come
  from its own generator and are not reproduced): ~15% selected, every
  changed position selected, ~80% of the selected ones ``[MASK]``.
* ``apps.zoo bert --tiny --device cpu`` trains through interleaved-1f1b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core import microbatch as jmb
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.core.schedule import InterleavedOneFOneBSchedule as JIl1f1b
from pipe_tpu.models import bert as jbert
from pipe_tpu.parallel.interleaved import (stack_interleaved_params,
                                           unstack_interleaved_params)
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import zoo
from pipe_tpu_torch.core import microbatch as tmb
from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
from pipe_tpu_torch.models import bert as tbert
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

TOL_LOSS = 1e-5
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)
JCFG = jbert.BertConfig().tiny()
TCFG = tbert.BertConfig().tiny()
ROWS = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def case():
    """JAX's model over 4 virtual stages, its numpy params, the port's model
    holding them, and a masked batch (numpy)."""
    jm = jbert.PipelinedBERT(JCFG, n_virtual=4)
    params = _np(jm.init(jax.random.key(0)))
    tm = tbert.PipelinedBERT(TCFG, 4, device="cpu")
    convert.load_pipelined_lm(tm, params)
    tokens = jax.random.randint(jax.random.key(1), (ROWS, JCFG.seq_len), 2,
                                JCFG.vocab, jnp.int32)
    masked, weights = jbert.mask_tokens(jax.random.key(2), tokens, JCFG)
    batch = _np({"tokens": masked, "targets": tokens,
                 "mlm_weights": weights})
    return jm, params, tm, batch


def _jax_rows(jm, params, batch):
    sp, prep, postp = params
    h = jm.pre_fn(prep, {"tokens": batch["tokens"]}, JCtx())
    for blocks in sp:
        h = jm.stage_fn(blocks, h, JCtx())
    return jm.loss_post_fn(postp, h, batch, JCtx())


def _port_rows(tm, batch):
    h = tm.pre_fn(batch)
    for s in range(tm.n_stages):
        h = tm.stage_fn(s, h)
    return tm.loss_post_fn(h, batch)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _check_grads(tm, grads, want):
    assert sorted(grads) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(grads[name].numpy(), arr, **TOL_GRAD,
                                   err_msg=name)


def test_pipelined_bert_loss_and_grads_match_pipe_tpu(case):
    jm, params, tm, batch = case
    want_rows = np.asarray(_jax_rows(jm, params, jax.tree_util.tree_map(
        jnp.asarray, batch)))
    loss_fn = lambda p: jnp.mean(_jax_rows(jm, p, batch))     # noqa: E731
    gs, gpre, gpost = _np(jax.grad(loss_fn)(params))
    want = convert.pipelined_lm_arrays(tm, (gs, gpre, gpost))
    tm.zero_grad(set_to_none=True)
    rows = _port_rows(tm, _torch(batch))
    np.testing.assert_allclose(rows.detach().numpy(), want_rows, rtol=1e-5,
                               atol=1e-5)
    rows.mean().backward()
    _check_grads(tm, {n: p.grad for n, p in tm.named_parameters()}, want)
    # only the masked positions count
    with torch.no_grad():
        moved = _torch(batch)
        unmasked = moved["mlm_weights"] == 0
        moved["targets"] = torch.where(unmasked, (moved["targets"] + 1)
                                       % TCFG.vocab, moved["targets"])
        assert torch.equal(_port_rows(tm, moved), rows.detach())
        moved["targets"] = torch.where(unmasked, moved["targets"],
                                       (moved["targets"] + 1) % TCFG.vocab)
        assert not torch.equal(_port_rows(tm, moved), rows.detach())


def test_bert_through_interleaved_1f1b_matches_pipe_tpu(case):
    jm, params, tm, batch = case
    sp, prep, postp = params
    jx, _ = jmb.stack_scatter(jax.tree_util.tree_map(jnp.asarray, batch), 4)
    w = jnp.ones(jx["tokens"].shape[:2], jnp.float32)
    jpipe = JPipeline(make_mesh(2, 1, devices=jax.devices()[:2]),
                      jm.stage_fn, pre_fn=jm.pre_fn, post_fn=jm.loss_post_fn,
                      checkpoint="except_last", schedule=JIl1f1b(interleave=2))
    loss, (gs, gpre, gpost) = jax.jit(
        lambda a, b, c: jpipe.loss_and_grad(a, b, c, jx, w))(
        stack_interleaved_params(sp, 2), prep, postp)
    want = convert.pipelined_lm_arrays(
        tm, (unstack_interleaved_params(_np(gs), 2), *_np((gpre, gpost))))
    plain = float(jnp.mean(_jax_rows(
        jm, params, jax.tree_util.tree_map(jnp.asarray, batch))))
    assert float(loss) == pytest.approx(plain, rel=TOL_LOSS)
    tm.zero_grad(set_to_none=True)
    pipe = ScheduledPipeline(tm.stage_fn, tm.pre_fn, tm.loss_post_fn,
                             n_stages=2, module=tm, checkpoint="except_last",
                             schedule=InterleavedOneFOneBSchedule(
                                 interleave=2), device="cpu")
    x, rows = tmb.stack_scatter(_torch(batch), 4)
    got, grads = pipe.loss_and_grad(x, tmb.valid_row_mask(x, rows))
    assert got.item() == pytest.approx(float(loss), rel=TOL_LOSS)
    assert got.item() == pytest.approx(plain, rel=TOL_LOSS)
    _check_grads(tm, grads, want)
    assert pipe.last_slots["stash"] > 0


def test_mask_tokens_statistics():
    cfg = TCFG
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(2, cfg.vocab, (64, cfg.seq_len), generator=gen)
    masked, weights = tbert.mask_tokens(gen, tokens, cfg)
    assert masked.dtype == tokens.dtype and weights.dtype == torch.float32
    rate = weights.mean().item()
    assert 0.10 < rate < 0.20                  # ~15% selected
    changed = masked != tokens
    assert bool((weights[changed] == 1.0).all())
    sel = weights == 1.0
    frac_mask = ((masked == cfg.mask_token_id) & sel).sum() / sel.sum()
    assert 0.6 < frac_mask.item() < 0.95      # ~80% of them [MASK]
    # one generator state, one corruption
    gen.manual_seed(1)
    first = tbert.mask_tokens(gen, tokens, cfg)
    gen.manual_seed(1)
    assert all(torch.equal(a, b) for a, b in
               zip(first, tbert.mask_tokens(gen, tokens, cfg)))


def test_zoo_bert_tiny_trains_interleaved(capsys):
    assert zoo.main(["bert", "--tiny", "--device", "cpu", "--steps", "2",
                     "--stages", "2", "--interleave", "2", "--chunks", "2",
                     "--batch", "4", "--schedule", "interleaved-1f1b"]) == 0
    out = capsys.readouterr().out
    assert "4 virtual stages" in out
    losses = [float(l.split("loss ")[1]) for l in out.splitlines()
              if l.startswith("| step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # 4 layers do not factor into 3 x 2 virtual stages: the zoo adjusts
    assert zoo.main(["bert", "--tiny", "--device", "cpu", "--steps", "1",
                     "--stages", "3", "--schedule", "interleaved-1f1b",
                     "--chunks", "2", "--batch", "4"]) == 0
    assert "note: n_layers 4 -> 6" in capsys.readouterr().out
