"""pipe_tpu_torch's ViT (models/vit.py, apps/zoo.py vit) against pipe_tpu's,
at ``ViTConfig().tiny()`` (16 x 16 images, patches of 4: 17 tokens), from
converted weights and the same numpy images and labels.

* ``build_sequential`` through the port's ``Pipe`` against pipe_tpu's mesh
  ``Pipe``: logits within 2e-5 (tests/test_model_zoo.py's tolerance).
* ``PipelinedViT`` as a plain chain: per-row losses against integer labels
  within 1e-5, every gradient within rtol 1e-4 / atol 1e-5
  (tests/test_torch_scheduled.py's tolerances).
* Config #5's uneven balance, [1, 3, 2] (embed | 3 blocks | block + head):
  one 1f1b step of the port's ``HeteroScheduledPipeline`` over those
  partitions against pipe_tpu's ``Pipe(mesh=).loss_and_grad`` (loss within
  1e-5 relative, gradients within rtol 1e-4 / atol 1e-5) and against the
  port's emulator step.
* 197 tokens (ViT-L/16 at 224) and the tiny 17 fail ``supports()``, so the
  blocks take plain attention wherever the kernels would run, as pipe_tpu's
  Pallas gate chooses; a step with the wrappers routed as on the card
  launches none of them.
* ``apps.zoo vit --tiny --device cpu`` trains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
import pipe_tpu_torch
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.models import vit as jvit
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import zoo
from pipe_tpu_torch.models import vit as tvit
from pipe_tpu_torch.models.common import per_row_ce
from pipe_tpu_torch.ops import flash_attention as tfa
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline

TOL_LOGITS = dict(rtol=2e-5, atol=2e-5)
TOL_LOSS = 1e-5
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)
JCFG = jvit.ViTConfig().tiny()
TCFG = tvit.ViTConfig().tiny()
BALANCE = [1, 3, 2]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(rows=4):
    rng = np.random.default_rng(1)
    images = rng.standard_normal(
        (rows, JCFG.image_size, JCFG.image_size, JCFG.channels)
    ).astype(np.float32)
    return images, rng.integers(0, JCFG.n_classes, (rows,))


def stage_mesh(n):
    return make_mesh(n, 1, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def uneven():
    """pipe_tpu's ViT under ``Pipe(mesh=stage_mesh(3), balance=[1, 3, 2])``:
    params, the mesh's logits, and one 1f1b ``loss_and_grad`` (loss,
    per-stage grads)."""
    images, labels = _data()
    seq = jvit.build_sequential(JCFG)
    mesh = pipe_tpu.Pipe(seq, chunks=2, checkpoint="except_last",
                         mesh=stage_mesh(3), balance=BALANCE,
                         schedule="1f1b")
    params = mesh.init(jax.random.key(0), jnp.asarray(images[:2]))

    def jloss(out, tgt):
        return -jnp.take_along_axis(jax.nn.log_softmax(out, -1),
                                    tgt[:, None], -1)[:, 0]

    loss, grads = jax.jit(lambda p: mesh.loss_and_grad(
        p, jnp.asarray(images), targets=jnp.asarray(labels),
        loss_fn=jloss))(mesh.shard_params(params))
    return (_np(params), np.asarray(mesh(params, jnp.asarray(images))),
            float(loss), _np(mesh.unshard_grads(grads)))


def _tpipe(**kw):
    seq = tvit.build_sequential(TCFG, device="cpu")
    return pipe_tpu_torch.Pipe(seq, chunks=2, checkpoint="except_last",
                               balance=BALANCE, device="cpu", **kw)


def test_sequential_and_uneven_pipe_match_pipe_tpu(uneven):
    params, mesh_logits, _, _ = uneven
    pipe = _tpipe()
    convert.load_stage_params(pipe, params)
    assert [type(l).__name__ for l in pipe.partitions[0]] == ["PatchEmbed"]
    images, _ = _data()
    with torch.no_grad():
        got = pipe(torch.from_numpy(images))
    assert got.shape == (4, TCFG.n_classes)
    np.testing.assert_allclose(got.numpy(), mesh_logits, **TOL_LOGITS)


def test_uneven_table_step_matches_pipe_tpu_and_the_emulator(uneven):
    params, _, want_loss, want_grads = uneven
    images, labels = _data()
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    results = []
    for table in (True, False):
        pipe = _tpipe()
        convert.load_stage_params(pipe, params)
        if table:
            ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout,
                                         2, "except_last", "1f1b",
                                         device="cpu")
            loss, _ = ex.loss_and_grad(x, targets=y, loss_fn=per_row_ce)
        else:
            loss = per_row_ce(pipe(x, train=True), y).mean()
            loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in pipe.named_parameters()}))
    (l_t, g_t), (l_e, g_e) = results
    assert l_t == pytest.approx(want_loss, rel=TOL_LOSS)
    assert l_e == pytest.approx(want_loss, rel=TOL_LOSS)
    want = convert.stage_arrays(pipe, want_grads)
    assert sorted(g_t) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(g_t[name].numpy(), arr, **TOL_GRAD,
                                   err_msg=name)
        np.testing.assert_allclose(g_e[name].numpy(), arr, **TOL_GRAD,
                                   err_msg=name)


def test_pipelined_vit_loss_and_grads_match_pipe_tpu():
    jm = jvit.PipelinedViT(JCFG, n_stages=2)
    params = _np(jm.init(jax.random.key(3)))
    images, labels = _data(rows=6)
    batch = {"images": images, "labels": labels}

    def jrows(p):
        sp, prep, postp = p
        h = jm.pre_fn(prep, batch, JCtx())
        for blocks in sp:
            h = jm.stage_fn(blocks, h, JCtx())
        return jm.loss_post_fn(postp, h, batch, JCtx())

    want_rows = np.asarray(jrows(params))
    grads = _np(jax.grad(lambda p: jnp.mean(jrows(p)))(params))
    tm = tvit.PipelinedViT(TCFG, 2, device="cpu")
    convert.load_pipelined_lm(tm, params)
    want = convert.pipelined_lm_arrays(tm, grads)
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    h = tm.pre_fn(tb)
    for s in range(2):
        h = tm.stage_fn(s, h)
    rows = tm.loss_post_fn(h, tb)
    assert h.shape == (6, TCFG.n_tokens, TCFG.d_model)
    np.testing.assert_allclose(rows.detach().numpy(), want_rows, rtol=1e-5,
                               atol=1e-5)
    rows.mean().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], **TOL_GRAD,
                                   err_msg=name)


def test_token_counts_take_plain_attention(monkeypatch):
    """197 and 17 tokens fail ``supports()``: ``auto`` picks plain attention
    even on a CUDA device, and a training step routed as on the card calls
    none of the kernels' wrappers."""
    full = tvit.ViTConfig()
    assert full.n_tokens == 197 and TCFG.n_tokens == 17
    for s in (full.n_tokens, TCFG.n_tokens):
        assert not tfa.supports(s)
        assert not tl._flash_route("auto", s, torch.device("cuda"), True)
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    real = tl._flash_route
    monkeypatch.setattr(tl, "_flash_route",
                        lambda impl, s, device, *a: real(
                            impl, s, torch.device("cuda"), *a))
    pipe = _tpipe()
    images, labels = _data()
    loss = per_row_ce(pipe(torch.from_numpy(images), train=True, seed=1),
                      torch.from_numpy(labels)).mean()
    loss.backward()
    assert calls == []


def test_zoo_vit_tiny_trains(capsys):
    assert zoo.main(["vit", "--tiny", "--device", "cpu", "--steps", "2",
                     "--stages", "2", "--chunks", "2", "--batch", "4"]) == 0
    out = capsys.readouterr().out
    losses = [float(l.split("loss ")[1]) for l in out.splitlines()
              if l.startswith("| step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
