"""pipe_tpu_torch's training path against pipe_tpu's: the ``Trainer`` loss
trajectory from the same weights, the trainer laws of
tests/test_data_train.py, checkpoints, the ``lm_tutorial`` entry point, and the
pieces under them (``per_row_ce``, the global-norm clip, the PipelinedLM
cut, the weight conversion). Everything runs on the CPU at the tiny size;
the JAX side runs its ``SpmdPipeline`` on the virtual CPU devices that
tests/conftest.py sets up.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pipe_tpu.data import lm_text as jtext
from pipe_tpu.models import common as jcommon
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import Pipe, _build, convert
from pipe_tpu_torch.apps import lm_tutorial
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.models import common as tcommon
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.train import loop as tloop
from pipe_tpu_torch.train import state as tstate

# fp32 through Adam: the two frameworks round differently in the last bits,
# and Adam's normalised step carries that on; measured at most 1.1e-6
# relative over the 8 steps on the CPU, held at 1e-4.
TOL_TRAJECTORY = 1e-4


@pytest.fixture(scope="module")
def corpus():
    lines = lm_text.synthetic_corpus(30_000, 99, seed=3)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, lines))
    ids = lm_text.data_process(lines, vocab)
    return lm_text.batchify(ids, 8), vocab


def _configs(**cfg_kw):
    model = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2,
                                attn_impl="xla")
    cfg = tloop.TrainerConfig(batch_size=8, eval_batch_size=8,
                              bptt=model.seq_len, chunks=2, n_stages=2,
                              n_data=1, lr=1e-2, **cfg_kw)
    return model, cfg


def tiny_trainer(**cfg_kw):
    model, cfg = _configs(**cfg_kw)
    return tloop.Trainer(model, cfg, device="cpu"), model, cfg


def _per_step_losses(trainer, source, state, steps=8):
    losses = []
    for b in range(steps):
        state, info = trainer.train_epoch(source, state=state,
                                          max_steps=b + 1, start_step=b,
                                          log_every=0)
        losses.append(info["loss"])
    return state, losses


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
def test_trainer_trajectory_matches_pipe_tpu(corpus, checkpoint, attn_impl):
    """Eight steps from the JAX Trainer's initial weights: the per-step
    losses agree within TOL_TRAJECTORY relative. ``flash``: the Pallas
    kernels in interpret mode against the port's autograd Function over the
    kernels' plain versions (dropout 0)."""
    source, _ = corpus
    model, cfg = _configs(checkpoint=checkpoint)
    model = dataclasses.replace(model, attn_impl=attn_impl)
    jmodel = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=2,
                                 attn_impl=attn_impl)
    jtrainer = jloop.Trainer(jmodel, jloop.TrainerConfig(
        batch_size=8, eval_batch_size=8, bptt=jmodel.seq_len, chunks=2,
        n_stages=2, n_data=1, lr=1e-2, checkpoint=checkpoint))
    jstate = jtrainer.init_state()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    _, want = _per_step_losses(jtrainer, source, jstate)

    trainer = tloop.Trainer(model, cfg, device="cpu")
    state = trainer.init_state()
    convert.load_pipelined_lm_params(trainer.pipe, params)
    _, got = _per_step_losses(trainer, source, state)
    np.testing.assert_allclose(got, want, rtol=TOL_TRAJECTORY, atol=0)
    assert got[-1] < got[0]


def test_loss_decreases_below_log_vocab(corpus):
    source, vocab = corpus
    trainer, model, _ = tiny_trainer()
    assert model.vocab >= len(vocab)
    state, m = trainer.train_epoch(source, state=None, max_steps=12,
                                   log_every=0)
    assert m["steps"] == 12 and state.step == 12
    assert m["loss"] < np.log(model.vocab)
    assert np.isfinite(trainer.evaluate(source, state, max_steps=2))


def test_steplr_decays_per_epoch(corpus):
    source, _ = corpus
    trainer, _, cfg = tiny_trainer()
    seen = []
    state, _ = trainer.train_epoch(source, epoch=0, state=None, max_steps=1,
                                   log_every=1, log_fn=seen.append)
    trainer.train_epoch(source, epoch=3, state=state, max_steps=1,
                        log_every=1, log_fn=seen.append)
    lr0 = float(seen[0].split("lr ")[1].split(" ")[0])
    lr3 = float(seen[1].split("lr ")[1].split(" ")[0])
    assert lr0 == pytest.approx(cfg.lr, abs=5e-4)
    assert lr3 == pytest.approx(cfg.lr * cfg.lr_gamma ** 3, abs=5e-4)
    assert trainer.optimizer.param_groups[0]["lr"] == cfg.lr * cfg.lr_gamma ** 3
    for field in ("| epoch 3 | step 1/1 |", "| ms/batch ", "| tok/s ",
                  "| loss ", "| ppl ", "| bubble 33.3%"):
        assert field in seen[1]


def test_nondivisible_batch_loss_is_the_real_rows_mean(corpus):
    """Batch 10, chunks 4: Pipe splits 3/3/3/1, and the loss equals the
    unpipelined loss over the 10 rows and the JAX trainer's masked loss over
    its zero-padded batch, from the same weights."""
    source, _ = corpus
    wide = lm_text.batchify(np.concatenate([source.T.ravel()] * 2), 10)
    model = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2)
    jmodel = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=2)
    jcfg = jloop.TrainerConfig(batch_size=10, eval_batch_size=10,
                               bptt=model.seq_len, chunks=4, n_stages=2,
                               n_data=1, lr=1e-2)
    jtrainer = jloop.Trainer(jmodel, jcfg)
    jstate = jtrainer.init_state()
    data, target = lm_text.get_batch(wide, 0, model.seq_len)
    assert data.shape[0] == 10
    x, w = jtrainer._make_x(data, target)
    want = float(jtrainer._eval_fn(jstate.params, x, w))

    trainer = tloop.Trainer(model, tloop.TrainerConfig(
        batch_size=10, bptt=model.seq_len, chunks=4, n_stages=2, lr=1e-2),
        device="cpu")
    convert.load_pipelined_lm_params(
        trainer.pipe, jax.tree_util.tree_map(np.asarray, jstate.params))
    tokens = torch.from_numpy(data).long()
    targets = torch.from_numpy(target).long()
    with torch.no_grad():
        got = tloop.lm_loss(trainer.pipe, tokens, targets, train=False).item()
        plain = tl.Sequential(list(trainer.pipe))(tokens)
        unpipelined = tcommon.per_row_ce(plain, targets).mean().item()
    assert got == pytest.approx(unpipelined, rel=1e-6)
    assert got == pytest.approx(want, rel=1e-5)


def test_checkpoint_roundtrip_and_bitwise_resume(tmp_path, corpus):
    source, _ = corpus
    trainer, _, _ = tiny_trainer()
    state, _ = trainer.train_epoch(source, state=None, max_steps=3,
                                   log_every=0)
    tstate.save_checkpoint(str(tmp_path / "ck"), state, state.step)
    assert tstate.latest_step(str(tmp_path / "ck")) == 3

    # The template is the live state itself: init_state() would load fresh
    # weights into the trainer, and with them into the live state.
    restored = tstate.restore_checkpoint(str(tmp_path / "ck"), state)
    assert restored.step == 3
    for name, t in state.model.items():
        assert torch.equal(t, restored.model[name]), name
    assert tstate.state_manifest(restored) == tstate.state_manifest(state)

    # resumed training continues deterministically from the restored state
    s1, _ = trainer.train_epoch(source, epoch=1, state=state, max_steps=2,
                                log_every=0)
    s1 = {k: v.clone() for k, v in s1.model.items()}   # the live state moves on
    s2, _ = trainer.train_epoch(source, epoch=1, state=restored, max_steps=2,
                                log_every=0)
    for name, t in s1.items():
        assert torch.equal(t, s2.model[name]), name


def test_corrupted_tensor_raises_naming_it(tmp_path, corpus):
    source, _ = corpus
    trainer, _, _ = tiny_trainer()
    state, _ = trainer.train_epoch(source, state=None, max_steps=1,
                                   log_every=0)
    ck = tmp_path / "ck"
    trainer.save(str(ck), state)
    path = ck / "step_1" / "state.pt"
    tree = torch.load(path, weights_only=True)
    name = sorted(tree["model"])[3]
    tree["model"][name].view(-1)[0] += 1.0
    torch.save(tree, path)
    with pytest.raises(tstate.CheckpointCorrupt, match=name.replace(".", r"\.")):
        tstate.restore_checkpoint(str(ck), trainer.init_state())


def test_checkpoints_keep_the_newest_three(tmp_path, corpus):
    trainer, _, _ = tiny_trainer()
    state = trainer.init_state()
    for step in range(1, 6):
        tstate.save_checkpoint(str(tmp_path), state, step)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == \
        ["step_3", "step_4", "step_5"]
    assert tstate.latest_step(str(tmp_path)) == 5
    assert tstate.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("field,value", [
    ("schedule", "1f1b"), ("n_data", 2), ("mu_dtype", "bfloat16"),
    ("tb_dir", "tb"), ("zero", True), ("prefetch_depth", 2),
    ("telemetry_dir", "t"), ("profile_every", 2), ("resilience", object()),
    ("elastic", object()), ("plan", "auto")])
def test_unported_trainer_fields_raise(field, value):
    assert getattr(tloop.TrainerConfig(), field) == \
        getattr(jloop.TrainerConfig(), field)
    model, cfg = _configs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloop.Trainer(model, dataclasses.replace(cfg, **{field: value}),
                      device="cpu")


def test_trainer_config_defaults_match_pipe_tpu():
    t = dataclasses.asdict(tloop.TrainerConfig())
    j = dataclasses.asdict(jloop.TrainerConfig())
    assert t == j


def test_generate_and_loss_block_wait_for_later_slices():
    """``Trainer.generate`` runs since the generation slice (its parity with
    pipe_tpu is in test_torch_generate.py), and the generator's phase
    timing since the serving slice ported the telemetry registry
    (test_torch_telemetry.py); the streaming loss still waits."""
    from pipe_tpu_torch.inference import GenerationConfig, Generator

    trainer, _, _ = tiny_trainer()
    out = trainer.generate(trainer.init_state(), [[1, 2]], max_new_tokens=4)
    assert out.shape == (1, 4) and out.dtype == torch.int64
    timed = Generator(tlm.PipelinedLM.from_sequential(
        trainer.model_cfg, tl.Sequential(list(trainer.pipe))),
        GenerationConfig(max_new_tokens=4, temperature=0.0),
        phase_timing=True)
    assert torch.equal(timed.generate([[1, 2]]), out)
    with pytest.raises(NotImplementedError, match="loss_block"):
        tlm.LMConfig(loss_block=128)


def test_lm_tutorial_trains_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert lm_tutorial.main(["except_last", "--tiny", "--steps", "3",
                             "--device", "cpu", "--save", ck]) == 0
    out = capsys.readouterr().out
    assert "| epoch 0 | step 3/3 |" in out and "final train loss" in out
    assert lm_tutorial.main(["never", "--tiny", "--steps", "1", "--device",
                             "cpu", "--resume", ck]) == 0
    assert "resumed from step 3" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["always", "--tiny", "--device", "cpu", "--schedule", "1f1b"],
    ["always", "--tiny", "--device", "cpu", "--schedule", "interleaved"]])
def test_lm_tutorial_refuses_other_schedules(argv):
    with pytest.raises(NotImplementedError, match="schedule"):
        lm_tutorial.main(argv)


@pytest.mark.parametrize("flag", ["--plan", "--profile", "--autosave",
                                  "--cpu"])
def test_lm_tutorial_refuses_unported_flags(flag):
    with pytest.raises(SystemExit):
        lm_tutorial.main(["never", "--tiny", flag, "x"])


# --- the pieces under the trainer ---------------------------------------------

@pytest.mark.parametrize("shape,weighted", [((3, 5), False), ((3, 5), True),
                                            ((4,), False), ((4,), True),
                                            ((2, 3, 4), True)])
def test_per_row_ce_matches_pipe_tpu(shape, weighted):
    rng = np.random.default_rng(len(shape))
    logits = rng.standard_normal(shape + (7,)).astype(np.float32)
    targets = rng.integers(0, 7, size=shape)
    w = rng.integers(0, 2, size=shape).astype(np.float32) if weighted else None
    want = jcommon.per_row_ce(jnp.asarray(logits), jnp.asarray(targets),
                              None if w is None else jnp.asarray(w))
    got = tcommon.per_row_ce(torch.from_numpy(logits),
                             torch.from_numpy(targets),
                             None if w is None else torch.from_numpy(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    tloop.clip_by_global_norm(got, max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("n_layers,n_stages", [(4, 2), (6, 3), (2, 1),
                                               (5, 2), (4, 3)])
def test_pipelined_lm_balance_matches_pipelined_lm(n_layers, n_stages):
    cfg = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=n_layers)
    try:
        jmodel = jlm.PipelinedLM(cfg, n_stages)
    except ValueError:
        with pytest.raises(ValueError, match="must divide"):
            tlm.pipelined_lm_balance(n_layers, n_stages)
        return
    balance = tlm.pipelined_lm_balance(n_layers, n_stages)
    lps = jmodel.layers_per_stage
    want = ([lps + 2] + [lps] * (n_stages - 2) + [lps + 1] if n_stages > 1
            else [n_layers + 3])
    assert balance == want


def test_load_pipelined_lm_params_takes_both_layouts():
    from pipe_tpu.parallel.spmd import stack_stage_params
    jmodel = jlm.PipelinedLM(jlm.LMConfig().tiny(), 2)
    sp, pre, post = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(3)))
    tcfg = tlm.LMConfig().tiny()
    pipes = []
    for stage_params in (sp, jax.tree_util.tree_map(
            np.asarray, stack_stage_params(sp))):
        pipe = Pipe(tlm.build_sequential(tcfg, device="cpu"),
                          balance=tlm.pipelined_lm_balance(4, 2),
                          device="cpu")
        convert.load_pipelined_lm_params(pipe, (stage_params, pre, post))
        pipes.append(pipe)
    np.testing.assert_array_equal(pipes[0][0].weight.detach().numpy(),
                                  pre["embed"]["table"])
    np.testing.assert_array_equal(pipes[0][-1].proj.weight.detach().numpy(),
                                  post["decoder"]["w"].T)
    np.testing.assert_array_equal(pipes[0][5].ff1.weight.detach().numpy(),
                                  sp[1][1]["ff1"]["w"].T)
    for a, b in zip(pipes[0].parameters(), pipes[1].parameters()):
        assert torch.equal(a, b)


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    """A kernel library is named by its source, the shared headers and the
    flags: an edited ``.cuh`` gives a new path, so no stale build is reused.
    No compiler is needed to name it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.lib_path("k.cu")
    assert first == _build.lib_path("k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.lib_path("k.cu")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = _build.lib_path("k.cu")
    assert len({first, second, third}) == 3
    assert _build.SOURCES == ("flash_attn_fwd.cu", "flash_attn_bwd.cu",
                              "flash_attn_bwd_dkv.cu")
    assert all((_build._PKG / "csrc" / src).exists()
               for src in _build.SOURCES)
