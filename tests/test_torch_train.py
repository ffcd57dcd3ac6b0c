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


_JAX_TRAJECTORIES = {}


def _jax_trajectory(source, steps, n_layers=2, **kw):
    """The JAX ``Trainer``'s initial params and per-step losses, once per
    configuration for the module."""
    key = (steps, n_layers, tuple(sorted(kw.items())))
    if key not in _JAX_TRAJECTORIES:
        attn_impl = kw.pop("attn_impl", "xla")
        jmodel = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=n_layers,
                                     attn_impl=attn_impl)
        jtrainer = jloop.Trainer(jmodel, jloop.TrainerConfig(
            batch_size=8, eval_batch_size=8, bptt=jmodel.seq_len, chunks=2,
            n_stages=2, n_data=1, lr=1e-2, **kw))
        jstate = jtrainer.init_state()
        params = jax.tree_util.tree_map(np.asarray, jstate.params)
        _, want = _per_step_losses(jtrainer, source, jstate, steps=steps)
        _JAX_TRAJECTORIES[key] = (params, want)
    return _JAX_TRAJECTORIES[key]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
def test_trainer_trajectory_matches_pipe_tpu(corpus, checkpoint, attn_impl):
    """Eight steps from the JAX Trainer's initial weights: the per-step
    losses agree within TOL_TRAJECTORY relative. ``flash``: the Pallas
    kernels in interpret mode against the port's autograd Function over the
    kernels' plain versions (dropout 0). JAX's trajectory is computed once
    per ``attn_impl``, under ``never``, and every port mode is held to it:
    JAX's checkpoint modes give the same step (tests/test_spmd.py's
    gradient transparency)."""
    source, _ = corpus
    model, cfg = _configs(checkpoint=checkpoint)
    model = dataclasses.replace(model, attn_impl=attn_impl)
    params, want = _jax_trajectory(source, 8, attn_impl=attn_impl,
                                   checkpoint="never")

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
    ("n_data", 2), ("elastic", object())])
def test_unported_trainer_fields_raise(field, value):
    """Elastic training is not ported (ROADMAP A.8); ``n_data`` > 1 needs a
    world of ranks (tests/test_torch_mesh_train.py) and says so."""
    assert getattr(tloop.TrainerConfig(), field) == \
        getattr(jloop.TrainerConfig(), field)
    model, cfg = _configs()
    error, match = ((ValueError, "world") if field == "n_data"
                    else (NotImplementedError, "ROADMAP"))
    with pytest.raises(error, match=match):
        tloop.Trainer(model, dataclasses.replace(cfg, **{field: value}),
                      device="cpu")


@pytest.mark.parametrize("field", ["tb_dir", "telemetry_dir",
                                   "profile_every", "prefetch_depth",
                                   "resilience", "plan", "schedule",
                                   "mu_dtype", "zero"])
def test_ported_trainer_fields_build(field, tmp_path):
    """The fields the slices ported build a trainer (their behaviour is held
    to pipe_tpu's in tests/test_torch_{obs,native,planner,resilience,
    mesh_train}.py)."""
    from pipe_tpu_torch.resilience import ResilienceConfig

    assert getattr(tloop.TrainerConfig(), field) == \
        getattr(jloop.TrainerConfig(), field)
    value = {"tb_dir": str(tmp_path / "tb"),
             "telemetry_dir": str(tmp_path / "t"), "profile_every": 2,
             "prefetch_depth": 2, "resilience": ResilienceConfig(),
             "plan": "auto", "schedule": "interleaved",
             "mu_dtype": "bfloat16", "zero": True}[field]
    model, cfg = _configs()
    if field == "schedule":         # two blocks: one virtual stage each
        cfg = dataclasses.replace(cfg, interleave=1)
    trainer = tloop.Trainer(model, dataclasses.replace(cfg, **{field: value}),
                            device="cpu")
    assert trainer.cfg.plan is not None or field != "plan"


def test_trainer_config_defaults_match_pipe_tpu():
    t = dataclasses.asdict(tloop.TrainerConfig())
    j = dataclasses.asdict(jloop.TrainerConfig())
    assert t == j


def test_generate_and_loss_block_wait_for_later_slices(corpus):
    """``Trainer.generate`` runs since the generation slice (its parity with
    pipe_tpu is in test_torch_generate.py), and the generator's phase
    timing since the serving slice ported the telemetry registry
    (test_torch_telemetry.py); the streaming loss trains since the schedule
    slice: ``loss_block`` puts the fused head and loss on the last stage of
    the table executor, and its trajectory is the dense one's."""
    from pipe_tpu_torch.inference import GenerationConfig, Generator

    trainer, _, _ = tiny_trainer()
    out = trainer.generate(trainer.init_state(), [[1, 2]], max_new_tokens=4)
    assert out.shape == (1, 4) and out.dtype == torch.int64
    timed = Generator(tlm.PipelinedLM.from_sequential(
        trainer.model_cfg, tl.Sequential(list(trainer.pipe))),
        GenerationConfig(max_new_tokens=4, temperature=0.0),
        phase_timing=True)
    assert torch.equal(timed.generate([[1, 2]]), out)

    source, _ = corpus
    model, cfg = _configs()
    dense = tloop.Trainer(model, cfg, device="cpu")
    streamed = tloop.Trainer(dataclasses.replace(model, loss_block=32), cfg,
                             device="cpu")
    assert dense.scheduled is None and streamed.scheduled is not None
    _, want = _per_step_losses(dense, source, dense.init_state(), steps=4)
    _, got = _per_step_losses(streamed, source, streamed.init_state(),
                              steps=4)
    np.testing.assert_allclose(got, want, rtol=TOL_TRAJECTORY, atol=0)
    assert got[-1] < got[0]


@pytest.mark.parametrize("schedule,checkpoint", [("1f1b", "except_last"),
                                                 ("1f1b", "always"),
                                                 ("zb-h1", "never")])
def test_table_trainer_tracks_pipe_tpus_1f1b_trainer(corpus, schedule,
                                                     checkpoint):
    """Four steps of the port's ``Trainer`` through the table executor, from
    the JAX ``Trainer``'s initial weights, against JAX's
    ``Trainer(schedule="1f1b")`` (its zb-h1 Trainer asks for the structural
    split, whose tests are red, ROADMAP C.4; the port's zb-h1 under
    ``never`` is the stored-graph split, C.7): losses within
    TOL_TRAJECTORY relative."""
    source, _ = corpus
    params, want = _jax_trajectory(source, 4, checkpoint="except_last",
                                   schedule="1f1b")

    trainer, _, _ = tiny_trainer(schedule=schedule, checkpoint=checkpoint)
    state = trainer.init_state()
    convert.load_pipelined_lm_params(trainer.pipe, params)
    assert trainer.scheduled.schedule.name == schedule
    _, got = _per_step_losses(trainer, source, state, steps=4)
    np.testing.assert_allclose(got, want, rtol=TOL_TRAJECTORY, atol=0)
    assert got[-1] < got[0]


def test_interleaved_table_trainer_tracks_the_1f1b_trainer(corpus):
    """``Trainer(schedule="interleaved-1f1b", interleave=2)`` cuts 4 layers
    into 2 x 2 virtual stages and walks the interleaved table: four steps
    from one set of weights track the port's 1f1b ``Trainer`` (the same
    step in another order; ``test_table_trainer_tracks_pipe_tpus_1f1b_trainer``
    holds that one to JAX's) within TOL_TRAJECTORY."""
    source, _ = corpus
    results = {}
    for schedule in ("1f1b", "interleaved-1f1b"):
        model, cfg = _configs(schedule=schedule, interleave=2,
                              checkpoint="except_last")
        trainer = tloop.Trainer(dataclasses.replace(model, n_layers=4), cfg,
                                device="cpu")
        state = trainer.init_state(seed=3)
        _, results[schedule] = _per_step_losses(trainer, source, state,
                                                steps=4)
    assert trainer.scheduled.n_virtual == 4
    assert trainer.scheduled.schedule.name == "interleaved-1f1b"
    assert trainer.analytic_bubble() < tloop.bubble_fraction(2, 2)
    np.testing.assert_allclose(results["interleaved-1f1b"], results["1f1b"],
                               rtol=TOL_TRAJECTORY, atol=0)
    assert results["1f1b"][-1] < results["1f1b"][0]


def test_lm_tutorial_trains_interleaved_1f1b(capsys):
    assert lm_tutorial.main(["except_last", "--tiny", "--steps", "2",
                             "--device", "cpu", "--schedule",
                             "interleaved-1f1b", "--interleave", "2"]) == 0
    assert "final train loss" in capsys.readouterr().out


def test_zb_trainer_under_recompute_warns_with_the_crossover_row():
    with pytest.warns(UserWarning, match="breakeven sigma"):
        tiny_trainer(schedule="zb-h1", checkpoint="except_last")


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
    ["never", "--tiny", "--device", "cpu", "--schedule", "interleaved",
     "--interleave", "3"],
    ["always", "--tiny", "--device", "cpu", "--schedule", "interleaved"]])
def test_lm_tutorial_refuses_other_schedules(argv, capsys):
    """Every schedule of the JAX entry point trains since the mesh slice
    ported ``interleaved``; what the app refuses is a schedule it does not
    know and a ``--world`` that ``--stages`` does not divide."""
    assert lm_tutorial.main(argv + ["--steps", "1"]) == 0
    assert "final train loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        lm_tutorial.main(argv[:4] + ["--schedule", "pipedream"])
    assert lm_tutorial.main(argv + ["--world", "3"]) == 2


def test_lm_tutorial_trains_and_resumes_through_the_tables(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert lm_tutorial.main(["except_last", "--schedule", "1f1b", "--tiny",
                             "--steps", "3", "--device", "cpu", "--save",
                             ck]) == 0
    out = capsys.readouterr().out
    assert "| epoch 0 | step 3/3 |" in out and "final train loss" in out
    assert lm_tutorial.main(["never", "--schedule", "zb-h1", "--tiny",
                             "--steps", "1", "--device", "cpu", "--resume",
                             ck]) == 0
    assert "resumed from step 3" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--cpu"])
def test_lm_tutorial_refuses_unported_flags(flag):
    with pytest.raises(SystemExit):
        lm_tutorial.main(["never", "--tiny", flag, "x"])


@pytest.mark.parametrize("flag", ["--plan", "--profile", "--autosave"])
def test_lm_tutorial_takes_the_ported_flags(flag, tmp_path, capsys):
    value = "auto" if flag == "--plan" else str(tmp_path / "d")
    assert lm_tutorial.main(["never", "--tiny", "--device", "cpu", "--steps",
                             "1", flag, value]) == 0
    out = capsys.readouterr().out
    assert "final train loss" in out
    if flag == "--plan":
        assert "plan resolved: schedule=" in out
    if flag == "--profile":
        assert (tmp_path / "d" / "trace.json").exists()


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
