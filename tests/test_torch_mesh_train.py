"""The mesh ``Trainer`` over a 4-rank gloo world of CPU ranks, against pipe_tpu's
``Trainer(n_stages=2, n_data=2)`` on the virtual CPU devices.

One world of 4 ranks (2 stages x 2 data) is spawned once for the module
(``tests/torch_mesh_cases.py`` runs on the ranks). From the JAX trainer's
initial weights (carried over by ``convert``, the interleaved placements'
device-major stacking included), the tiny LM (dropout 0, plain attention)
trains 3 steps on the tutorial pipeline's synthetic corpus through gpipe
(``SpmdPipeline``), 1f1b, interleaved (``InterleavedSpmdPipeline``),
interleaved-1f1b and zb-h1 (against JAX's 1f1b), with ZeRO's sharded
moments and with a bfloat16 first
moment: every step's loss within 1e-4 relative of JAX's (the one-device
trainer's tolerance, tests/test_torch_train.py), every rank the same.
Then the checkpoint a mesh trainer saves (rank 0 writes it) resumes a
one-device trainer, whose next step is the mesh trainer's, and
``apps.generate --resume`` reads it; and ``apps.lm_tutorial --world 4``
trains over its own world.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

import torch_mesh_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.data import lm_text as jtext
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.apps import lm_tutorial
from pipe_tpu_torch.obs.events import EventLog
from pipe_tpu_torch.runtime import World
from pipe_tpu_torch.train import loop as tloop
from pipe_tpu_torch.train import state as tstate

TOL_TRAJECTORY = 1e-4
STEPS = 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


@pytest.fixture(scope="module")
def corpus():
    lines = jtext.synthetic_corpus(30_000, 99, seed=3)
    vocab = jtext.Vocab(map(jtext.basic_english_tokenize, lines))
    return jtext.batchify(jtext.data_process(lines, vocab), 8), len(vocab)


_JAX_RUNS = {}


def _jax_run(schedule, checkpoint, source, vocab, **kw):
    """JAX's initial params and per-step losses, once per configuration."""
    key = (schedule, checkpoint, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_trajectory(schedule, checkpoint, source,
                                         vocab, **kw)
    return _JAX_RUNS[key]


def _jax_trajectory(schedule, checkpoint, source, vocab, **kw):
    jmodel = dataclasses.replace(jlm.LMConfig().tiny(), vocab=vocab,
                                 attn_impl="xla")
    jtr = jloop.Trainer(jmodel, jloop.TrainerConfig(
        batch_size=8, bptt=jmodel.seq_len, chunks=4, n_stages=2, n_data=2,
        lr=1e-2, schedule=schedule, checkpoint=checkpoint, **kw))
    state = jtr.init_state()
    params = jax.tree_util.tree_map(np.asarray, state.params)
    losses = []
    for b in range(STEPS):
        state, info = jtr.train_epoch(source, state=state, max_steps=b + 1,
                                      start_step=b, log_every=0)
        losses.append(info["loss"])
    return params, losses


@pytest.mark.parametrize("schedule,checkpoint,kw", [
    ("gpipe", "except_last", {}),
    ("1f1b", "always", {}),
    ("interleaved", "except_last", {}),
    ("interleaved-1f1b", "never", {}),
    ("zb-h1", "never", {}),
    ("1f1b", "except_last", {"zero": True}),
    ("1f1b", "except_last", {"mu_dtype": "bfloat16"})],
    ids=["gpipe", "1f1b", "interleaved", "interleaved-1f1b", "zb-h1",
         "zero", "mu_dtype"])
def test_mesh_trainer_trajectory_matches_pipe_tpu(world, corpus, schedule,
                                                  checkpoint, kw):
    """zb-h1 is held to JAX's 1f1b trainer: JAX's zb-h1 trainer asks for
    the structural split, whose tests are red (ROADMAP C.4); the port's
    zb-h1 trainer under ``never`` runs the port's structural split over the
    mesh, each rank's W on its own column."""
    source, vocab = corpus
    params, want = _jax_run("1f1b" if schedule == "zb-h1" else schedule,
                            checkpoint, source, vocab, **kw)
    res = world.run(cases.trainer_run, schedule, checkpoint, params, STEPS,
                    source, kw.get("zero", False), kw.get("mu_dtype"))
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=TOL_TRAJECTORY,
                                   atol=0)
        assert r["losses"] == res[0]["losses"]
    assert want[-1] < want[0]


def test_mesh_checkpoint_resumes_one_device_and_generates(world, corpus,
                                                          tmp_path, capsys):
    """Rank 0 writes the one-device trainer's files: the whole model and
    Adam state. A one-device trainer restored from them takes the step the
    mesh trainer takes next (held, as the mesh trainer's own third step is,
    to JAX's within the trajectory tolerance); ``apps.generate --resume``
    samples from them."""
    source, vocab = corpus
    params, want = _jax_run("1f1b", "always", source, vocab)
    ck, tel = str(tmp_path / "ck"), str(tmp_path / "tel")
    world.run(cases.trainer_run, "1f1b", "always", params, 2, source,
              False, None, 2, ck, tel)
    for r in range(4):                  # one StepReport a step on each rank
        reports = [e for e in EventLog.read(os.path.join(
            tel, f"rank{r}", "events.jsonl")) if e["kind"] == "step_report"]
        assert len(reports) == 2 and reports[0]["n_devices"] == 1
    nxt = want[2]                 # the mesh trainer's third step, as JAX's
    cfg = cases.tiny_lm(vocab=vocab)
    tr = tloop.Trainer(cfg, tloop.TrainerConfig(
        batch_size=8, bptt=cfg.seq_len, chunks=4, n_stages=2, lr=1e-2,
        schedule="1f1b", checkpoint="always"), device="cpu")
    state = tstate.restore_checkpoint(ck, tr.init_state())
    assert state.step == 2
    _, info = tr.train_epoch(source, state=state, max_steps=3, start_step=2,
                             log_every=0)
    assert info["loss"] == pytest.approx(nxt, rel=TOL_TRAJECTORY)
    assert gen_app.main(["--tiny", "--device", "cpu", "--resume", ck,
                         "--max-new", "3"]) == 0


def test_lm_tutorial_world_4_trains(capsys):
    """``--world 4``: the app spawns its own world (2 stages x 2 data,
    interleaved here) and rank 0 prints the log; every rank reports the
    same losses."""
    res = lm_tutorial.run_world(
        ["except_last", "--tiny", "--device", "cpu", "--world", "4",
         "--schedule", "interleaved", "--steps", "2"], timeout=120)
    assert len(res) == 4 and all(r["losses"] == res[0]["losses"]
                                 for r in res)
    assert len(res[0]["losses"]) == 2 and np.isfinite(res[0]["losses"]).all()
    assert lm_tutorial.main(["never", "--tiny", "--device", "cpu",
                             "--world", "3"]) == 2

