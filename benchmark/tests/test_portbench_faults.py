"""Each fault the correctness check must catch, planted in the timed path
under a run driven end to end on the CPU (the look for a card skipped):
``correct`` comes out false. A sound run of each cell comes out true."""

import time

import numpy as np
import pytest
import torch

from conftest import SEED


def _run(plan):
    return plan.runner().run(plan, SEED, 0.3, False, "cpu",
                             time.perf_counter())


@pytest.mark.parametrize("name", ["lm-train-c4", "gpt2s-train-c16",
                                  "gpt2s-serve-chat"])
def test_a_sound_run_is_correct(tiny, name):
    out = _run(tiny(name))
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted > 0


@pytest.mark.parametrize("name", ["lm-train-c4", "gpt2s-train-c16"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny, monkeypatch,
                                                          name):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = _run(tiny(name))
    assert not out.correct
    assert out.checks["change_leaf_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught_lm(tiny, monkeypatch):
    from pipe_tpu_torch.train.loop import Trainer

    orig = Trainer._loss_and_grads

    def half(self, data, target, seed):
        n = data.shape[0] // 2
        return orig(self, data[:n], target[:n], seed)

    monkeypatch.setattr(Trainer, "_loss_and_grads", half)
    out = _run(tiny("lm-train-c4"))
    assert not out.correct, out.checks


def test_half_the_batch_left_out_is_caught_gpt2(tiny, monkeypatch):
    from pipe_tpu_torch.parallel.hetero_scheduled import \
        HeteroScheduledPipeline

    orig = HeteroScheduledPipeline.loss_and_grad

    def half(self, tokens, *, targets, loss_fn, seed=0):
        n = tokens.shape[0] // 2
        return orig(self, tokens[:n], targets=targets[:n], loss_fn=loss_fn,
                    seed=seed)

    monkeypatch.setattr(HeteroScheduledPipeline, "loss_and_grad", half)
    out = _run(tiny("gpt2s-train-c16"))
    assert not out.correct, out.checks


@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_an_altered_token_is_caught(tiny, monkeypatch, where):
    from pipe_tpu_torch.serve.engine import SingleDeviceSlotBackend

    if where == "decode":
        orig = SingleDeviceSlotBackend.decode

        def altered(self, *a, **kw):
            toks, valid = orig(self, *a, **kw)
            toks = np.array(toks)
            toks[:, -1] = (toks[:, -1] + 1) % 101
            return toks, valid

        monkeypatch.setattr(SingleDeviceSlotBackend, "decode", altered)
    else:
        orig = SingleDeviceSlotBackend.prefill

        def altered(self, *a, **kw):
            return (orig(self, *a, **kw) + 1) % 101

        monkeypatch.setattr(SingleDeviceSlotBackend, "prefill", altered)
    out = _run(tiny("gpt2s-serve-chat"))
    assert not out.correct, out.checks
