"""Each plain reference against the port at tiny sizes, from the same
weights (the benchmark's, loaded into the port's modules)."""

import pytest
import torch

from conftest import SEED

from harness import core, plain


def _adapter(plan):
    return core.load_module(plan.root / "benchmark" / "adapters"
                            / f"{plan.config['family']}.py")


def test_weights_are_the_seeds():
    plan = core.plan("gpt2s-train-c16")
    ref = plan.reference()
    from conftest import TINY_CONFIG
    plan.config.update(TINY_CONFIG["gpt2-small"])
    a = ref.make_weights(plan.config, SEED, "cpu")
    b = ref.make_weights(plan.config, SEED, "cpu")
    c = ref.make_weights(plan.config, SEED + 1, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte"], c["wte"])
    assert float(a["blocks.0.attn.wq.weight"].abs().max()) <= 16 ** -0.5


def test_tutorial_lm_reference_matches_port(tiny):
    from pipe_tpu_torch.models.transformer_lm import build_sequential

    plan = tiny("lm-train-c4")
    ref, adapter = plan.reference(), _adapter(plan)
    w = ref.make_weights(plan.config, SEED, "cpu")
    seq = build_sequential(adapter.model_config(plan.config), device="cpu")
    adapter.load(list(seq), w)
    tokens = torch.randint(0, 101, (3, 16), generator=torch.Generator()
                           .manual_seed(1))
    with torch.no_grad():
        want = seq(tokens)
        got = ref.logits(w, tokens, plan.config)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("skip", [False, True])
def test_gpt2_reference_matches_port(tiny, skip):
    from pipe_tpu_torch.models import gpt2

    plan = tiny("gpt2s-train-c16")
    ref, adapter = plan.reference(), _adapter(plan)
    w = ref.make_weights(plan.config, SEED, "cpu")
    seq = gpt2.build_sequential(adapter.model_config(plan.config),
                                embed_skip=skip, device="cpu")
    adapter.load(list(seq), w)
    tokens = torch.randint(2, 101, (2, 32), generator=torch.Generator()
                           .manual_seed(2))
    with torch.no_grad():
        if skip:
            from pipe_tpu_torch import Pipe
            want = Pipe(seq, chunks=1, balance=[len(seq)], device="cpu")(
                tokens)
        else:
            want = seq(tokens)
        got = ref.logits(w, tokens, plan.config, embed_skip=skip)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_training_matches_port_trainer(tiny):
    """Three steps of the plain clip + Adam against the port's Trainer."""
    from harness import train as flow

    plan = tiny("lm-train-c4")
    ref = plan.reference()
    runner = plan.runner()
    w = ref.make_weights(plan.config, SEED, "cpu")
    prog = runner.Program(plan, w, SEED, "cpu")
    got = flow.readings(prog, w, "cpu")
    batches = [prog.batch(b) for b in range(3)]
    exact = flow.reference_readings(
        plan, lambda p, t: ref.logits(p, t, plan.config), w, batches, "cpu",
        against=got["grad"])
    from harness import checks
    gaps = checks.training_gaps(got, exact, exact["leaf_grad_diff"])
    assert max(gaps.values()) < 1e-4, gaps
    assert got["losses"] == pytest.approx(exact["losses"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(exact["grad_norm"], rel=1e-5)
    assert exact["grad_norm"] > plan.cell["clip"]       # the clip acted
    for n in checks.moving_leaves(exact["leaf_grad"]):
        assert got["leaf_change"][n] == pytest.approx(
            exact["leaf_change"][n], rel=1e-3, abs=1e-9)


def test_layer_norm_and_gelu_are_torchs():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(3))
    g, b = torch.rand(8) + 0.5, torch.randn(8)
    assert torch.allclose(plain.layer_norm(x, g, b),
                          torch.nn.functional.layer_norm(x, (8,), g, b),
                          atol=1e-6)
    assert torch.allclose(plain.gelu_tanh(x),
                          torch.nn.functional.gelu(x, approximate="tanh"),
                          atol=1e-6)
