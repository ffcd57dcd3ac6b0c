"""The control of the check, on the card: the plain reference put in the
program's place and computed in TF32 (the precision below the
configurations' float32) must come out as not correct under each cell's
limits, here at a size a test run holds (the cells' widths, fewer layers
and rows). The benchmark's runs do not run it; on the chip:
``python -m pytest benchmark/tests/test_portbench_control.py -m cuda``."""

import pytest
import torch

from conftest import SEED

from harness import checks, core
from harness import train as flow


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name,cut", [
    ("lm-train-c4", dict(nlayers=4)),
    ("gpt2s-train-c16", dict(n_layer=4)),
])
def test_tf32_training_fails_the_limits(name, cut):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = core.plan(name)
    plan.config.update(cut)
    plan.cell.update(batch=8, reference_rows=4)
    ref = plan.reference()
    logits_fn = plan.runner().logits_fn(plan)
    w = ref.make_weights(plan.config, SEED, "cuda")
    seq = plan.config.get("bptt") or plan.config["n_positions"]
    vocab = plan.config.get("ntokens") or plan.config["vocab_size"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(2, vocab, (3, 8, seq + 1), generator=g, device="cuda")
    batches = [(x[i, :, :-1], x[i, :, 1:]) for i in range(3)]
    exact = flow.reference_readings(plan, logits_fn, w, batches, "cuda",
                                    keep_grad=True)
    low = flow.reference_readings(plan, logits_fn, w, batches, "cuda",
                                  tf32=True, against=exact["grad"])
    held = checks.held(checks.training_gaps(low, exact,
                                            low["leaf_grad_diff"]),
                       plan.cell["limits"])
    assert not checks.passed(held), held


@pytest.mark.cuda
def test_tf32_serving_fails_the_limit():
    _card()
    plan = core.plan("gpt2s-serve-chat")
    plan.config.update(n_layer=4)
    ref = plan.reference()
    runner = plan.runner()
    w = ref.make_weights(plan.config, SEED, "cuda")
    g = torch.Generator().manual_seed(SEED)
    # as many served tokens as a run checks (``check_tokens``)
    picked = []
    for _ in range(plan.cell["check_tokens"] // 256):
        toks = torch.randint(2, 50257, (512,), generator=g).tolist()
        picked.append((toks[:256], toks[256:]))
    low = runner.reference_gaps(runner.logits_fn(plan), w, picked, "cuda",
                                tf32=True)
    assert max(low) > plan.cell["limits"]["logit_gap"], low
