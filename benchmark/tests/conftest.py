"""Tests of the benchmark's harness on the CPU, at tiny sizes: the plain
references against the port, the yardstick's counts, the lookup by name,
the faults the correctness check must catch, and the import rule."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from harness import core  # noqa: E402

# Tiny widths of each configuration, keys as the configuration files name
# them; tiny cells keep each cell's shape of work (stages, chunks, skip).
TINY_CONFIG = {
    "pipe-tutorial-lm": dict(ntokens=101, emsize=16, nhid=32, nlayers=4,
                             nhead=2, bptt=16),
    "gpt2-small": dict(vocab_size=101, n_embd=16, n_layer=4, n_head=2,
                       n_positions=32, n_ctx=32),
}
TINY_CELL = {
    "lm-train-c4": dict(batch=8, max_steps=40),
    "gpt2s-train-c16": dict(batch=8, chunks=4, balance=[2, 2, 2, 2],
                            max_steps=40, reference_rows=2),
    "gpt2s-serve-chat": dict(
        slots=4, max_len=32, rate_per_s=10.0, warmup_requests=4,
        check_tokens=40, drain_s=30,
        prompt={"median": 8, "sigma": 0.5, "min": 2, "max": 20},
        output={"median": 6, "sigma": 0.5, "min": 2, "max": 12}),
}
SEED = 2 ** 33 + 17


def tiny_plan(name: str, root=core.ROOT) -> core.Plan:
    plan = core.plan(name, root)
    plan.config.update(TINY_CONFIG[plan.workload["config"]])
    plan.cell.update(TINY_CELL[name])
    return plan


@pytest.fixture
def tiny():
    return tiny_plan
