"""The harness's lookup by name, its refusals, its traffic and its line."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import BENCH, ROOT, SEED, TINY_CONFIG

from harness import core, traffic


def _copy_benchmark(dst):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_new_cell_config_and_metric_are_new_files_only(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and new entries: the harness finds and runs them."""
    _copy_benchmark(tmp_path)
    b = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    cfg = json.loads((b / "configs" / "gpt2-small.json").read_text())
    cfg.update(TINY_CONFIG["gpt2-small"], name="gpt2-mini")
    (b / "configs" / "gpt2-mini.json").write_text(json.dumps(cfg))
    shutil.copy(b / "reference" / "gpt2-small.py",
                b / "reference" / "gpt2-mini.py")
    (b / "traffic" / "train-b8-mini.json").write_text(json.dumps(
        {"name": "train-b8-mini", "why": "tiny", "batch": 8,
         "max_steps": 40}))
    cell = json.loads((b / "cells" / "gpt2s-train-c16.json").read_text())
    cell.update(name="gpt2m-train-c4", chunks=4, balance=[2, 2, 2, 2],
                reference_rows=2)
    (b / "cells" / "gpt2m-train-c4.json").write_text(json.dumps(cell))
    (b / "metrics" / "first_loss.train.py").write_text(
        "def read(ctx):\n    return ctx['train']['tokens_per_s'] * 0 + 1.5\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gpt2-mini", "source": "tiny",
                             "file": "benchmark/configs/gpt2-mini.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "gpt2m-train-c4",
                               "config": "gpt2-mini",
                               "traffic": "train-b8-mini", "chips": 1,
                               "why": "tiny"})
    bench["per_layer"].append({"name": "first_loss.train", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "trainer step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["gpt2m-train-c4"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "lm-train-c4" in m["workloads"]:
            m["workloads"].append("gpt2m-train-c4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    plan = core.plan("gpt2m-train-c4", root=tmp_path)
    assert plan.config["n_embd"] == 16 and plan.cell["batch"] == 8
    assert [m["name"] for m in plan.end_to_end] == [
        "train_tokens_per_s", "train_peak_gib", "setup_s"]
    assert "first_loss.train" in [m["name"] for m in plan.per_layer]
    assert "host_ms_per_token.serve" not in [m["name"]
                                             for m in plan.per_layer]
    out = plan.runner().run(plan, SEED, 0.3, False, "cpu",
                            time.perf_counter())
    assert out.correct, out.checks
    line = core.result_line(plan, out, trace=False)
    assert set(line["metrics"]) == {"train_tokens_per_s", "train_peak_gib",
                                    "setup_s"}
    assert plan.reader("first_loss.train")(out.layer_ctx) == 1.5
    after = {p: p.read_bytes() for p in before}
    assert after == before                  # no file that was there changed


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_run_refuses_without_the_program(tmp_path):
    _copy_benchmark(tmp_path)
    r = _run(tmp_path, "--workload", "lm-train-c4", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run(ROOT, "--workload", "gpt2s-serve-chat", "--seed",
             str(2 ** 33), "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs 1 CUDA card" in r.stderr


def test_forbidden_modules_are_compared_whole(monkeypatch):
    base = core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "pipe_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert core.forbidden_loaded() == base
    monkeypatch.setitem(sys.modules, "pipe_tpu.fake", object())
    assert "pipe_tpu" in core.forbidden_loaded()


SCRIPT = """
import sys, time
sys.path[:0] = [{bench!r}, {root!r}]
sys.path.insert(0, {tests!r})
from conftest import tiny_plan, SEED
from harness import core
for name in ("lm-train-c4", "gpt2s-train-c16", "gpt2s-serve-chat"):
    plan = tiny_plan(name)
    out = plan.runner().run(plan, SEED, 0.3, False, "cpu", time.perf_counter())
    assert out.correct, (name, out.checks)
print(core.forbidden_loaded())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tests = os.path.dirname(os.path.abspath(__file__))
    code = SCRIPT.format(bench=BENCH, root=ROOT, tests=tests)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("config", ["pipe-tutorial-lm", "gpt2-small"])
def test_references_import_nothing_of_the_port(config):
    code = (f"import sys; sys.path[:0] = [{BENCH!r}]\n"
            "from pathlib import Path\n"
            "from harness import core\n"
            f"core.load_module(Path({BENCH!r}) / 'reference' / '{config}.py')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pipe_tpu_torch', 'pipe_tpu', 'jax')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_every_seed_offers_the_same_work():
    cell = core.plan("gpt2s-serve-chat").cell
    a = traffic.serve_schedule(cell, SEED, 30.0, 50257)
    b = traffic.serve_schedule(cell, SEED + 1, 30.0, 50257)
    again = traffic.serve_schedule(cell, SEED, 30.0, 50257)
    assert [x.due_s for x in a] == [x.due_s for x in b]
    assert sorted((len(x.prompt), x.max_new) for x in a) == \
        sorted((len(x.prompt), x.max_new) for x in b)
    assert [(len(x.prompt), x.max_new) for x in a] == \
        [(len(x.prompt), x.max_new) for x in b]
    assert [x.prompt for x in a] != [x.prompt for x in b]
    assert [x.prompt for x in a] == [x.prompt for x in again]
    assert len(a) == round(cell["rate_per_s"] * 30)
    pl, ol = cell["prompt"], cell["output"]
    assert all(pl["min"] <= len(x.prompt) <= pl["max"]
               and ol["min"] <= x.max_new <= ol["max"]
               and len(x.prompt) + x.max_new <= cell["max_len"] for x in a)
    src = traffic.lm_source(SEED, 257, 32, 28782)
    assert (src == traffic.lm_source(SEED, 257, 32, 28782)).all()
    d0, t0 = traffic.lm_batch(src, 0, 128)
    d1, _ = traffic.lm_batch(src, 1, 128)
    assert (t0[:, :-1] == d0[:, 1:]).all() and (t0[:, -1] == d1[:, 0]).all()


def test_result_line_ends_with_the_checks(tiny):
    plan = tiny("gpt2s-serve-chat")
    out = core.Outcome(
        correct=True, attempted=3, failed=0,
        checks={"logit_gap": (0.0, 1e-3)},
        end_to_end={"serve_tokens_per_s": 10.0, "ttft_ms_p95": 5.0,
                    "setup_s": 1.0},
        layer_ctx={"serve": {"host_s": 0.1, "tokens": 10, "decode_calls": 2,
                             "decode_s": 0.02, "prefill_s": 0.01,
                             "prefill_tokens": 100}, "trace": None},
        device={"platform": "gpu", "kind": "x", "count": 1,
                "memory_peak_bytes": 1}, info={})
    line = core.result_line(plan, out, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["metrics"]["ttft_ms_p95"] == {"value": 5.0, "unit": "ms"}
    traced = core.result_line(plan, out, trace=True)
    assert traced["metrics"] == {
        "host_ms_per_token.serve": {"value": pytest.approx(10.0),
                                    "unit": "ms"},
        "decode_ms_per_tick.serve": {"value": pytest.approx(10.0),
                                     "unit": "ms"},
        "prefill_ms_per_ktok.serve": {"value": pytest.approx(100.0),
                                      "unit": "ms"}}
