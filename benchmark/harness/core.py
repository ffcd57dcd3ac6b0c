"""What the harness finds by name, and the lines a run prints.

Every cell, configuration, runner, plain reference and per-layer metric sits
in a file of its own, found from the name ``BENCHMARK.json`` gives it:

* a cell (``workloads[].name``): ``benchmark/cells/<name>.json``, naming its
  runner and holding the program's settings and the limits of its check;
* a traffic mix (``workloads[].traffic``): ``benchmark/traffic/<traffic>.json``,
  the parameters that ``harness/traffic.py`` draws the inputs from;
* a configuration: ``benchmark/configs/<config>.json`` and its plain
  reference ``benchmark/reference/<config>.py``;
* a runner: ``benchmark/runners/<runner>.py`` with ``KIND`` (``train`` or
  ``serve``), ``logits_fn(plan)`` (the plain reference's logits of the
  cell's model) and ``run(plan, ...)``;
* a per-layer metric: ``benchmark/metrics/<metric>.py`` with ``read(ctx)``.

So a later cell, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]

# Top-level module names that no run may have loaded: the JAX stack and the
# JAX package the port was made from (compared whole: ``pipe_tpu_torch``
# is the port and is allowed).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pipe_tpu")


@dataclasses.dataclass
class Plan:
    """One cell as the files describe it."""

    root: Path
    workload: dict                  # the BENCHMARK.json entry
    cell: dict                      # the cell's file and its traffic's
    config: dict                    # benchmark/configs/<config>.json
    end_to_end: List[dict]          # the metric entries this cell reports
    per_layer: List[dict]

    def reference(self) -> ModuleType:
        return load_module(self.root / "benchmark" / "reference"
                           / f"{self.workload['config']}.py")

    def runner(self) -> ModuleType:
        return load_module(self.root / "benchmark" / "runners"
                           / f"{self.cell['runner']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "benchmark" / "metrics"
                           / f"{metric}.py").read


def load_module(path: Path) -> ModuleType:
    """Import ``path`` as a module of its own (file names may hold ``-``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    path = path.resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(
        "-", "_").replace(".", "_") + "_" + tag
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plan(workload: str, root: Path = ROOT) -> Plan:
    """The cell ``workload`` with its files and the metrics it reports:
    the end-to-end metrics without a ``workloads`` list or that list it,
    and the per-layer metrics that list it or, without a list, move one of
    those."""
    bench = _json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    cell = _json(root / "benchmark" / "cells" / f"{workload}.json")
    mix = _json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
    clash = (set(cell) & set(mix)) - {"name", "why"}
    if clash:
        raise ValueError(f"cell {workload} and traffic {entry['traffic']} "
                         f"both set {sorted(clash)}")
    cell = {**mix, **cell}
    config = _json(root / "benchmark" / "configs" / f"{entry['config']}.json")

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Plan(root, entry, cell, config, e2e, layer)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def card_lines() -> List[str]:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {type(e).__name__}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


@dataclasses.dataclass
class Outcome:
    """What a runner hands back: every end-to-end value it measured, the
    context the per-layer readers read, and the verdict."""

    correct: bool
    attempted: int
    failed: int
    checks: Dict[str, tuple]              # name -> (value, limit)
    end_to_end: Dict[str, float]
    layer_ctx: Dict[str, Any]
    device: Dict[str, Any]
    info: Dict[str, Any]
    breakdown: Optional[dict] = None


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def result_line(plan: Plan, out: Outcome, trace: bool) -> dict:
    """The run's last line. Under ``--trace 0`` the cell's end-to-end
    metrics (a missing one raises); under ``--trace 1`` its per-layer
    metrics whose readers found something. ``checks`` comes last."""
    metrics = {}
    if not trace:
        for m in plan.end_to_end:
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in plan.per_layer:
            value = plan.reader(m["name"])(out.layer_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics,
            "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": _number(float(v)),
                          "limit": float(lim)}
                      for k, (v, lim) in out.checks.items()}
    return line


def emit(plan: Plan, out: Outcome, trace: bool) -> None:
    """Earlier lines: the run's facts; then each compared number beside its
    limit on standard error; last, the result line on standard output."""
    for key, value in out.info.items():
        print(f"info {key}: {value}", flush=True)
    line = result_line(plan, out, trace)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} = {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def settle_host() -> None:
    """Before a window: collect the set-up's garbage and freeze what is
    left, so that the window's collections scan only its own objects."""
    gc.collect()
    gc.freeze()


def cache_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for what could compile:
    Triton and torch extensions (the port's own kernels build into
    ``build/torch_kernels`` beside the package)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
