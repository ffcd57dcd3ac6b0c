"""Run one cell of the benchmark of ``pipe_tpu_torch`` once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's files (``benchmark/cells/NAME.json``,
its configuration, runner, reference and metric readers) are found from
``BENCHMARK.json``. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled stretch. Earlier lines
give the card, the versions and the sample counts; the compared numbers
and their limits end standard error; the last line of standard output is
the result. Exits non-zero, printing no result, without the cards the cell
asks for, or if the JAX stack or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    core.cache_env()
    plan = core.plan(args.workload)

    import torch

    chips = plan.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)            # one process, few host threads
    torch.backends.cuda.matmul.allow_tf32 = bool(plan.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(plan.config["tf32"])
    for line in core.card_lines():
        print(f"info card: {line}")
    print(f"info versions: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    out = plan.runner().run(plan, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = core.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    core.emit(plan, out, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
