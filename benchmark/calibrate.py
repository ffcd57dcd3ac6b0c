"""Readings that the limits of the correctness check are set from.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds S] [--out FILE]

For each seed, the numbers a run of the cell compares, from the program at
the cell's own size (training: its first three steps; serving: a window of
``--seconds`` at the cell's load). For each control seed, the same numbers
with the plain reference put in the program's place and computed in TF32
(the nearest precision below the configuration's float32), and, for a
training cell, with the reference trained on half of each batch (the mean
over the rest). One JSON line per reading, to ``--out`` and standard
output. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import checks, core  # noqa: E402


def _free(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_readings(plan, seed, control: bool, device="cuda"):
    from harness import train as flow

    runner = plan.runner()
    ref = plan.reference()
    cfg = plan.config
    logits_fn = runner.logits_fn(plan)
    weights = ref.make_weights(cfg, seed, device)
    prog = runner.Program(plan, weights, seed, device)
    got = flow.readings(prog, weights, device)
    weights = {n: w.cpu() for n, w in weights.items()}
    batches = [prog.batch(b) for b in range(flow.COMPARED_STEPS)]
    del prog
    _free(device)
    exact = flow.reference_readings(plan, logits_fn, weights, batches,
                                    device, against=got["grad"],
                                    keep_grad=control)
    rows = [("program", checks.training_gaps(got, exact,
                                             exact["leaf_grad_diff"]))]
    if control:
        for kind, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch",
                          {"rows": plan.cell["batch"] // 2})):
            low = flow.reference_readings(plan, logits_fn, weights, batches,
                                          device, against=exact["grad"], **kw)
            rows.append((kind, checks.training_gaps(
                low, exact, low["leaf_grad_diff"])))
    worst = {k: checks.leaf_gap(got[k], exact[k])[1]
             for k in ("leaf_grad", "leaf_change")}
    return rows, {"worst_leaf": worst, "losses": got["losses"]}


def serve_readings(plan, seed, control: bool, seconds: float,
                   device="cuda"):
    runner = plan.runner()
    _, weights, model, backend, engine = runner.setup(plan, seed, device)
    from harness import traffic

    schedule = traffic.serve_schedule(plan.cell, seed, seconds,
                                      plan.config["vocab_size"])
    rec = runner.drive(engine, schedule, seconds,
                       drain_s=plan.cell["drain_s"])
    picked = runner.sample(engine, rec["subs"], seed,
                           plan.cell["check_tokens"])
    del engine, backend, model
    _free(device)
    logits_fn = runner.logits_fn(plan)
    gaps = runner.reference_gaps(logits_fn, weights, picked, device)
    rows = [("program", {"logit_gap": max(gaps)})]
    if control:
        low = runner.reference_gaps(logits_fn, weights, picked, device,
                                    tf32=True)
        rows.append(("control_tf32", {"logit_gap": max(low)}))
    return rows, {"checked_tokens": sum(len(s) for _, s in picked),
                  "requests": len(rec["subs"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    core.cache_env()
    plan = core.plan(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds + sorted(control - set(seeds)):
        t0 = time.perf_counter()
        if plan.runner().KIND == "serve":
            rows, extra = serve_readings(plan, seed, seed in control,
                                         args.seconds)
        else:
            rows, extra = train_readings(plan, seed, seed in control)
        for kind, gaps in rows:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind, **gaps, **extra,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if core.forbidden_loaded():
        print(f"forbidden modules loaded: {core.forbidden_loaded()}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
