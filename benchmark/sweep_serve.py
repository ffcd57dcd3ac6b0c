"""Find the highest rate a serving cell sustains: its knee.

    python3 benchmark/sweep_serve.py --workload NAME --rates 4,6,8 \
        --seconds S --seed N [--out FILE]

One engine (the cell's set-up, once) is offered the cell's traffic at each
rate in turn for ``--seconds``, draining between rates. A rate is
sustained when its queue does not grow through the window: the mean queue
depth over the last quarter of the window is within one request, or a
half, of that over the second quarter, and the time to first token of the
requests due in the last quarter is within 1.5 times that of the second
quarter. One JSON line per rate, with the tails and the tokens per second.
The knee is written into the traffic's file by hand; runs of the benchmark
never search for a rate.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core, traffic  # noqa: E402


def _quarter_mean(samples, seconds, q):
    lo, hi = seconds * q / 4, seconds * (q + 1) / 4
    vals = [v for t, v in samples if lo <= t < hi]
    return statistics.fmean(vals) if vals else 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    core.cache_env()
    plan = core.plan(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = plan.runner()
    _, _, _, _, engine = runner.setup(plan, args.seed, "cuda")
    out = open(args.out, "a") if args.out else None
    for rate in [float(r) for r in args.rates.split(",")]:
        schedule = traffic.serve_schedule(plan.cell, args.seed, args.seconds,
                                          plan.config["vocab_size"],
                                          rate=rate)
        rec = runner.drive(engine, schedule, args.seconds,
                           drain_s=plan.cell["drain_s"])
        lat = runner.ttfts(engine, rec["subs"])
        t0, s = rec["t0"], args.seconds
        by_q = [[x for (due, _), x in zip(rec["subs"], lat)
                 if s * q / 4 <= due - t0 < s * (q + 1) / 4]
                for q in range(4)]
        d2, d4 = (_quarter_mean(rec["depth"], s, 1),
                  _quarter_mean(rec["depth"], s, 3))
        t2 = statistics.median(by_q[1]) if by_q[1] else 0.0
        t4 = statistics.median(by_q[3]) if by_q[3] else 0.0
        grows = d4 > max(d2 + 1.0, 1.5 * d2) or t4 > 1.5 * t2 + 0.005
        c = rec["counters"]
        line = json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "requests": len(lat), "window_s": rec["window_s"],
            "serve_tokens_per_s": (c["tokens"] + c["admitted"])
            / rec["window_s"],
            "ttft_ms_p50": 1e3 * runner.percentile(lat, 50),
            "ttft_ms_p95": 1e3 * runner.percentile(lat, 95),
            "queue_q2": d2, "queue_q4": d4,
            "ttft_ms_q2": 1e3 * t2, "ttft_ms_q4": 1e3 * t4,
            "grows": grows})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        if grows and t4 > 5.0:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
