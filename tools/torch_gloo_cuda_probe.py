"""Does this torch's gloo backend take CUDA tensors?

    python3 tools/torch_gloo_cuda_probe.py [--out DIR]

For each operation (``send``/``recv``, ``all_reduce``, ``all_gather``) two
fresh ranks on ``cuda:0`` (one card shared, the port's mesh setup over gloo)
hand gloo CUDA tensors directly, with no staging, and check the result. A
rank that raises is reported with its message; a rank that dies (gloo may
abort the process) with its exit code, and the next operation gets a new
pair. Prints one line per operation with the torch and CUDA versions and the
card, and the same as JSON into ``DIR/gloo_cuda_probe.json`` with ``--out``.
The port stages CUDA tensors through pinned host memory whatever this says
(``pipe_tpu_torch/parallel/mesh.py``); the probe records what gloo itself
accepts.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("send_recv", "all_reduce", "all_gather")


def _run_op(rank: int, store: str, op: str, out) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        if op == "send_recv":
            t = torch.full((4,), float(rank + 1), device="cuda")
            if rank == 0:
                dist.send(t, 1)
                ok = True
            else:
                dist.recv(t, 0)
                ok = bool((t == 1).all())
        elif op == "all_reduce":
            t = torch.full((1 << 20,), float(rank + 1), device="cuda")
            dist.all_reduce(t)
            ok = bool((t == 3).all())
        else:
            t = torch.full((8,), float(rank), device="cuda")
            outs = [torch.empty(8, device="cuda") for _ in range(2)]
            dist.all_gather(outs, t)
            ok = bool((outs[0] == 0).all() and (outs[1] == 1).all())
        out.put((rank, "taken" if ok else "wrong result"))
    except Exception as e:                     # noqa: BLE001 -- reported
        out.put((rank, f"raised {type(e).__name__}: {str(e)[:200]}"))


def probe(op: str, timeout: float = 120.0) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=_run_op, args=(r, store, op, q))
             for r in (0, 1)]
    for p in procs:
        p.start()
    got = {}
    for _ in procs:
        try:
            rank, what = q.get(timeout=timeout)
            got[rank] = what
        except queue.Empty:
            break
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(5)
    for r, p in enumerate(procs):
        if r not in got:
            got[r] = f"died (exit code {p.exitcode})"
    return {f"rank{r}": got[r] for r in (0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe needs the card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    doc = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": card.strip(), "ops": {}}
    for op in OPS:
        doc["ops"][op] = probe(op)
        print(f"gloo {op} of CUDA tensors: {doc['ops'][op]}", flush=True)
    print(json.dumps(doc))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "gloo_cuda_probe.json"), "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
