"""Can this PyTorch capture data-dependent control flow in a CUDA graph?

    python3 tools/torch_cond_probe.py

The serve engine's resident loop (``serve/engine.py``) is ``pipe_tpu``'s
``lax.while_loop``: a loop whose exit depends on device data. A CUDA graph
can hold that only through conditional nodes (CUDA 12.4+). This probe asks
the installed PyTorch, on the card, for each way in:

1. ``torch.cuda.CUDAGraph.begin_capture_to_if_node`` /
   ``end_capture_to_conditional_node`` (the capture API for if nodes);
2. ``torch._higher_order_ops.cudagraph_conditional_nodes`` (``torch.cond``
   lowered to if nodes during capture);
3. ``torch._higher_order_ops.while_loop`` captured inside
   ``torch.cuda.graph`` and replayed.

Prints the card (``nvidia-smi`` name, power limit, driver), the versions
and one JSON line with the answers. The engine unrolls the loop in one
graph when none of them works.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs on a GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "if_node_capture_api": all(
               hasattr(torch.cuda.CUDAGraph, n)
               for n in ("begin_capture_to_if_node",
                         "end_capture_to_conditional_node"))}
    try:
        importlib.import_module(
            "torch._higher_order_ops.cudagraph_conditional_nodes")
        out["cond_to_if_nodes_module"] = True
    except ImportError:
        out["cond_to_if_nodes_module"] = False
    try:
        from torch._higher_order_ops.while_loop import while_loop

        i0 = torch.zeros((), dtype=torch.int64, device="cuda")
        res = torch.zeros_like(i0)

        def loop():
            return while_loop(lambda i: i < 5, lambda i: (i + 1,), (i0,))[0]

        res.copy_(loop())                     # eager warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            res.copy_(loop())
        graph.replay()
        torch.cuda.synchronize()
        out["while_loop_capture"] = f"ok: {int(res)}"
    except Exception as e:                    # noqa: BLE001 — the answer
        out["while_loop_capture"] = (f"{type(e).__name__}: "
                                     f"{str(e).splitlines()[0][:160]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
