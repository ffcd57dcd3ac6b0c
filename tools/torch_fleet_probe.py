"""Where does a process replica's serving time go on one card?

    python3 tools/torch_fleet_probe.py

``chip_smoke.py``'s fleet phase serves its traffic (48 greedy requests of
128 tokens on 4 shared 64-token prefixes, 64 new tokens, the tutorial LM at
full width, 4 slots a replica, paged, resident) through one engine and
through three child processes on the same card, over the JSON wire. This
probe separates what the processes cost: the same warm traffic through

1. one engine in this process;
2. one child process, JSON wire;
3. one child process, msgpack wire;
4. three child processes, msgpack wire;
5. three child processes, JSON wire.

Rows 1-2 price the process boundary, 2-3 the codec, 3-4 three CUDA contexts
sharing the card. Prints the card (``nvidia-smi`` name and power limit) and
one line per row: generated tokens/s, TTFT p50/p99, wall.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def _fleet(cfg, prompts, n, json_wire, tmpdir):
    from pipe_tpu_torch.fleet import FleetController, RouterPolicy
    from pipe_tpu_torch.serve import RequestQueue

    live = []
    wire = (cs._json_wire(tmpdir) if json_wire
            else cs.contextlib.nullcontext())
    with wire:
        try:
            trs = cs._spawn_children([cs._fleet_spec(cfg)] * n, live)
            codecs = [tr._rpc({"op": "status"})["codec"] for tr in trs]
            ctl = FleetController(trs, RequestQueue(capacity=256),
                                  policy=RouterPolicy(
                                      placement="prefix",
                                      backoff_base_s=0.0,
                                      heartbeat_timeout_s=10.0))
            cs._fleet_drive(ctl, prompts[:8], "warm-up", pace=0.0005)
            resps, wall, _ = cs._fleet_drive(ctl, prompts, "probe",
                                             pace=0.0005)
        finally:
            cs._end_children(live)
    return dict(cs._rates(resps, wall), codecs=codecs,
                spawn_to_ready_s=[f"{t.spawn_to_ready_s:.2f}" for t in trs])


def main() -> int:
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.serve import RequestQueue, ServeEngine

    smi = cs.phase_device()
    card = repr(smi.splitlines()[0])
    cfg, seq, _, _ = cs.make_slice(1)
    prompts = cs._fleet_prompts(cfg.vocab)
    eng = ServeEngine(cs._fleet_backend(PipelinedLM.from_sequential(cfg,
                                                                    seq)),
                      RequestQueue(capacity=256))
    cs._fleet_drive(eng, prompts[:8], "warm-up")
    resps, wall, _ = cs._fleet_drive(eng, prompts, "1 engine")
    cs.log("probe", row="1 engine", card=card, **cs._rates(resps, wall))
    del eng, seq
    torch.cuda.empty_cache()
    tmpdir = tempfile.mkdtemp(prefix="fleet-probe-")
    for name, n, json_wire in (("1 child json", 1, True),
                               ("1 child msgpack", 1, False),
                               ("3 children msgpack", 3, False),
                               ("3 children json", 3, True)):
        cs.log("probe", row=name, card=card,
               **_fleet(cfg, prompts, n, json_wire, tmpdir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
