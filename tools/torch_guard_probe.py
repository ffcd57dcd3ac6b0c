"""Gate (e) of chip_smoke's phase 13, with its diagnostics.

    python3 tools/torch_guard_probe.py

Builds the kernels, runs the one-device guarded twin and the guarded 2 x 2
world with ZeRO under the phase's chaos plan (4 gloo ranks sharing the
card, the full-width LM cut to 12 layers), and then:

- runs the twin again and prints, for each element of the parameters past
  the gate's gradient bound, the twin's gradient of it at every step and
  its tensor's gradient RMS (why the element moved by about lr);
- runs the same world with a planted fault, the gradients of data rank 1
  zeroed before the data all-reduce, and prints every limb of the gate.

Exits non-zero if the sound run fails the gate or the planted fault passes
its parameter limb on any rank.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.runtime.distributed import World

    t_start = time.perf_counter()
    smi = smoke.phase_device()
    smoke.phase_build()
    train_lines, _, vocab = smoke._corpus()
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              smoke.TRAIN_BATCH)
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_guard_")
    try:
        torch.save({"source": torch.from_numpy(source)},
                   os.path.join(tmp, "elastic.pt"))
        twin = smoke._guard_twin(tmp, len(vocab))
        with World(smoke.MESH_WORLD, device="cuda", backend="gloo",
                   timeout=smoke.ELASTIC_TIMEOUT_S,
                   threads=smoke.ELASTIC_THREADS) as world:
            guard = world.run(smoke._guard_rank, tmp, len(vocab))
            planted = world.run(smoke._guard_rank, tmp, len(vocab), True)
        shown = sorted({(e["name"], e["index"]) for g in guard
                        for e in g["past"]})
        watched = (smoke._guard_twin(tmp, len(vocab), watch=shown)["grads"]
                   if shown else {})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smoke.log("guard", card=smi.splitlines()[0], twin_anomalies=twin[
        "anomalies"], twin_rewinds=twin["rewinds"],
        twin_accepted=twin["accepted"])
    smoke._guard_gate(guard, twin, watched)
    missed = []
    for g in planted:
        counts, rel, loss_ok, params_ok = smoke._guard_verdict(g, twin)
        smoke.log("guard", run="planted fault", rank=g["rank"],
                  anomalies=g["anomalies"], rewinds=g["rewinds"],
                  accepted=g["accepted"], counts_equal=counts,
                  loss_rel=f"{rel:.2e}", flipped=f"{g['flipped']:.2e}",
                  param_err=f"{g['param_err']:.2e}", loss_ok=loss_ok,
                  params_ok=params_ok)
        if params_ok:
            missed.append(g["rank"])
    smoke.log("guard", seconds=f"{time.perf_counter() - t_start:.1f}",
              planted_missed_on=missed)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
