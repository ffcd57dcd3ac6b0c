"""Elastic training over data replicas: the drill over 3 stages x 2 data
ranks with ZeRO's sharded moments, on one 6-rank gloo world of CPU ranks
(``tests/torch_elastic_cases.py``). Losing stage 1 drops both of its data
replicas, as ``pipe_tpu`` drops the mesh row; 2 stages x 2 data survive,
each column restoring from its own ranks' captures and its buddy copy.
Held to the port's one-device drill over 3 stages (itself held to
``pipe_tpu``'s in tests/test_torch_elastic.py) from the same seeded
weights, as tests/test_torch_elastic.py holds the 4-stage mesh drill.
"""

import numpy as np
import pytest

import torch_elastic_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.resilience import ChaosPlan, Fault, train_elastic
from pipe_tpu_torch.runtime import World
from pipe_tpu_torch.train import loop as tloop

TOL = 1e-4


@pytest.fixture(scope="module")
def source():
    ids = np.random.RandomState(0).randint(0, cases.DRILL_CFG.vocab,
                                           size=20000)
    return lm_text.batchify(ids, 8)


def test_mesh_drill_over_data_replicas(source):
    tr = tloop.Trainer(cases.DRILL_CFG, cases.drill_config(3), device="cpu",
                       chaos=ChaosPlan([Fault("kill_stage",
                                              **cases.DRILL_KILL)]))
    tr2, state, info = train_elastic(tr, source, state=tr._capture(0),
                                     max_steps=cases.DRILL_STEPS,
                                     log_fn=lambda m: None)
    assert tr2.cfg.n_stages == 2
    with World(6, device="cpu", timeout=120, threads=1) as world:
        res = world.run(cases.mesh_drill_data, source)
    assert sorted((r["stage"], r["data"]) for r in res
                  if r.get("retired")) == [(1, 0), (1, 1)]
    alive = [r for r in res if not r.get("retired")]
    assert [r["grid"] for r in alive] == [[[0, 1], [4, 5]]] * 4
    want = [{k: v for k, v in r.items() if k != "recovery_s"}
            for r in info["recoveries"]]
    for r in alive:
        assert r["recoveries"] == want
        for b, l in info["loss_by_step"].items():
            assert r["loss_by_step"][b] == pytest.approx(l, rel=TOL)
    got = alive[0]["state"]
    noise = {k for k in state.model if k.endswith("attn.wk.bias")}
    for k, v in state.model.items():
        ref = v.numpy()
        bound = (cases.drill_config().lr * cases.DRILL_STEPS if k in noise
                 else TOL * max(1.0, np.abs(ref).max()))
        assert np.abs(got["model"][k] - ref).max() <= bound, k
    biases = {g for g, (n, _) in enumerate(tr2.pipe.named_parameters())
              if n in noise}
    assert set(got["moments"]) == set(state.optimizer["state"])
    for g, st in state.optimizer["state"].items():
        if g in biases:
            continue
        for k in ("exp_avg", "exp_avg_sq"):
            ref = st[k].float().numpy()
            assert np.abs(got["moments"][g][k] - ref).max() <= \
                TOL * np.abs(ref).max(), (g, k)
