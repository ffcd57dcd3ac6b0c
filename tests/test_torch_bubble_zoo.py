"""pipe_tpu_torch's bubble probe (``obs/bubble_probe.py``) and the zoo over a
world of stage ranks (``apps.zoo --world N``), on one 2-rank gloo world of
CPU ranks.

* The probe's record at tiny widths (``iters=1``, ``--schedules
  --transport``): ``pipe_tpu``'s keys, its top-level values (``main(...)``
  of ``pipe_tpu/obs/bubble_probe.py``), and per schedule row the name, the
  table's analytic bubble and the phase program's cycle counts as
  ``pipe_tpu``'s executors give them. ``pipe_tpu``'s ``main`` with
  ``compare_schedules=True`` stops at its ``zb-h1-split`` row on this tree
  (ROADMAP.md C.4: its ``split_backward_stage`` fails on the installed JAX),
  so its rows are built from its executors directly.
* ``apps.zoo gpt2 --tiny --device cpu --world 2`` (1f1b through
  ``ScheduledPipeline(mesh=)``, gpipe through ``SpmdPipeline(mesh=)``)
  trains to the one-device zoo's losses; a world that is not one rank a
  stage exits 2.
"""

import warnings

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.schedule import bubble_fraction
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.models.transformer_lm import PipelinedLM as JLM
from pipe_tpu.obs import bubble_probe as jprobe
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu_torch.apps import zoo
from pipe_tpu_torch.obs import bubble_probe
from pipe_tpu_torch.runtime import World

N, M = 2, 4
TINY = dict(d_model=16, d_ff=32, seq_len=8, iters=1)
# pipe_tpu's --schedules --transport rows (pipe_tpu/obs/bubble_probe.py
# :117-152): (name, schedule, checkpoint, phase_compile)
JAX_ROWS = [("1f1b", "1f1b", "never", None),
            ("1f1b-overlap", "1f1b", "never", None),
            ("1f1b+policy", "1f1b", "except_last", None),
            ("zb-h1", "zb-h1", "never", None),
            ("zb-h1-split", "zb-h1", "never", None),
            ("zb-h2-split", "zb-h2", "never", None),
            ("1f1b-phase", "1f1b", "never", True),
            ("zb-h1-phase", "zb-h1", "never", True),
            ("zb-h1-split-phase", "zb-h1", "never", True)]
ZOO = ["gpt2", "--tiny", "--device", "cpu", "--stages", "2", "--steps", "3",
       "--chunks", "2", "--batch", "4"]
TOL_ZOO = 1e-5


@pytest.fixture(scope="module")
def world():
    with World(N, device="cpu", threads=1, timeout=300.0) as w:
        yield w


def test_probe_record_is_pipe_tpus(world):
    kw = dict(TINY, compare_schedules=True, compare_transport=True,
              skip_slope=False)
    got = world.run(bubble_probe._rank_probe, N, M, kw)[0]
    want = jprobe.main(N, M, skip_slope=False, **TINY)
    assert set(got) == set(want) | {"schedules"}
    assert got["platform"] == f"cpu-gloo{N}"
    for key in ("n_stages", "chunks", "d_model", "analytic_bubble"):
        assert got[key] == want[key], key
    assert got["analytic_bubble"] == round(bubble_fraction(M, N), 4)
    assert got["t_m_sec"] > 0 and 0.0 <= got["measured_bubble"] <= 1.0
    rows = got["schedules"]
    assert list(rows) == [name for name, *_ in JAX_ROWS]
    cfg = JLMConfig(vocab=512, d_model=16, nhead=4, d_ff=32, n_layers=N,
                    seq_len=8, dropout=0.0)
    model = JLM(cfg, N)
    mesh = jmake_mesh(N, 1)
    for name, schedule, checkpoint, phase in JAX_ROWS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jpipe = JPipeline(mesh, model.stage_fn, pre_fn=model.pre_fn,
                              post_fn=model.loss_post_fn,
                              checkpoint=checkpoint, schedule=schedule,
                              phase_compile=phase)
        row = rows[name]
        assert row["sec_per_step"] > 0, name
        assert row["analytic_bubble"] == round(
            jpipe.schedule.bubble(M, N), 4), name
        if phase:
            prog = jpipe._phase_program(M)
            assert row["phase"] == {"unrolled_cycles": prog.unrolled_cycles,
                                    "scan_cycles": prog.scan_cycles}, name
        else:
            assert "phase" not in row, name
        assert ("measured_bubble" in row) == (name in ("1f1b",
                                                       "1f1b-overlap")), name


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_zoo_world_trains_to_the_one_device_losses(world, schedule):
    argv = ZOO + ["--schedule", schedule]
    one = zoo.train(zoo.build_argparser().parse_args(argv))["losses"]
    ranks = world.run(zoo._rank_main, argv + ["--world", str(N)])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one, rtol=TOL_ZOO)
    lines = ranks[0]["stdout"].splitlines()
    assert f"on {N} stage ranks, schedule={schedule}" in lines[0]
    assert [float(l.split("loss ")[1]) for l in lines
            if l.startswith("| step")] == pytest.approx(one, rel=1e-3)
    assert ranks[1]["stdout"] == ""


def test_zoo_world_must_be_one_rank_a_stage(capsys):
    assert zoo.main(ZOO + ["--world", "3"]) == 2
    assert "--world 3 must equal --stages 2" in capsys.readouterr().err
