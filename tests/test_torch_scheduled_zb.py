"""pipe_tpu_torch's table executor against pipe_tpu's ``ScheduledPipeline``
on the split-backward (zb-h1) and interleaved (interleaved-1f1b) tables:
the tiny LM with ``loss_post_fn``, every checkpoint mode, at (n, m) = (2, 4),
(4, 8) and (4, 2), dropout 0, from converted weights, with the tolerances
and the helpers of tests/test_torch_scheduled.py. zb-h1 under ``never`` runs
JAX's stored-vjp split (B the input cotangent, W the parameter gradients);
interleaved-1f1b runs ``2n`` virtual stages, ``g·n + p`` on stage ``p``.
The port's structural split (``split_stage="auto"``) is held to the same
step (JAX's own structural split cannot run on this JAX, ROADMAP.md C.4)
and its ``memory_plan`` to JAX's executor with ``split_stage="auto"``.
"""

import pytest

from torch_threads import one_torch_thread  # noqa: F401
from test_torch_scheduled import GEOMS, MODES, check_against_pipe_tpu


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,m", GEOMS)
@pytest.mark.parametrize("schedule", ["zb-h1", "interleaved-1f1b"])
def test_executor_matches_pipe_tpu(schedule, n, m, mode):
    pipe = check_against_pipe_tpu(schedule, mode, n, m)
    assert 0 < pipe.last_slots["stash"] <= pipe.schedule.stash_slots(m, n)
    split = schedule == "zb-h1" and mode == "never"
    assert (pipe.last_slots["wstash"] > 0) == split


@pytest.mark.parametrize("n,m", GEOMS)
def test_structural_split_matches_pipe_tpu(n, m):
    pipe = check_against_pipe_tpu("zb-h1", "never", n, m, split_stage="auto")
    assert pipe.memory_plan(m)["taps_slots"] == \
        pipe.schedule.stash_slots(m, n) > 0
    assert 0 < pipe.last_slots["wstash"] <= pipe.schedule.wstash_slots(m, n)
    assert pipe.stage_passes(m) == {"forward": n * m, "backward": n * m}
