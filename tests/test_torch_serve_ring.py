"""pipe_tpu_torch's ring serving backend (``serve/ring.py``) against
pipe_tpu's, and the ``--stages`` entry points.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_ring_cases.py`` (which imports no JAX): each rank
takes its stage of ``pipe_tpu``'s stage-stacked params; a 2-stage mesh is 2
x 2 data, two rings each driven by its stage-0 rank under a ``ServeEngine``
while the other ranks follow. The scenarios are tests/test_serve.py's,
tests/test_kvpool.py's and tests/test_resident.py's for JAX's
``RingSlotBackend``: staggered mixed-length arrivals through the slab
tick, the paged pool, the resident loop, and the n-gram and truncated
speculative lanes. Greedy streams equal JAX's ring engine's and the port's
one-device engine's; sampled streams (keyed draws, C.6) equal the port's
one-device engine's. Then the counters, ``pipe_tpu``'s refusals word for
word, a rank that raises, and ``apps.generate``/``apps.serve --stages 2``.
"""

import json

import jax
import numpy as np
import pytest

import torch_ring_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.inference import GenerationConfig as JGenCfg
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu.serve import BucketSpec as JBucketSpec
from pipe_tpu.serve import RingSlotBackend as JRingSlotBackend
from pipe_tpu.serve import ServeEngine as JServeEngine
from pipe_tpu_torch import convert
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.apps import serve as serve_app
from pipe_tpu_torch.inference import GenerationConfig
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.runtime import World, WorldError
from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                  SingleDeviceSlotBackend)

CFG = dict(vocab=89, d_model=32, nhead=4, d_ff=64, n_layers=4, seq_len=32,
           dropout=0.0)
MIXED = [[int(t) for t in np.random.RandomState(0).randint(
    1, 89, size=n)] for n in (3, 5, 4, 7, 5)]
REPEATS = [[5, 6, 5, 6, 5, 6], [3, 3, 3, 3], [7, 8, 7, 8, 7]]
# (tests/test_*.py scenario, prompts, seed, max_new, backend knobs); the
# buckets are (4, 8) but on the paged pool, as JAX's paged tests build it
SCENARIOS = {
    "slab": (MIXED, 7, 6, dict(max_len=16)),
    "slab-revolutions": (MIXED, 7, 6, dict(max_len=16, revolutions=3)),
    "paged": (MIXED, 7, 6, dict(max_len=16, kv_block_size=4,
                                prefill_chunk=4)),
    "resident": (MIXED, 7, 6, dict(max_len=16, resident=True,
                                   resident_revolutions=4)),
    "paged-resident": (MIXED, 7, 6, dict(max_len=16, kv_block_size=4,
                                         prefill_chunk=4, resident=True,
                                         resident_revolutions=4)),
    "ngram": (REPEATS, 11, 8, dict(max_len=24, resident=True,
                                   resident_revolutions=4, spec_tokens=3)),
    "truncated-paged": (REPEATS, 11, 8, dict(
        max_len=24, resident=True, resident_revolutions=4, spec_tokens=3,
        draft="truncated", kv_block_size=4, prefill_chunk=4)),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


@pytest.fixture(scope="module")
def models():
    """(JAX PipelinedLM of 2 stages, its numpy params, the ranks' stacked
    triple, the port's one-device model of the same weights)."""
    jmodel = jlm.PipelinedLM(jlm.LMConfig(**CFG), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    sp, pre, post = params
    stacked = (jax.tree_util.tree_map(np.asarray, stack_stage_params(sp)),
               pre, post)
    tmodel = tlm.PipelinedLM(tlm.LMConfig(attn_impl="xla", **CFG), 2,
                             device="cpu")
    convert.load_pipelined_lm(tmodel, params)
    return jmodel, params, stacked, tmodel


def _buckets(kw, cls):
    return None if "kv_block_size" in kw else cls.of(4, 8)


def _jax_ring_streams(jmodel, params, prompts, seed, gen_kw, kw):
    """JAX's ring engine over the scenario, arrivals staggered as the
    ranks' (``torch_ring_cases._staggered``)."""
    sp, pre, post = params
    backend = JRingSlotBackend(
        jmake_mesh(2, 1), jmodel, stack_stage_params(sp), pre, post,
        gen=JGenCfg(**gen_kw), buckets=_buckets(kw, JBucketSpec), **kw)
    eng = JServeEngine(backend)
    ids = cases._staggered(eng, prompts, [seed] * len(prompts))
    return [[int(t) for t in eng.response(i).tokens] for i in ids]


def _one_device_streams(tmodel, prompts, seed, gen_kw, kw):
    kw = dict(kw)
    for ring, one in (("revolutions", "decode_chunk"),
                      ("resident_revolutions", "resident_chunks")):
        if ring in kw:
            kw[one] = kw.pop(ring)
    backend = SingleDeviceSlotBackend(
        tmodel, num_slots=2, gen=GenerationConfig(**gen_kw),
        buckets=_buckets(kw, BucketSpec), **kw)
    eng = ServeEngine(backend)
    ids = cases._staggered(eng, prompts, [seed] * len(prompts))
    return [[int(t) for t in eng.response(i).tokens] for i in ids]


def _ring_streams(world, stacked, prompts, seed, gen_kw, kw):
    """Every driver's responses (the two rings of the 2 x 2 mesh)."""
    kw = dict(kw)
    buckets = _buckets(kw, BucketSpec)
    res = world.run(cases.ring_serve, stacked, CFG, (2, 2), prompts,
                    [seed] * len(prompts), gen_kw, kw,
                    None if buckets is None else (4, 8))
    drivers = [r for r in res if r is not None]
    assert len(drivers) == 2
    for r in drivers:
        assert r["status"] == ["ok"] * len(prompts)
        assert r["reason"] == ["length"] * len(prompts)
    return drivers


# the scenarios held to JAX's ring engine too (the rest vary a knob of one
# of them, held to the port's one-device engine, which its own tests hold
# to JAX's)
JAX_SCENARIOS = ("slab", "paged", "resident", "ngram", "truncated-paged")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ring_greedy_streams_match_pipe_tpu(world, models, name):
    """Staggered mixed-length greedy streams through the ring: bit for bit
    the port's one-device engine's in every layout, and JAX's ring
    engine's in its tests' scenarios; one decode (or resident) trace per
    backend."""
    jmodel, params, stacked, tmodel = models
    prompts, seed, max_new, kw = SCENARIOS[name]
    gen_kw = dict(max_new_tokens=max_new, temperature=0.0)
    want = _one_device_streams(tmodel, prompts, seed, gen_kw, kw)
    if name in JAX_SCENARIOS:
        assert _jax_ring_streams(jmodel, params, prompts, seed, gen_kw,
                                 kw) == want
    for r in _ring_streams(world, stacked, prompts, seed, gen_kw, kw):
        assert r["tokens"] == want
        c = r["counters"]
        traces = c["serve.ring.resident_traces"] if kw.get("resident") \
            else c["serve.ring.decode_traces"]
        assert traces == 1
        if "spec_tokens" in kw:
            # greedy verify takes the repeats' drafts: more tokens than
            # rounds
            assert c["serve.engine.spec_emitted"] \
                > c["serve.engine.spec_rounds"] > 0
        if "kv_block_size" in kw:
            assert c["serve.ring.prefill_chunk_traces"] == 1
            assert r["pool_free"] == r["pool_total"]       # drained
        else:
            assert c["serve.ring.prefill_traces"] == 2     # two buckets
            assert r["stats"]["prefill_programs"] == 2


@pytest.mark.parametrize("name", ["slab", "paged-resident", "ngram",
                                  "truncated-paged"])
def test_ring_sampled_streams_equal_the_one_device_engine(world, models,
                                                          name):
    """Sampled streams (T 0.8, top-k 12) drawn on stage n-1 from the
    request's seed and step: bit for bit the port's one-device engine's.
    ``pipe_tpu``'s key chain is not reproduced (C.6)."""
    _, _, stacked, tmodel = models
    prompts, seed, max_new, kw = SCENARIOS[name]
    gen_kw = dict(max_new_tokens=max_new, temperature=0.8, top_k=12)
    want = _one_device_streams(tmodel, prompts, seed, gen_kw, kw)
    for r in _ring_streams(world, stacked, prompts, seed, gen_kw, kw):
        assert r["tokens"] == want


REFUSALS = [
    {"gen": {"max_new_tokens": 4, "num_beams": 2}},
    {"spec_tokens": 3, "resident": False},
    {"spec_tokens": 3, "resident": True, "draft": "tree",
     "spec_branches": 2},
    {"spec_tokens": 3, "resident": True, "spec_adaptive": True},
    {"spec_tokens": 3, "resident": True, "draft": "truncated",
     "draft_stages": 2},
    {"draft": "truncated"},
    {"kv_block_size": 4, "kv_dtype": "int8"},
    {"kv_block_size": 4, "kv_offload": True},
    {"kv_dtype": "int8"},
    {"kv_offload": True},
    {"revolutions": 0},
    {"spec_tokens": 3, "resident": True},
]


def test_ring_refusals_are_pipe_tpus_word_for_word(world, models):
    jmodel, params, stacked, _ = models
    sp, pre, post = params
    want = []
    for kw in REFUSALS:
        kw = dict(kw)
        gen = JGenCfg(**kw.pop("gen", {"max_new_tokens": 4}))
        try:
            JRingSlotBackend(jmake_mesh(2, 1), jmodel,
                             stack_stage_params(sp), pre, post, max_len=16,
                             gen=gen, buckets=JBucketSpec.of(4, 8), **kw)
            want.append(None)
        except (ValueError, NotImplementedError, TypeError) as e:
            want.append([type(e).__name__, str(e)])
    assert want[-1] is None and all(w is not None for w in want[:-1])
    res = world.run(cases.ring_refusals, stacked, CFG, REFUSALS)
    for r in res:
        assert [None if x is None else list(x) for x in r] == want


def test_generate_cli_stages_2(tmp_path, capsys):
    """``apps.generate --stages 2``: the ring decoder's rows and, with
    ``--prompts-file``, the ring engine's, each equal to one device's."""
    base = ["--tiny", "--device", "cpu", "--max-new", "5"]
    extra = ["--batch", "4", "--prompt", "3,1,4,1,5"]
    assert gen_app.main(base + extra) == 0
    want = capsys.readouterr().out.split()
    assert gen_app.main(base + extra + ["--stages", "2"]) == 0
    assert capsys.readouterr().out.split() == want and len(want) == 4
    path = tmp_path / "prompts.txt"
    path.write_text("1,2,3\n4,5,6,7,8\n\n9,10\n")
    files = base + ["--prompts-file", str(path)]
    assert gen_app.main(files) == 0
    want = capsys.readouterr().out.split()
    assert gen_app.main(files + ["--stages", "2"]) == 0
    assert capsys.readouterr().out.split() == want and len(want) == 3


def test_serve_cli_stages_2(capsys):
    """``apps.serve --stages 2`` with the paged pool and the resident
    loop: every request served, the same tokens as one device's engine,
    the ring backend in the summary."""
    argv = ["--tiny", "--device", "cpu", "--requests", "6", "--max-new",
            "8", "--kv", "paged", "--kv-block-size", "8", "--resident",
            "on"]

    def run(extra):
        assert serve_app.main(argv + extra) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
        toks = {r["request"]: r["tokens"] for r in lines[:-1]}
        return toks, lines[-1]["summary"]

    want, one = run([])
    got, ring = run(["--stages", "2"])
    assert got == want and len(got) == 6
    assert ring["backend"] == "RingSlotBackend" and ring["kv"] == "paged"
    assert ring["resident"] and ring["finished"] == 6
    assert one["backend"] == "SingleDeviceSlotBackend"


def test_a_failing_rank_fails_the_call_within_seconds(world, models):
    """A rank that raises while its ring's driver waits in a prefill's
    ring pass: the call fails with the rank's traceback, well inside the
    world's 60 s timeout."""
    import time

    _, _, stacked, _ = models
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="stage 1 fails on purpose"):
        world.run(cases.ring_follower_raises, stacked, CFG)
    assert time.monotonic() - t0 < 30
