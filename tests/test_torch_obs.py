"""pipe_tpu_torch's training observability against pipe_tpu's: the FLOPs
model and ``StepReport`` (with ``pipe_tpu``'s arguments, and ``n_devices=1``
for stages that share one card), the TensorBoard writer byte for byte, the
bubble arithmetic, the per-stage timeline read from a ``torch.profiler``
Chrome trace (the host ranges on the CPU; synthetic CUDA traces for the
device attribution), and the ``Trainer``'s events and TensorBoard tags with
telemetry on, whose losses are bitwise those of the run without.
"""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.obs import meters as jmeters
from pipe_tpu.obs import tb_writer as jtb
from pipe_tpu.obs import telemetry as jtel
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import Pipe, convert
from pipe_tpu_torch.core.schedule import get_schedule
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs import meters as tmeters
from pipe_tpu_torch.obs import tb_writer as ttb
from pipe_tpu_torch.obs import telemetry as ttel
from pipe_tpu_torch.obs.events import EventLog
from pipe_tpu_torch.train import loop as tloop

from pipe_tpu.core.schedule import get_schedule as jget_schedule


@pytest.mark.parametrize("checkpoint", ["never", "except_last", "always"])
@pytest.mark.parametrize("causal", [True, False])
def test_train_flops_per_token_matches_pipe_tpu(checkpoint, causal):
    cfg = dataclasses.replace(tlm.LMConfig(), causal=causal)
    assert ttel.train_flops_per_token(cfg, checkpoint, 4) == \
        jtel.train_flops_per_token(cfg, checkpoint, 4)


def test_train_flops_of_the_tutorial_lm():
    """The prediction PERF.md writes down for the tutorial LM at the chip
    run's 19,480-word vocabulary: ~2.68 GFLOP a trained token required and
    ~3.29 with except_last's recompute."""
    req, hw = ttel.train_flops_per_token(
        dataclasses.replace(tlm.LMConfig(), vocab=19_480), "except_last", 4)
    assert req == pytest.approx(2.68e9, rel=5e-3)
    assert hw == pytest.approx(3.29e9, rel=5e-3)


_REPORT_CASES = [
    dict(step=3, wall_sec=0.25, tokens=4096, n_stages=2, chunks=4,
         checkpoint="except_last", schedule="gpipe", loss=5.4321,
         analytic_bubble=0.2, memory={"d0": {"peak_bytes_in_use": 2 ** 31}},
         compile_inclusive=True, platform="gpu", device_kind="k", epoch=1),
    dict(step=1, wall_sec=0.5, tokens=100, n_stages=4, chunks=8,
         checkpoint="never", measured_bubble=0.3,
         measured_bubble_method="trace"),
    dict(step=0, wall_sec=0.0, tokens=10),
]


@pytest.mark.parametrize("case", range(len(_REPORT_CASES)))
def test_step_report_matches_pipe_tpu(case):
    kw = dict(_REPORT_CASES[case], model_cfg=tlm.LMConfig(), peak_flops=1e14)
    got = ttel.StepReport.compute(**kw)
    want = jtel.StepReport.compute(**kw)
    assert got.to_json() == want.to_json()
    assert got.scalar_items() == want.scalar_items()


def test_step_report_n_devices_scales_per_chip_rates():
    kw = dict(step=1, wall_sec=0.4, tokens=4096, n_stages=2, chunks=4,
              checkpoint="except_last", model_cfg=tlm.LMConfig(),
              peak_flops=66.9e12)
    stages = ttel.StepReport.compute(**kw)
    one = ttel.StepReport.compute(n_devices=1, **kw)
    assert one.tokens_per_sec_per_chip == pytest.approx(
        2 * stages.tokens_per_sec_per_chip)
    assert one.mfu == pytest.approx(2 * stages.mfu)
    assert one.hfu == pytest.approx(2 * stages.hfu)
    assert one.to_json()["n_devices"] == 1 and "n_devices" not in \
        stages.to_json()
    # no peak on the CPU: no MFU, where pipe_tpu assumes a v5e
    cpu = ttel.StepReport.compute(**dict(kw, peak_flops=None))
    assert cpu.mfu is None and cpu.hfu is None


@pytest.mark.parametrize("math_kind,setup", [
    ("fp32", dict(tf32=False, dtype=torch.float32)),
    ("tf32", dict(tf32=True, dtype=torch.float32)),
    ("bf16", dict(tf32=False, dtype=torch.bfloat16))])
def test_peak_flops_reads_the_card_and_its_math(monkeypatch, math_kind,
                                                 setup):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        setup["tf32"])
    want = {"fp32": 66.9e12, "tf32": 494.7e12, "bf16": 989.4e12}[math_kind]
    assert ttel.peak_flops_per_chip(setup["dtype"], "cuda") == want
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "Some Other GPU")
    with pytest.raises(ValueError, match="no peak FLOP/s known"):
        ttel.peak_flops_per_chip(setup["dtype"], "cuda")
    assert ttel.peak_flops_per_chip(setup["dtype"], "cpu") is None


def test_device_memory_peaks_on_the_cpu():
    assert ttel.device_memory_peaks("cpu") == {"cpu": {}}
    assert "no allocator statistics" in tmeters.device_memory_report("cpu")


# --- TensorBoard ---------------------------------------------------------

def _crc32c_bitwise(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _records(path):
    """Each record's payload, checking both masked CRC32Cs with a bitwise
    CRC32C (not the writer's table)."""
    def masked(data):
        c = _crc32c_bitwise(data)
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    raw, out, off = open(path, "rb").read(), [], 0
    while off < len(raw):
        header = raw[off:off + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", raw[off + 8:off + 12])[0] == masked(header)
        payload = raw[off + 12:off + 12 + n]
        assert struct.unpack("<I", raw[off + 12 + n:off + 16 + n])[0] == \
            masked(payload)
        out.append(payload)
        off += 16 + n
    return out


def _fields(buf: bytes):
    """(field number, value) pairs of a protobuf message: ints for varints,
    bytes for the rest."""
    def varint(k):
        n = shift = 0
        while True:
            b = buf[k]
            n |= (b & 0x7F) << shift
            k, shift = k + 1, shift + 7
            if not b & 0x80:
                return n, k

    k = 0
    while k < len(buf):
        key, k = varint(k)
        wire = key & 7
        if wire == 0:
            val, k = varint(k)
        elif wire == 1:
            val, k = buf[k:k + 8], k + 8
        elif wire == 5:
            val, k = buf[k:k + 4], k + 4
        else:
            n, k = varint(k)
            val, k = buf[k:k + n], k + n
        yield key >> 3, val


def _tags(path):
    """The tags of a ScalarWriter file (Event.summary.value.tag)."""
    tags = set()
    for payload in _records(path)[1:]:
        for field, summary in _fields(payload):
            if field == 5:
                for _, value in _fields(summary):
                    tags.update(v.decode() for f, v in _fields(value)
                                if f == 1)
    return tags


def test_scalar_writer_writes_pipe_tpus_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(ttb.time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(ttb.socket, "gethostname", lambda: "host")
    files = []
    for mod, name in ((jtb, "j"), (ttb, "t")):
        with mod.ScalarWriter(str(tmp_path / name)) as w:
            for i, (tag, val) in enumerate([("train/loss", 3.25),
                                            ("eval/loss", -1e-3),
                                            ("telemetry/mfu", 0.4321)]):
                w.add_scalar(tag, val, step=i * 7, wall_time=1e9 + i)
            w.add_scalar("train/lr", 5.0, step=-1)
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    assert len(_records(files[1])) == 5
    assert _tags(files[1]) == {"train/loss", "eval/loss", "telemetry/mfu",
                               "train/lr"}
    with pytest.raises(ValueError, match="closed"):
        w.add_scalar("x", 1.0, step=0)


# --- bubble arithmetic -----------------------------------------------------

def test_merge_intervals_match_pipe_tpu():
    rng = np.random.default_rng(0)
    for _ in range(20):
        starts = rng.uniform(0, 100, size=12)
        ivs = [(float(s), float(s + d)) for s, d in
               zip(starts, rng.uniform(0, 15, size=12))]
        assert tmeters._merge_intervals(ivs) == jmeters._merge_intervals(ivs)
        assert tmeters._merge_busy_ns(ivs) == jmeters._merge_busy_ns(ivs)


@pytest.mark.parametrize("t_ref,m_ref,t_other,m_other", [
    (1.0, 4, 1.6, 8), (2.0, 8, 1.4, 4), (1.0, 4, 0.9, 8), (0.0, 4, 1.0, 8),
    (1.0, 4, 2.0, 4)])
def test_measured_bubbles_match_pipe_tpu(t_ref, m_ref, t_other, m_other):
    assert tmeters.measured_bubble_two_point(t_ref, m_ref, t_other,
                                             m_other) == \
        jmeters.measured_bubble_two_point(t_ref, m_ref, t_other, m_other)
    assert tmeters.measured_bubble_slope(t_ref, t_other, m_ref) == \
        jmeters.measured_bubble_slope(t_ref, t_other, m_ref)


@pytest.mark.parametrize("schedule", [None, "1f1b", "interleaved-1f1b"])
def test_bubble_meter_matches_pipe_tpu(schedule):
    kw = {} if schedule is None else {"interleave": 2}
    ts = None if schedule is None else get_schedule(
        schedule, **(kw if schedule.startswith("interleaved") else {}))
    js = None if schedule is None else jget_schedule(
        schedule, **(kw if schedule.startswith("interleaved") else {}))
    t = tmeters.BubbleMeter(chunks=8, n_stages=4, schedule=ts)
    j = jmeters.BubbleMeter(chunks=8, n_stages=4, schedule=js)
    assert t.analytic == j.analytic and t.report() == j.report()
    for busy, wall in (([1.0] * 4, 1.0), ([0.5, 0.2, 0.3, 0.1], 0.7),
                       ([], 0.0)):
        assert t.measured(busy, wall) == j.measured(busy, wall)


# --- traces ----------------------------------------------------------------

def _tiny_pipe(chunks=2, n_stages=2, checkpoint="except_last"):
    cfg = tlm.LMConfig().tiny()
    seq = tlm.build_sequential(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return Pipe(seq, chunks=chunks, n_stages=n_stages, checkpoint=checkpoint,
                device="cpu"), cfg


def test_profile_trace_on_the_cpu_gives_the_host_timeline(tmp_path):
    pipe, cfg = _tiny_pipe(chunks=4)
    x = torch.randint(0, cfg.vocab, (8, cfg.seq_len))
    with tmeters.profile_trace(str(tmp_path)) as d:
        pipe(x, train=True, seed=1).sum().backward()
    assert d == str(tmp_path) and (tmp_path / "trace.json").exists()
    tl = tmeters.stage_timeline_from_trace(str(tmp_path))
    assert tl["source"] == "host"
    assert sorted(tl["stages"]) == [0, 1]
    for st in tl["stages"].values():
        assert sorted(st["chunks"]) == [0, 1, 2, 3]
        assert st["busy_sec"] > 0
        assert st["intervals"] == tmeters._merge_intervals(st["intervals"])
    lo, hi = tl["span"]
    assert sum(s["busy_sec"] for s in tl["stages"].values()) <= \
        (hi - lo) / 1e9 + 1e-9
    # each task's forward and (while profiling) its backward
    names = [e["name"] for e in json.load(open(tmp_path / "trace.json"))[
        "traceEvents"] if e.get("cat") == "user_annotation"]
    assert len(names) == 2 * 4 * 2
    assert tmeters.stage_busy_from_trace(str(tmp_path)) == {"_span": 0.0}


def test_backward_ranges_only_while_profiling():
    pipe, cfg = _tiny_pipe()
    x = torch.randint(0, cfg.vocab, (4, cfg.seq_len))
    out = pipe(x, train=True, seed=1)
    # no marker node: the output's grad_fn is the gather's, not the marker's
    fn = out.grad_fn
    seen = set()
    stack = [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        assert "BackwardRange" not in type(f).__name__
        stack.extend(g for g, _ in f.next_functions)
    values = (torch.ones(2, requires_grad=True),)
    assert tmeters.mark_backward(values, 0, 0) is values


def _write_trace(path, events):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def test_stage_timeline_from_a_cuda_trace(tmp_path):
    """gpu_user_annotation ranges attribute the kernels inside them; the
    kernel outside every range counts as device busy time only."""
    events = [
        _x("gpu_user_annotation", "chunk0-stage0", 0, 30),
        _x("kernel", "k0", 0, 10), _x("kernel", "k1", 12, 8),
        _x("gpu_memcpy", "m", 22, 5),
        _x("gpu_user_annotation", "chunk0-stage1", 40, 25),
        _x("kernel", "k2", 40, 20),
        _x("gpu_user_annotation", "chunk1-stage1", 70, 10),
        _x("kernel", "k3", 70, 5), _x("gpu_memset", "s", 76, 2),
        _x("kernel", "k4", 90, 5),
        _x("user_annotation", "chunk0-stage0", 0, 5, pid=1, tid=1),
    ]
    _write_trace(str(tmp_path), events)
    tl = tmeters.stage_timeline_from_trace(str(tmp_path))
    assert tl["source"] == "cuda"
    assert tl["stages"][0]["busy_sec"] == pytest.approx(23e-6)
    assert tl["stages"][1]["busy_sec"] == pytest.approx(27e-6)
    assert tl["stages"][1]["chunks"] == pytest.approx({0: 20e-6, 1: 7e-6})
    assert tl["span"] == (0.0, 78_000.0)
    busy = tmeters.stage_busy_from_trace(str(tmp_path))
    assert busy["cuda:0"] == pytest.approx(55e-6)
    assert busy["_span"] == pytest.approx(95e-6)


def test_stage_timeline_device_trace_without_annotations_reads_host(tmp_path):
    """Device events but no gpu_user_annotation range: the device time
    cannot be attributed, so the tagged host ranges are read and the
    source says so; the table executor's op ranges count as stages too."""
    events = [
        _x("user_annotation", "chunk0-stage0", 0, 10, pid=1, tid=1),
        _x("user_annotation", "table:B1-stage1", 20, 10, pid=1, tid=1),
        _x("user_annotation", "outer", 0, 40, pid=1, tid=1),
        _x("kernel", "a", 5, 4), _x("kernel", "b", 25, 6),
    ]
    _write_trace(str(tmp_path), events)
    tl = tmeters.stage_timeline_from_trace(str(tmp_path))
    assert tl["source"] == "host"
    assert {j: s["busy_sec"] for j, s in tl["stages"].items()} == \
        pytest.approx({0: 10e-6, 1: 10e-6})
    assert tl["stages"][1]["chunks"] == pytest.approx({1: 10e-6})
    assert tmeters.stage_busy_from_trace(str(tmp_path))["cuda:0"] == \
        pytest.approx(10e-6)


def test_stage_timeline_without_tagged_events(tmp_path):
    _write_trace(str(tmp_path), [_x("cpu_op", "aten::mm", 0, 5)])
    assert tmeters.stage_timeline_from_trace(str(tmp_path)) == \
        {"source": None, "span": (0.0, 0.0), "stages": {}}
    with pytest.raises(FileNotFoundError):
        tmeters.stage_timeline_from_trace(str(tmp_path / "none"))


# --- the trainer with telemetry --------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    lines = lm_text.synthetic_corpus(20_000, 99, seed=5)
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, lines))
    return lm_text.batchify(lm_text.data_process(lines, vocab), 8)


def _losses_of(trainer):
    """Record the loss of each step the trainer takes."""
    got = []
    step = trainer._step

    def recording(*a):
        got.append(step(*a))
        return got[-1]

    trainer._step = recording
    return got


def test_trainer_telemetry_matches_pipe_tpu(tmp_path, corpus):
    """Four steps with telemetry_dir, tb_dir and profile_every=2: the port
    writes the event kinds, StepReport keys and TensorBoard tags pipe_tpu's
    trainer writes (MFU/HFU only where a card gives a peak: pipe_tpu assumes
    a v5e on the CPU), one StepReport a step with memory at the logged and
    first steps, a Chrome trace at steps 2 and 4, and the same losses, bit
    for bit, as the run without telemetry."""
    jmodel = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=2)
    model = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2)
    base = dict(batch_size=8, eval_batch_size=8, bptt=model.seq_len,
                chunks=2, n_stages=2, lr=1e-2)
    obs = dict(telemetry_dir=str(tmp_path / "{}" / "t"),
               tb_dir=str(tmp_path / "{}" / "tb"), profile_every=2)

    def run(pkg_loop, name, with_obs, **extra):
        kw = dict(base, **{k: v.format(name) if isinstance(v, str) else v
                           for k, v in obs.items()}) if with_obs else base
        cfg = pkg_loop.TrainerConfig(**kw)
        if pkg_loop is jloop:
            tr = jloop.Trainer(jmodel, cfg)
        else:
            tr = tloop.Trainer(model, cfg, device="cpu")
        losses = _losses_of(tr) if pkg_loop is tloop else None
        state, info = tr.train_epoch(corpus, max_steps=4, log_every=2,
                                     log_fn=lambda s: None)
        tr.evaluate(corpus, state, max_steps=1)
        return losses, info

    run(jloop, "j", True)
    plain, _ = run(tloop, "plain", False)
    seen, info = run(tloop, "t", True)
    assert [float(x) for x in seen] == [float(x) for x in plain]
    assert not (tmp_path / "plain").exists()

    jev = EventLog.read(str(tmp_path / "j" / "t" / "events.jsonl"))
    tev = EventLog.read(str(tmp_path / "t" / "t" / "events.jsonl"))
    assert {e["kind"] for e in jev} <= {e["kind"] for e in tev}
    jrep = [e for e in jev if e["kind"] == "step_report"]
    trep = [e for e in tev if e["kind"] == "step_report"]
    assert len(trep) == len(jrep) == 4
    for j, t in zip(jrep, trep):
        assert set(j) <= set(t) and t["n_devices"] == 1
        assert (j["step"], j["tokens"], j["compile_inclusive"]) == \
            (t["step"], t["tokens"], t["compile_inclusive"])
        assert (j["final_loss"] is None) == (t["final_loss"] is None)
        assert bool(j["memory"]) == bool(t["memory"])
    assert [t["memory"] for t in trep if t["memory"]] == [{"cpu": {}}] * 3
    walls = sum(t["wall_sec"] for t in trep[1:])
    assert walls == pytest.approx(info["sec_per_step"] * 3, rel=0.5)
    for e in (jev, tev):
        traced = [x["step"] for x in e if x["kind"] == "profile_trace"]
        assert traced == [1, 3]
    assert all(os.path.exists(os.path.join(tmp_path, "t", "t",
                                           f"trace_step{s}", "trace.json"))
               for s in (2, 4))

    def tb_file(name):
        d = tmp_path / name / "tb"
        return str(d / os.listdir(d)[0])

    jtags = _tags(tb_file("j"))
    assert _tags(tb_file("t")) == jtags - {"telemetry/mfu", "telemetry/hfu"}
    assert {"eval/loss", "train/epoch_loss", "train/loss",
            "pipeline/bubble", "telemetry/ms_step"} <= jtags


def test_trainer_telemetry_from_pipe_tpus_weights_tracks_its_losses(
        tmp_path, corpus):
    """From pipe_tpu's initial weights, the telemetry-on trainers log the
    same losses in their StepReports (dropout 0, fp32)."""
    jmodel = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=2)
    model = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2)
    kw = dict(batch_size=8, eval_batch_size=8, bptt=model.seq_len, chunks=2,
              n_stages=2, lr=1e-2)
    jtr = jloop.Trainer(jmodel, jloop.TrainerConfig(
        telemetry_dir=str(tmp_path / "j"), **kw))
    jstate = jtr.init_state()
    import jax
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    jtr.train_epoch(corpus, state=jstate, max_steps=3, log_every=1,
                    log_fn=lambda s: None)
    tr = tloop.Trainer(model, tloop.TrainerConfig(
        telemetry_dir=str(tmp_path / "t"), **kw), device="cpu")
    state = tr.init_state()
    convert.load_pipelined_lm_params(tr.pipe, params)
    tr.train_epoch(corpus, state=state, max_steps=3, log_every=1,
                   log_fn=lambda s: None)

    def losses(d):
        return [e["final_loss"] for e in EventLog.read(
            os.path.join(d, "events.jsonl")) if e["kind"] == "step_report"]

    np.testing.assert_allclose(losses(str(tmp_path / "t")),
                               losses(str(tmp_path / "j")), atol=2e-4)
