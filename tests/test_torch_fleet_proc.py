"""The port's process fleet (``pipe_tpu_torch/fleet/proc.py``) and the fleet
CLI, on the CPU.

* The wire: frames byte-equal to ``pipe_tpu``'s for the same message under
  msgpack and under the JSON fallback (forced by patching ``HAVE_MSGPACK`` in
  both modules), CRC rejects, sequence dedup, and ``apply_wire_chaos`` equal
  to ``pipe_tpu``'s.
* Real children: one module fixture spawns two CPU replicas, both ends
  forced onto the JSON codec (the parent's ``HAVE_MSGPACK`` patched, and the
  children given a ``msgpack`` that fails to import, first on their
  ``PYTHONPATH``), as the card's machine runs them. Four tests reuse them:
  place/poll with the child's tokens equal to an in-process engine built from
  the same spec, the KV handoff from one child to the other, a response that
  arrives before its place reply, and a SIGKILL failover delivering every id
  once (that test respawns the child it kills).
  Each wait has its own deadline, so a hung child fails its test.
* The CLI: ``--replicas 2 --fleet inproc|thread`` prints the single engine's
  streams.
"""

import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu.fleet.proc as jproc
from pipe_tpu.resilience import ChaosPlan as JPlan
from pipe_tpu.resilience import Fault as JFault
from pipe_tpu_torch.apps import serve as serve_app
from pipe_tpu_torch.fleet import (HEALTHY, RETIRED, FleetController,
                                  ProcessReplicaTransport, ReplicaSpec,
                                  RouterPolicy)
from pipe_tpu_torch.fleet import proc as tproc
from pipe_tpu_torch.resilience import ChaosPlan, Fault
from pipe_tpu_torch.serve import RequestQueue

CFG = dict(vocab=61, d_model=16, nhead=2, d_ff=32, n_layers=2, seq_len=64,
           dropout=0.0)
WAIT_S = 60.0

MESSAGES = [
    {"op": "hello", "token": "abc"},
    {"op": "place", "rpc": 3, "id": 7, "prompt": [1, 2, 3],
     "max_new_tokens": 4, "seed": 9, "priority": 0, "remaining_s": None,
     "age_s": 0.25, "attempts": 1, "trace": "f00d"},
    {"op": "reply", "rpc": 5, "error": ["ValueError", "bad — request"]},
    {"op": "response", "id": 4, "tokens": [5, 6], "status": "ok",
     "finish_reason": "length", "prompt_len": 3, "ttft": 0.125,
     "latency": 1.5},
    {"op": "reply", "rpc": 9, "value": {
        "hashes": ["ab" * 32], "block_size": 8, "n_layers": 2,
        "codec": "int8", "int8_storage": False, "nbytes": 96,
        "arrays": {"k": np.arange(-24, 24, dtype=np.int8).reshape(
                       2, 1, 3, 2, 4),
                   "k_scale": np.linspace(0.1, 1.0, 12, dtype=np.float32
                                          ).reshape(2, 1, 3, 2, 1)}}},
    {"op": "obs", "seq": 2, "metrics": {
        "serve.engine.ttft_sec": {"k": "h", "b": [[3, 2], [7, 1]], "dn": 3,
                                  "ds": 0.5, "min": 0.01, "max": 0.3},
        "serve.engine.tokens": {"k": "c", "d": 12}},
     "events": [{"kind": "request", "request": 1, "t": 0.5}],
     "dropped": 0, "blob": b"\x00\x01\xff"},
]


@pytest.fixture(params=["msgpack", "json"])
def codec(request, monkeypatch):
    if request.param == "msgpack" and not tproc.HAVE_MSGPACK:
        pytest.fail("msgpack is installed here; the port must find it")
    for mod in (tproc, jproc):
        monkeypatch.setattr(mod, "HAVE_MSGPACK", request.param == "msgpack")
    return request.param


def test_frames_byte_equal_pipe_tpu(codec):
    for seq, msg in enumerate(MESSAGES):
        want = jproc._frame(jproc._pack(msg), seq)
        got = tproc._frame(tproc._pack(msg), seq)
        assert got == want, msg["op"]
        back = tproc._unpack(tproc._pack(msg))
        ref = jproc._unpack(jproc._pack(msg))
        assert json.dumps(back, default=repr, sort_keys=True) == \
            json.dumps(ref, default=repr, sort_keys=True)
    arrays = tproc._unpack(tproc._pack(MESSAGES[4]))["value"]["arrays"]
    np.testing.assert_array_equal(arrays["k"],
                                  MESSAGES[4]["value"]["arrays"]["k"])
    assert arrays["k_scale"].dtype == np.float32


def test_crc_reject_and_sequence_dedup(codec):
    a, b = socket.socketpair()
    try:
        frame = tproc._frame(tproc._pack({"op": "place", "id": 9}), 1)
        plan = ChaosPlan([Fault("wire_corrupt", step=0, count=1)])
        frames, hold = tproc.apply_wire_chaos(plan, 0, frame)
        assert hold == 0.0 and frames[0] != frame
        a.sendall(frames[0])
        with pytest.raises(tproc.FrameCorrupt):
            tproc.recv_frame(b)
        dup = ChaosPlan([Fault("wire_dup", step=0, count=1)])
        frames, _ = tproc.apply_wire_chaos(dup, 0, frame)
        assert frames == [frame, frame]
        for f in frames:
            a.sendall(f)
        seen, taken = 0, []
        for _ in frames:
            msg = tproc.recv_frame(b)
            seq = msg.pop("_seq")
            if seq > seen:
                seen = seq
                taken.append(msg["id"])
        assert taken == [9]
        tproc.send_frame(a, {"op": "hb"})
        assert "_seq" not in tproc.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_apply_wire_chaos_matches_pipe_tpu():
    faults = [("wire_corrupt", dict(step=1, count=2, stage=1)),
              ("wire_dup", dict(step=2, count=2, stage=1)),
              ("wire_partition", dict(step=5, stage=0, magnitude=1e9)),
              ("wire_partition", dict(step=6, stage=1, magnitude=0.5)),
              ("wire_delay", dict(step=0, stage=0, magnitude=0.0))]
    tplan = ChaosPlan([Fault(k, **kw) for k, kw in faults])
    jplan = JPlan([JFault(k, **kw) for k, kw in faults])
    frame = tproc._frame(tproc._pack({"op": "cancel", "id": 1}), 4)
    for idx in range(8):
        for rep in range(2):
            assert tproc.apply_wire_chaos(tplan, idx, frame, rep) == \
                jproc.apply_wire_chaos(jplan, idx, frame, rep)
    assert tproc.apply_wire_chaos(None, 0, frame) == ([frame], 0.0)


def test_spawn_env_and_capability():
    env = tproc._spawn_env(repo_root="/r")
    assert env["PYTHONPATH"] == "/r"
    # the parent's environment otherwise: no JAX variable is set
    assert {k: v for k, v in env.items() if k != "PYTHONPATH"} == {
        k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    tproc.check_spawn_capability()
    with pytest.raises(tproc.FleetSpawnError) as e:
        tproc.check_spawn_capability("/nonexistent/python3")
    assert "--fleet inproc" in str(e.value)
    assert ReplicaSpec(lm_cfg={}).device == "cuda"


# ---------------------------------------------------------------------------
# real children, JSON codec on both ends


def _spec(**kw):
    base = dict(lm_cfg=dict(CFG), num_slots=2, max_len=48, init_seed=0,
                gen=dict(max_new_tokens=8, temperature=0.0),
                decode_chunk=1, heartbeat_interval_s=0.05, kv_block_size=8,
                kv_pool_blocks=24, prefill_chunk=8, device="cpu")
    base.update(kw)
    return ReplicaSpec(**base)


def _spawn(n):
    out, errs = [None] * n, []

    def one(i):
        try:
            out[i] = ProcessReplicaTransport(_spec(), connect_timeout_s=WAIT_S,
                                             rpc_timeout_s=WAIT_S)
        except Exception as e:             # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S + 10)
    if errs or any(t is None for t in out):
        for t in out:
            if t is not None:
                t.close()
        raise errs[0] if errs else RuntimeError("a child never came up")
    return out


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    stub = tmp_path_factory.mktemp("no_msgpack")
    (stub / "msgpack.py").write_text(
        "raise ImportError('msgpack is hidden from this child')\n")
    orig_env = tproc._spawn_env

    def env(repo_root=None):
        e = orig_env(repo_root)
        e["PYTHONPATH"] = str(stub) + os.pathsep + e["PYTHONPATH"]
        # one intra-op thread a child: the tiny model gains nothing from
        # more, and the test run shares the host's cores
        e["OMP_NUM_THREADS"] = "1"
        return e

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproc, "HAVE_MSGPACK", False)
        mp.setattr(tproc, "_spawn_env", env)
        trs = _spawn(2)
        try:
            yield trs
        finally:
            for tr in trs:
                tr.close()


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _poll_one(tr, rid):
    got = []
    _wait(lambda: got.extend(tr.poll()) or any(r.request_id == rid
                                               for r in got), f"id {rid}")
    return next(r for r in got if r.request_id == rid)


def _prompt(n, k=7):
    return [(i * k) % 53 + 1 for i in range(n)]


def test_child_serves_like_an_in_process_engine(children):
    """A child on the JSON codec serves a request with the tokens an
    engine built in this process from the same spec gives."""
    tr = children[0]
    st = tr._rpc({"op": "status"})
    assert st["codec"] == "json" and st["peak_bytes"] is None
    q = RequestQueue()
    prompt = _prompt(20)
    req = q.submit(prompt, max_new_tokens=6, seed=3)
    tr.place(req)
    resp = _poll_one(tr, req.id)
    assert resp.status == "ok" and len(resp.tokens) == 6
    eng = tproc._build_engine(_spec())
    eng.submit(prompt, max_new_tokens=6, seed=3)
    (ref,) = eng.run_until_idle()
    assert list(resp.tokens) == list(ref.tokens)
    h = tr.health()
    assert h.alive and h.heartbeat_age_s < 5.0


def test_kv_handoff_between_children(children):
    """The int8 payload crosses the JSON wire intact: the export of a
    child equals the in-process export of the same prefix, and the other
    child seats every block of it."""
    a, b = children
    q = RequestQueue()
    prompt = _prompt(32, k=5)               # 4 full blocks
    req = q.submit(prompt, max_new_tokens=4, seed=0)
    a.place(req)
    assert _poll_one(a, req.id).status == "ok"
    payload = a.export_prefix(prompt)
    assert payload is not None and payload["codec"] == "int8"
    eng = tproc._build_engine(_spec())
    eng.submit(prompt, max_new_tokens=4, seed=0)
    eng.run_until_idle()
    ref = eng.backend.export_prefix_payload(prompt, codec="int8")
    assert payload["hashes"] == ref["hashes"]
    for name, arr in ref["arrays"].items():
        np.testing.assert_array_equal(payload["arrays"][name], arr)
    n = len(payload["hashes"])
    assert b.cached_prefix_blocks(prompt) == 0
    assert b.import_prefix(payload) == n
    assert b.cached_prefix_blocks(prompt) == n
    req2 = q.submit(prompt, max_new_tokens=4, seed=0)
    b.place(req2)
    assert _poll_one(b, req2.id).status == "ok"


def test_response_that_beats_its_place_reply_is_delivered(children,
                                                          monkeypatch):
    """A one-token request can finish in the child and its response frame
    arrive before the place RPC's caller wakes up: the transport registers
    the request in flight before the RPC, so the response is delivered
    (registered after it, the frame would be dropped as unknown)."""
    tr = children[0]
    real = tr._rpc

    def slow_return(msg, *a, **k):
        value = real(msg, *a, **k)
        if msg.get("op") == "place":
            time.sleep(0.3)            # the child answers meanwhile
        return value

    monkeypatch.setattr(tr, "_rpc", slow_return)
    q = RequestQueue()
    req = q.submit(_prompt(9), max_new_tokens=1, seed=0)
    tr.place(req)
    resp = _poll_one(tr, req.id)
    assert resp.status == "ok" and len(resp.tokens) == 1
    assert req.attempts == 1


def test_sigkill_failover_delivers_every_id_once(children):
    """SIGKILL one child while it holds work: the controller retires it,
    re-places what it held, and delivers every id once, ``ok``. The test
    respawns the child it killed."""
    ctl = FleetController(list(children), RequestQueue(capacity=64),
                          policy=RouterPolicy(backoff_base_s=0.0,
                                              heartbeat_timeout_s=5.0))
    victim = children[1]
    ids = [ctl.submit(_prompt(10 + i % 5, k=3 + i), max_new_tokens=6,
                      seed=i).id for i in range(8)]
    delivered = []
    deadline = time.monotonic() + WAIT_S
    while not victim._inflight:
        delivered.extend(ctl.tick())
        if ctl.idle:
            ids += [ctl.submit(_prompt(12), max_new_tokens=6, seed=99).id]
        assert time.monotonic() < deadline, "victim never got work"
    os.kill(victim._proc.pid, signal.SIGKILL)
    deadline = time.monotonic() + WAIT_S
    while not ctl.idle:
        delivered.extend(ctl.tick())
        time.sleep(0.005)
        assert time.monotonic() < deadline, "fleet never went idle"
    assert sorted(r.request_id for r in delivered) == sorted(ids)
    assert all(r.status == "ok" for r in delivered)
    assert [r.state for r in ctl.replicas] == [HEALTHY, RETIRED]
    victim.close()
    children[1] = _spawn(1)[0]


# ---------------------------------------------------------------------------
# the CLI


def _streams(capsys, argv):
    assert serve_app.main(["--tiny", "--device", "cpu", "--requests", "6",
                           "--max-new", "6", "--slots", "2"] + argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines]
    summary = rows.pop()["summary"]
    return {r["request"]: (r["status"], r["tokens"]) for r in rows}, summary


@pytest.mark.parametrize("fleet", ["inproc", "thread"])
def test_cli_fleet_prints_the_single_engines_streams(capsys, fleet):
    single, _ = _streams(capsys, [])
    got, summary = _streams(capsys, ["--replicas", "2", "--fleet", fleet,
                                     "--tick-budget-s", "10"])
    assert got == single
    assert summary["backend"] == f"Fleet[{fleet}](SingleDeviceSlotBackend x 2)"
    assert summary["fleet"]["reconcile"]["reconciled"]
    assert summary["slo"]["ok"]
