"""Process replicas: each fleet replica a real OS process on a wire.

Counterpart of ``pipe_tpu/fleet/proc.py``. The other half of the transport
split (:mod:`.control` is the transport-agnostic control plane):
:class:`ProcessReplicaTransport` spawns ``python -m
pipe_tpu_torch.fleet.proc`` as a fresh interpreter that owns its OWN
engine, captured graphs and KV pool on its device (``ReplicaSpec.device``:
``cuda`` unless the spec says ``cpu``) — the process boundary is the
isolation the in-process fleet can't give (a wedged replica's GIL, a
poisoned CUDA context, a leaked device buffer die with their process).
The child builds the tutorial LM from ``ReplicaSpec.lm_cfg`` with weights
drawn from ``init_seed`` by a ``torch.Generator`` on its device, as
``build_sequential`` draws them for any caller of that seed.

Without msgpack both ends fall back to JSON: ndarrays and bytes travel as
base64 (4/3 of their size), tuples arrive as lists and integer dict keys as
strings. Every message of this protocol is built from lists and
string-keyed dicts, so both codecs deliver the same values. Both ends must
use the same codec: they do not negotiate one. The child reports its codec
(``codec``) with its device peak (``peak_bytes``) in the ``status`` reply.

Wire protocol
-------------
Length-prefixed frames over one loopback TCP connection per replica
(the child connects back to the parent's listener, so the parent never
needs to guess a child port, and reconnect is child-initiated):

* frame = 4-byte big-endian length + 4-byte CRC32 + 4-byte sequence
  number + payload (the length covers crc+seq+payload). The CRC is
  over seq+payload: a corrupt frame raises :class:`FrameCorrupt` and
  is treated as a broken CONNECTION — drop, re-dial, replay — never a
  half-parsed RPC. Sequence numbers are per-direction monotonic
  (``seq=0`` marks unsequenced control frames: hello/spec/ready/
  shutdown and the lossy heartbeat stream); a receiver suppresses
  ``seq <= last_seen``, so frames replayed after a reconnect — the
  parent's pending-RPC replay, the child's retained-response replay —
  and chaos-duplicated frames are deduplicated instead of
  double-delivered;
* payload = msgpack (JSON + base64 fallback when msgpack is absent)
  of one message dict; numpy arrays ride an explicit
  ``{"__nd__": dtype, shape, data}`` envelope, so KV-handoff payloads
  (int8 codes + f32 scales) cross the wire without pickling;
* messages: parent→child **ops** (``place``/``cancel``/``evict``/
  ``drain``/``export_prefix``/``import_prefix``/``invalidate_prefix``/
  ``cached_prefix``/``shutdown``), each carrying an ``rpc`` id the
  child echoes in its ``reply`` (value or ``error=[type, msg]``, so
  ``QueueFull``/``EngineDraining``/``ValueError`` re-raise with their
  in-process semantics); child→parent **responses** (terminal
  :class:`~..serve.queue.Response` records, streamed as they finish)
  and **heartbeats** (the health signals the controller's state
  machine runs on — ``slow_streak``, ``miss_ewma``, ``stuck_slots``,
  ``consecutive_decode_errors`` — plus depth/live/idle/drained, every
  ``heartbeat_interval_s`` whether or not anything else moved).

Clock domains: the parent and child clocks are unrelated, so deadlines
NEVER cross the wire absolute — ``place`` ships ``remaining_s`` (time
left) and ``age_s`` (time since submit) and the child re-anchors both
on its own monotonic clock. Reconnect: a dropped connection is retried
by the child against the same listener for ``reconnect_timeout_s``;
the parent re-sends still-pending RPC frames on the new connection
(counted in ``rpc_retries``). Past the window the transport reports
dead and every call raises :class:`~.control.TransportError` — the
controller then reclaims the in-flight requests from its OWN ledger
(the authoritative map; a late response for a reclaimed id is dropped
here, never delivered twice).

Per-RPC deadlines: inside the total ``rpc_timeout_s`` window, ``_rpc``
re-sends its frame on an exponential-backoff schedule
(``rpc_retry_base_s`` doubling up to ``rpc_retry_max_s``, jittered
deterministically from the rpc id) — a frame lost to a delay spike or
a partition recovers without waiting out the whole window, and the
re-sent frame carries the SAME sequence number, so the child either
suppresses it or re-serves the cached reply.

Adversarial wire chaos: pass a :class:`~..resilience.chaos.ChaosPlan`
with ``wire_partition``/``wire_delay``/``wire_corrupt``/``wire_dup``
faults (indexed by OUTGOING parent frame count, replica-addressed via
``Fault.stage``) and the transport injects them at the framing layer —
see :func:`apply_wire_chaos`.

Controller restart: ``rejoin={"port", "token", "pid", ...}`` (from
:meth:`ProcessReplicaTransport.rejoin_info`, journaled at spawn)
re-binds the SAME listener port with the SAME token and adopts the
*running* child instead of spawning — the child's ordinary reconnect
loop re-dials the reborn listener and replays its retained response
frames. Responses for ids the new parent has not adopted yet are
buffered (``adopt``/``seal_rejoin``) so the journal's recovery pass
can salvage work that finished while no controller was alive.

The child ticks ITSELF — the async-tick contract. The controller's
``poll()`` just drains what the reader thread buffered.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.telemetry import MetricsRegistry, get_registry
from ..serve.queue import Request, Response
from .control import ReplicaHealth, ReplicaTransport, TransportError

try:
    import msgpack
    HAVE_MSGPACK = True
except Exception:                                 # pragma: no cover
    msgpack = None
    HAVE_MSGPACK = False

__all__ = ["ProcessReplicaTransport", "ReplicaSpec", "FleetSpawnError",
           "FrameCorrupt", "apply_wire_chaos", "check_spawn_capability"]


class FleetSpawnError(RuntimeError):
    """The platform cannot launch child processes — raised BEFORE
    any replica process is attempted, with the remedy in the message."""


@dataclasses.dataclass
class ReplicaSpec:
    """Everything a child process needs to build its replica engine —
    plain data only (it crosses the wire as the handshake frame). The
    child draws ``build_sequential(LMConfig(**lm_cfg))``'s weights on
    ``device`` from a ``torch.Generator`` seeded ``init_seed`` (replica
    homogeneity: every replica, and any caller building the same config
    from the same seed on the same device, holds the same weights), wraps
    them as ``PipelinedLM`` of ``n_stages``, and wraps a
    :class:`~..serve.engine.SingleDeviceSlotBackend` +
    :class:`~..serve.engine.ServeEngine`."""

    lm_cfg: Dict[str, Any]
    n_stages: int = 1
    init_seed: int = 0
    num_slots: int = 2
    max_len: int = 96
    gen: Dict[str, Any] = dataclasses.field(default_factory=dict)
    buckets: Optional[List[int]] = None
    decode_chunk: int = 1
    # Disaggregated serving (fleet/disagg.py): the replica's phase
    # role. "mixed" (default) serves whole requests. "prefill" runs only
    # the chunked-prefill program (requests arrive clamped to
    # max_new_tokens=1 and retire at the first token); "decode" runs
    # only the resident decode loop over prefixes seated by
    # import_prefix — a decode-only engine
    # refuses prompts with no cached prefix instead of re-prefilling.
    role: str = "mixed"
    kv_block_size: Optional[int] = None
    kv_pool_blocks: Optional[int] = None
    kv_dtype: Optional[str] = None
    # KV gen-2: spill cold blocks to the child's host RAM under
    # pressure, and (when kv_hot_refs is set) advertise the prefix
    # directory + hot digests on heartbeat frames so the controller can
    # place by prefix and replicate hot nodes proactively
    kv_offload: bool = False
    kv_offload_blocks: Optional[int] = None
    kv_hot_refs: Optional[int] = None
    prefill_chunk: int = 16
    queue_capacity: int = 256
    watchdog: bool = True
    heartbeat_interval_s: float = 0.1
    # where the child's model and KV pool live: "cuda" (the port's
    # default; the child sees the parent's CUDA_VISIBLE_DEVICES) or "cpu"
    device: str = "cuda"
    # fleet observability: when True the child snapshots its registry
    # (mergeable deltas) and drains its trace-event buffer onto ``obs``
    # frames piggybacked on the heartbeat cadence; when False the child
    # runs a null registry + null event log and ships NOTHING — the
    # zero-overhead pledge, asserted by the frame census test.
    # ``obs_max_bytes`` bounds one obs frame; oversized telemetry is
    # dropped (never blocks or backs up the data plane).
    telemetry: bool = True
    obs_max_bytes: int = 65536


# ---------------------------------------------------------------------------
# spawn capability (satellite: runtime/_multiproc_check discipline)


def _spawn_env(repo_root: Optional[str] = None) -> Dict[str, str]:
    """Child environment: the parent's (``CUDA_VISIBLE_DEVICES`` passes
    through) with ``PYTHONPATH`` set to the repo root, so the fresh
    interpreter imports this package and no site hook meant for the
    parent. The child picks its device from its spec."""
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root
    return env


def check_spawn_capability(executable: Optional[str] = None, *,
                           probe: bool = False) -> None:
    """Refuse a process-transport fleet up front, with a clear error,
    when this platform cannot fork/spawn child processes (sandboxes
    without subprocess, stripped interpreters, no loopback sockets).
    ``probe=True`` additionally launches a trivial child interpreter
    (slower; the transport does it implicitly anyway on first spawn).
    Raises :class:`FleetSpawnError`; returns None when spawning looks
    possible."""
    exe = executable if executable is not None else sys.executable
    remedy = ("process-transport replicas are fresh interpreters "
              "(python -m pipe_tpu_torch.fleet.proc); run on a platform "
              "where subprocesses and loopback sockets are available, or use "
              "the in-process fleet (--fleet inproc / --fleet thread)")
    if not exe or not os.path.exists(exe):
        raise FleetSpawnError(
            f"cannot spawn child processes: python executable "
            f"{exe!r} does not exist — {remedy}")
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", 0))
        finally:
            s.close()
    except OSError as e:
        raise FleetSpawnError(
            f"cannot spawn child processes: loopback sockets are "
            f"unavailable ({e}) — {remedy}")
    if probe:
        try:
            r = subprocess.run([exe, "-c", "import sys; sys.exit(0)"],
                               env=_spawn_env(), timeout=60,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
        except (OSError, subprocess.SubprocessError) as e:
            raise FleetSpawnError(
                f"cannot spawn child processes: probe launch failed "
                f"({type(e).__name__}: {e}) — {remedy}")
        if r.returncode != 0:
            raise FleetSpawnError(
                f"cannot spawn child processes: probe interpreter "
                f"exited {r.returncode} — {remedy}")


# ---------------------------------------------------------------------------
# frame codec


def _nd_encode(obj):
    if isinstance(obj, np.ndarray):
        return {"__nd__": str(obj.dtype), "shape": list(obj.shape),
                "data": obj.tobytes()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"cannot encode {type(obj).__name__} on the wire")


def _nd_decode(d):
    if "__nd__" in d:
        data = d["data"]
        if isinstance(data, str):                 # JSON fallback: base64
            data = base64.b64decode(data)
        return np.frombuffer(data, dtype=np.dtype(d["__nd__"])).reshape(
            d["shape"]).copy()
    return d


def _pack(msg: dict) -> bytes:
    if HAVE_MSGPACK:
        return msgpack.packb(msg, default=_nd_encode, use_bin_type=True)

    def jsonable(o):                              # pragma: no cover
        if isinstance(o, np.ndarray):
            return {"__nd__": str(o.dtype), "shape": list(o.shape),
                    "data": base64.b64encode(o.tobytes()).decode()}
        if isinstance(o, bytes):
            return {"__b64__": base64.b64encode(o).decode()}
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        raise TypeError(type(o).__name__)
    return json.dumps(msg, default=jsonable).encode()


def _unpack(buf: bytes) -> dict:
    if HAVE_MSGPACK:
        return msgpack.unpackb(buf, raw=False, object_hook=_nd_decode,
                               strict_map_key=False)

    def hook(d):                                  # pragma: no cover
        if "__b64__" in d:
            return base64.b64decode(d["__b64__"])
        return _nd_decode(d)
    return json.loads(buf.decode(), object_hook=hook)


class FrameCorrupt(OSError):
    """A frame failed its CRC32. Raised by :func:`recv_frame` and
    treated by both wire ends as a broken CONNECTION — the stream is
    severed and replayed on a fresh dial, so a corrupt frame can never
    surface as a half-parsed RPC or a mangled response."""


def _frame(buf: bytes, seq: int = 0) -> bytes:
    """Wrap one packed payload: length | crc32(seq+payload) | seq |
    payload, with the length prefix covering crc+seq+payload."""
    seq_bytes = struct.pack(">I", seq)
    crc = zlib.crc32(seq_bytes + buf) & 0xFFFFFFFF
    return struct.pack(">II", 8 + len(buf), crc) + seq_bytes + buf


def send_frame(sock: socket.socket, msg: dict,
               lock: Optional[threading.Lock] = None, *,
               seq: int = 0) -> bytes:
    frame = _frame(_pack(msg), seq)
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)
    return frame


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """One frame, or None on clean EOF. Raises OSError on a broken
    connection mid-frame and :class:`FrameCorrupt` (an OSError) on a
    checksum mismatch. A nonzero sequence number is surfaced to the
    dispatcher as ``msg["_seq"]`` for duplicate suppression."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    body = _recv_exact(sock, n)
    if body is None:
        raise OSError("connection closed mid-frame")
    if n < 8:
        raise FrameCorrupt(f"frame too short for crc+seq header ({n}B)")
    (crc,) = struct.unpack(">I", body[:4])
    if zlib.crc32(body[4:]) & 0xFFFFFFFF != crc:
        raise FrameCorrupt("frame checksum mismatch")
    (seq,) = struct.unpack(">I", body[4:8])
    msg = _unpack(body[8:])
    if seq and isinstance(msg, dict):
        msg["_seq"] = seq
    return msg


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    got = 0
    while got < n:
        c = sock.recv(n - got)
        if not c:
            return None
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# adversarial wire chaos (the framing-layer injection point)


def apply_wire_chaos(plan, index: int, frame: bytes,
                     replica: int = 0) -> Tuple[List[bytes], float]:
    """Transform one OUTGOING frame per the plan's ``wire_*`` faults
    covering frame ``index`` to ``replica`` (``Fault.stage``). Returns
    ``(frames, partition_s)``:

    * ``wire_delay``   — sleep ``magnitude`` seconds first (capped 5s);
    * ``wire_corrupt`` — flip the frame's last byte AFTER the checksum
      was computed, so the receiver's CRC rejects it;
    * ``wire_dup``     — the frame twice (the receiver's sequence
      suppression must collapse them);
    * ``wire_partition`` — ``([], magnitude)``: the frame is lost with
      the connection and the caller severs the wire for ``magnitude``
      seconds (capped 30s) before accepting the re-dial.

    With no covering fault (or no plan) the frame passes untouched —
    the zero-overhead pledge at this layer is one attribute check.
    """
    if plan is None or not plan:
        return [frame], 0.0
    wire_fault = getattr(plan, "wire_fault", None)
    if wire_fault is None:
        return [frame], 0.0
    f = wire_fault("wire_partition", index, replica)
    if f is not None:
        return [], min(max(float(f.magnitude), 0.0), 30.0)
    f = wire_fault("wire_delay", index, replica)
    if f is not None:
        time.sleep(min(max(float(f.magnitude), 0.0), 5.0))
    frames = [frame]
    if wire_fault("wire_corrupt", index, replica) is not None:
        frames = [frame[:-1] + bytes([frame[-1] ^ 0xFF])]
    if wire_fault("wire_dup", index, replica) is not None:
        frames = frames * 2
    return frames, 0.0


# ---------------------------------------------------------------------------
# parent side: the transport


_ERRORS = {"QueueFull": None, "EngineDraining": None, "ValueError":
           ValueError, "PoolExhausted": None, "RuntimeError": RuntimeError}


def _raise_remote(name: str, msg: str):
    from ..serve.engine import EngineDraining
    from ..serve.kvpool import PoolExhausted
    from ..serve.queue import QueueFull
    cls = {"QueueFull": QueueFull, "EngineDraining": EngineDraining,
           "ValueError": ValueError, "PoolExhausted": PoolExhausted,
           }.get(name, RuntimeError)
    raise cls(msg)


class _ExternalChild:
    """Popen-shaped handle over a child THIS parent did not spawn — the
    controller-restart rejoin adopts a running replica process by pid.
    ``poll``/``wait``/``kill`` go through ``os.kill`` (signal 0 probes
    liveness); with no pid recorded the child is assumed alive and only
    the wire can prove otherwise."""

    def __init__(self, pid: Optional[int]):
        self.pid = pid
        self.returncode: Optional[int] = None
        self.stderr = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if self.pid is None:
            return None
        try:
            os.kill(self.pid, 0)
        except (ProcessLookupError, PermissionError):
            self.returncode = -1
            return self.returncode
        return None

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("replica-child",
                                                timeout or 0)
            time.sleep(0.02)
        return self.returncode

    def kill(self) -> None:
        if self.pid is None:
            return
        import signal
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


class ProcessReplicaTransport(ReplicaTransport):
    """One replica behind a real OS process. Spawn-time cost is a full
    interpreter, a device context and graph captures per replica — this
    transport is for fleets that run, not for unit-test churn (the tests
    spawn their children once per module)."""

    def __init__(self, spec: ReplicaSpec, *,
                 clock=None,
                 connect_timeout_s: float = 120.0,
                 rpc_timeout_s: float = 120.0,
                 reconnect_timeout_s: float = 5.0,
                 rpc_retry_base_s: float = 2.0,
                 rpc_retry_max_s: float = 30.0,
                 rpc_retry_jitter: float = 0.25,
                 executable: Optional[str] = None,
                 bind_host: Optional[str] = None,
                 advertise_host: Optional[str] = None,
                 chaos=None, chaos_replica: int = 0,
                 rejoin: Optional[dict] = None):
        if rejoin is None:
            check_spawn_capability(executable)
        self.spec = spec
        self.role = spec.role
        self.clock = clock or time.monotonic
        self._rpc_timeout_s = rpc_timeout_s
        self._reconnect_timeout_s = reconnect_timeout_s
        self._rpc_retry_base_s = rpc_retry_base_s
        self._rpc_retry_max_s = rpc_retry_max_s
        self._rpc_retry_jitter = rpc_retry_jitter
        self.rpc_inflight = 0
        self.rpc_retries = 0
        self.handoff_bytes = 0
        # wire hardening state: per-direction sequence counters, the
        # chaos injection plan, and the counters the drills gate on
        self.chaos = chaos
        self.chaos_replica = int(chaos_replica)
        self._wire_index = 0          # outgoing frame index (chaos key)
        self._partition_until = 0.0   # accept-hold horizon (wire_partition)
        # parent->child seqs fold a random per-incarnation epoch into
        # the header's high 12 bits: a restarted controller's frames
        # land under a FRESH epoch, so the child resets its dedup
        # window and reply cache instead of mistaking the new parent's
        # rpc ids for the dead parent's (stale cached replies)
        self._epoch = (int.from_bytes(os.urandom(2), "big") % 4095) + 1
        self._send_seq = 0            # parent->child sequence counter
        self._recv_seq_max = 0        # newest child response seq seen
        self.wire_crc_rejects = 0     # parent-side CRC rejections
        self.wire_dup_suppressed = 0  # frames dropped by seq dedup
        self.wire_resends = 0         # per-RPC backoff re-sends
        # controller-restart rejoin: while the window is open, response
        # frames for unknown ids are BUFFERED (they may be orphans the
        # journal recovery will adopt or salvage) instead of dropped
        self._adopt_window = rejoin is not None
        self._orphan_buf: Dict[int, dict] = {}
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, list] = {}       # rpc id -> [event, reply]
        self._pending_frames: Dict[int, bytes] = {}
        self._rpc_next = 0
        self._inflight: Dict[int, Request] = {}
        self._responses: "deque[Response]" = deque()
        self._hb: Dict[str, Any] = {}
        self._hb_at: Optional[float] = None
        self._dead: Optional[str] = None
        self._draining = False
        self._closed = False
        # shipped-telemetry state (the parent half of the obs plane):
        # merged registry of everything this child ever shipped, age of
        # the newest obs frame, child-reported drop count, and the
        # bounded child trace-event stream the observer stitches
        self.obs_tokens_out = 0
        self.obs_responses_out = 0
        self._obs_registry = MetricsRegistry()
        self._obs_at: Optional[float] = None
        self._obs_seq = -1
        self._obs_dropped = 0
        self._obs_events: "deque[dict]" = deque(maxlen=50_000)
        self._frame_census: Dict[str, int] = {}

        # The wire binds a real host/port: bind_host is the interface
        # the parent listens on (default loopback — byte-identical to
        # the loopback wire), advertise_host the address the child dials
        # back to (defaults to bind_host, or loopback for the wildcard
        # "0.0.0.0"/"::" binds, which are not dialable addresses). The
        # reconnect/replay and heartbeat machinery is address-agnostic:
        # the child re-dials whatever it was told.
        self._bind_host = bind_host or "127.0.0.1"
        if advertise_host is None:
            advertise_host = ("127.0.0.1"
                              if self._bind_host in ("0.0.0.0", "::")
                              else self._bind_host)
        self._advertise_host = advertise_host
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        bind_port = 0 if rejoin is None else int(rejoin["port"])
        try:
            self._listener.bind((self._bind_host, bind_port))
        except OSError as e:
            self._listener.close()
            raise FleetSpawnError(
                f"cannot bind the fleet wire on {self._bind_host!r}"
                f":{bind_port}: {e}")
        self._listener.listen(1)
        port = self._listener.getsockname()[1]
        if rejoin is not None:
            # controller restart: the child is already RUNNING and
            # re-dialing the port its dead parent listened on — rebind
            # it with the recorded token, adopt the process by pid, and
            # learn the engine caps over the wire instead of the
            # spec/ready handshake (the engine was built long ago)
            self._token = str(rejoin["token"])
            self._proc = _ExternalChild(rejoin.get("pid"))
            self._sock = self._accept(connect_timeout_s)
            self._reader = threading.Thread(target=self._read_loop,
                                            name="fleet-proc-reader",
                                            daemon=True)
            self._reader.start()
            st = self._rpc({"op": "status"}, timeout=connect_timeout_s)
            self.default_max_new_tokens_ = int(st["default_max_new_tokens"])
            self.queue_capacity_ = int(st["queue_capacity"])
            self.num_slots = int(st["num_slots"])
            return
        self._token = base64.b64encode(os.urandom(12)).decode()
        exe = executable if executable is not None else sys.executable
        self._proc = subprocess.Popen(
            [exe, "-m", "pipe_tpu_torch.fleet.proc",
             "--port", str(port), "--token", self._token,
             "--host", self._advertise_host],
            env=_spawn_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        try:
            self._sock = self._accept(connect_timeout_s)
            send_frame(self._sock,
                       {"op": "spec", "spec": dataclasses.asdict(spec)},
                       self._send_lock)
            ready = recv_frame(self._sock)
            if not ready or ready.get("op") != "ready":
                err = b""
                self._kill_child()
                if self._proc.stderr is not None:
                    err = self._proc.stderr.read() or b""
                raise TransportError(
                    f"replica child never became ready: {ready!r}; child "
                    f"stderr: {err.decode(errors='replace')[-2000:]}")
            self.default_max_new_tokens_ = int(
                ready["default_max_new_tokens"])
            self.queue_capacity_ = int(ready["queue_capacity"])
            self.num_slots = int(ready["num_slots"])
        except Exception:
            self._kill_child()
            raise
        self._reader = threading.Thread(target=self._read_loop,
                                        name="fleet-proc-reader",
                                        daemon=True)
        self._reader.start()

    def rejoin_info(self) -> dict:
        """Everything a future parent needs to re-register this child
        WITHOUT spawning (journaled at fleet construction): the
        listener port to rebind, the hello token, the child pid, and
        the spec to rebuild the transport around."""
        return {"port": self._listener.getsockname()[1],
                "token": self._token, "pid": self._proc.pid,
                "host": self._bind_host, "role": self.role,
                "spec": dataclasses.asdict(self.spec)}

    # -- controller-restart reconciliation ---------------------------------

    def remote_request_ids(self) -> List[int]:
        """Ask the child which request ids it currently holds (queued
        or decoding) — the reconciliation query a rejoined controller
        runs against the journal's placed-but-unanswered set."""
        st = self._rpc({"op": "status"}) or {}
        return sorted({int(i) for i in (st.get("queued") or [])} |
                      {int(i) for i in (st.get("live") or [])})

    def orphan_response_ids(self) -> List[int]:
        """Ids whose response frames arrived during the adopt window
        before any controller claimed them — already finished remotely,
        salvageable without re-running."""
        with self._state_lock:
            return sorted(self._orphan_buf)

    def adopt(self, req: Request) -> bool:
        """Adopt one orphaned request during rejoin. If its response
        is already buffered, move it onto the normal poll path (True:
        the id will deliver without re-placement); otherwise register
        it in-flight so the child's (re)shipped response frame is
        accepted instead of discarded."""
        with self._state_lock:
            msg = self._orphan_buf.pop(req.id, None)
            if msg is not None:
                self._responses.append(self._response_from(msg))
                self.obs_tokens_out += len(msg["tokens"])
                self.obs_responses_out += 1
                return True
            self._inflight[req.id] = req
            return False

    def seal_rejoin(self) -> List[Response]:
        """Close the adopt window: unknown response ids go back to
        being discarded (the exactly-once drop path). Returns any
        still-unclaimed buffered responses — journaled-terminal dups
        the controller must NOT deliver twice, or never-submitted ids
        from a torn journal tail the caller may surface."""
        out: List[Response] = []
        with self._state_lock:
            self._adopt_window = False
            for rid in sorted(self._orphan_buf):
                out.append(self._response_from(self._orphan_buf[rid]))
            self._orphan_buf.clear()
        return out

    @property
    def crc_rejects_total(self) -> int:
        """Corrupt frames rejected on BOTH ends of this wire (parent
        reader + the child's count, shipped via heartbeat)."""
        with self._state_lock:
            child = int(self._hb.get("crc_rejects", 0))
        return self.wire_crc_rejects + child

    # -- connection management -------------------------------------------

    def _accept(self, timeout_s: float) -> socket.socket:
        # accept in short slices so a child that DIED (crash, SIGKILL)
        # surfaces in ~a quarter second instead of silently eating the
        # whole connect window — a place() RPC blocked behind this is
        # inside the controller's tick loop
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                if self._proc.poll() is not None:
                    err = b""
                    if self._proc.stderr is not None:
                        err = self._proc.stderr.read() or b""
                    raise TransportError(
                        f"replica child exited rc={self._proc.returncode} "
                        f"before connecting: "
                        f"{err.decode(errors='replace')[-2000:]}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportError(
                        f"replica child did not connect within "
                        f"{timeout_s}s")
                held = self._partition_until - time.monotonic()
                if held > 0:
                    # chaos partition: refuse the re-dial for the hold.
                    # The child's connect attempts queue in the kernel
                    # listen backlog and land the instant the hold
                    # lifts, so the heal is a plain accept
                    time.sleep(min(held, 0.25, max(remaining, 0.01)))
                    continue
                try:
                    self._listener.settimeout(min(0.25, remaining))
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError as e:
                    # listener torn down by close() while we waited
                    raise TransportError(f"listener closed: {e}")
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    hello = recv_frame(conn)
                except OSError:        # corrupt/truncated hello: not ours
                    conn.close()
                    continue
                if hello and hello.get("op") == "hello" \
                        and hello.get("token") == self._token:
                    return conn
                conn.close()                      # wrong token: not ours
        finally:
            try:
                self._listener.settimeout(None)
            except OSError:
                pass

    def _chaos_send_locked(self, frame: bytes) -> None:
        """Send one parent->child frame through the chaos plan's wire
        faults. MUST be called holding ``_send_lock``. A partition
        fault drops the frame, severs the live connection and arms
        ``_partition_until`` so ``_accept`` refuses the re-dial for the
        hold; the pending-frame replay re-sends the lost RPC when the
        wire heals."""
        index = self._wire_index
        self._wire_index += 1
        frames, partition_s = apply_wire_chaos(
            self.chaos, index, frame, self.chaos_replica)
        if partition_s > 0:
            self._partition_until = time.monotonic() + partition_s
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise OSError("chaos wire partition")
        for f in frames:
            self._sock.sendall(f)

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                msg = recv_frame(self._sock)
                if msg is None:
                    raise OSError("EOF")
            except FrameCorrupt as e:
                # a corrupt frame poisons the stream boundary: the only
                # safe resync is a fresh connection. Count it, sever,
                # and fall into the reconnect+replay path — the RPC it
                # carried (either direction) is replayed, never
                # half-parsed
                if self._closed:
                    return
                self.wire_crc_rejects += 1
                get_registry().counter(
                    "serve.fleet.wire_crc_rejects").inc()
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                if not self._reconnect():
                    if not self._closed:
                        self._mark_dead(
                            f"corrupt frame ({e}) and reconnect "
                            f"window expired")
                    return
                continue
            except OSError as e:
                if self._closed:
                    return
                if not self._reconnect():
                    if not self._closed:
                        self._mark_dead(
                            f"connection lost ({e}) and reconnect "
                            f"window expired")
                    return
                continue
            self._dispatch(msg)

    def _reconnect(self) -> bool:
        """Wait for the child to re-dial the listener; re-send pending
        RPC frames on the fresh connection (counted as retries)."""
        if self._proc.poll() is not None:
            return False
        try:
            conn = self._accept(self._reconnect_timeout_s)
        except TransportError:
            return False
        with self._send_lock:
            old, self._sock = self._sock, conn
            try:
                old.close()
            except OSError:
                pass
            with self._state_lock:
                frames = list(self._pending_frames.values())
            for frame in frames:
                try:
                    self._chaos_send_locked(frame)
                    self.rpc_retries += 1
                except OSError:
                    # the fresh wire died mid-replay (or a chaos
                    # partition severed it): report success anyway so
                    # the read loop's next recv failure routes back
                    # through _reconnect, whose _accept honors the
                    # partition hold — only an expired window or a
                    # dead child ends the recovery
                    break
        return True

    @staticmethod
    def _response_from(msg: dict) -> Response:
        return Response(
            request_id=msg["id"], tokens=list(msg["tokens"]),
            status=msg["status"], finish_reason=msg["finish_reason"],
            prompt_len=msg["prompt_len"],
            ttft=msg.get("ttft"), latency=msg.get("latency"))

    def _dispatch(self, msg: dict) -> None:
        op = msg.get("op")
        seq = int(msg.pop("_seq", 0))
        self._frame_census[op] = self._frame_census.get(op, 0) + 1
        if op == "reply":
            with self._state_lock:
                ent = self._pending.get(msg.get("rpc"))
            if ent is not None:
                ent[1] = msg
                ent[0].set()
        elif op == "response":
            # only response frames carry a child->parent wire sequence;
            # a chaos wire_dup (or the post-reconnect retained-frame
            # replay) presents already-taken seqs, suppressed here so
            # delivery stays exactly-once
            if seq:
                with self._state_lock:
                    if seq <= self._recv_seq_max:
                        self.wire_dup_suppressed += 1
                        return
                    self._recv_seq_max = seq
            rid = msg["id"]
            with self._state_lock:
                known = rid in self._inflight
                if known:
                    self._inflight.pop(rid, None)
                    self._responses.append(self._response_from(msg))
                    # delivery-synchronized per-replica accounting: the
                    # tokens rode THIS frame, so the count can never
                    # outrun (or trail) what the parent actually took —
                    # the reconciliation invariant the observer sums
                    self.obs_tokens_out += len(msg["tokens"])
                    self.obs_responses_out += 1
                elif self._adopt_window:
                    # controller-restart rejoin: ids the dead parent
                    # placed are unknown to THIS parent until the
                    # journal reconciliation adopts them — buffer
                    # instead of discarding
                    self._orphan_buf[rid] = dict(msg)
            # unknown id: the controller reclaimed it over a drop — the
            # stale record is discarded HERE so delivery stays exactly-once
        elif op == "hb":
            with self._state_lock:
                self._hb = msg
                self._hb_at = time.monotonic()
        elif op == "obs":
            events = msg.get("events") or []
            with self._state_lock:
                new_seq = int(msg.get("seq", self._obs_seq + 1))
                if new_seq <= self._obs_seq:
                    # replayed/duplicated obs frame (chaos wire_dup or
                    # reconnect): already merged, drop it
                    self.wire_dup_suppressed += 1
                    return
                self._obs_registry.merge_snapshot(msg.get("metrics") or {})
                self._obs_events.extend(events)
                self._obs_at = time.monotonic()
                self._obs_seq = new_seq
                new_dropped = int(msg.get("dropped", 0))
                just_dropped = max(new_dropped - self._obs_dropped, 0)
                self._obs_dropped = new_dropped
            reg = get_registry()
            reg.counter("serve.fleet.obs_frames").inc()
            reg.counter("serve.fleet.obs_bytes").inc(
                int(msg.get("nbytes", 0)))
            reg.counter("serve.fleet.obs_events").inc(len(events))
            if just_dropped:
                reg.counter("serve.fleet.obs_dropped").inc(just_dropped)

    def _mark_dead(self, reason: str) -> None:
        self._dead = reason
        with self._state_lock:
            pend = list(self._pending.values())
        for ent in pend:
            ent[0].set()

    def _check(self) -> None:
        if self._dead is not None:
            raise TransportError(f"replica transport dead: {self._dead}")
        if self._proc.poll() is not None and self._proc.returncode != 0:
            self._mark_dead(
                f"replica process exited rc={self._proc.returncode}")
            raise TransportError(f"replica transport dead: {self._dead}")

    # -- rpc ---------------------------------------------------------------

    def _rpc(self, msg: dict, timeout: Optional[float] = None):
        self._check()
        ev = threading.Event()
        with self._state_lock:
            rid = self._rpc_next
            self._rpc_next += 1
            self._pending[rid] = [ev, None]
        msg = dict(msg, rpc=rid)
        total_s = timeout if timeout is not None else self._rpc_timeout_s
        deadline = time.monotonic() + total_s
        # deterministic per-rpc jitter (Knuth hash of the rpc id):
        # concurrent retries against a struggling child spread out
        # instead of stampeding in lockstep
        jitter = 1.0 + self._rpc_retry_jitter * (
            (rid * 2654435761 & 0xFFFF) / 65535.0)
        with self._send_lock:
            # the frame is BUILT once, under the send lock, so its wire
            # sequence is allocated in send order and every re-send
            # (retry or reconnect replay) repeats the same seq — the
            # child's dedup window recognizes it
            self._send_seq = (self._send_seq + 1) & 0xFFFFF
            if self._send_seq == 0:
                # 20-bit counter wrapped: roll the epoch so the child's
                # window resets rather than treating a million frames
                # as duplicates
                self._epoch = (self._epoch % 4095) + 1
                self._send_seq = 1
            frame = _frame(_pack(msg), (self._epoch << 20) | self._send_seq)
            with self._state_lock:
                # register BEFORE sending: if the send races a
                # connection drop, the reconnect replay finds the frame
                # and re-sends it — marking the transport dead here
                # would preempt a recovery the read loop was about to
                # complete
                self._pending_frames[rid] = frame
            try:
                self._chaos_send_locked(frame)
            except OSError:
                pass        # reconnect replay (or _mark_dead) resolves it
        try:
            self.rpc_inflight += 1
            attempt = 0
            while True:
                wait_s = min(self._rpc_retry_base_s * (2.0 ** attempt),
                             self._rpc_retry_max_s) * jitter
                wait_s = min(wait_s, max(deadline - time.monotonic(), 0.0))
                if ev.wait(wait_s):
                    break
                if time.monotonic() >= deadline:
                    self._mark_dead(
                        f"rpc {msg.get('op')} timed out after "
                        f"{total_s}s ({attempt + 1} attempts)")
                    raise TransportError(
                        f"replica transport dead: {self._dead}")
                # attempt deadline passed without a reply: re-send the
                # SAME frame (same rpc id, same wire seq) and back off
                # exponentially — a dup the child already answered is
                # answered again from its reply cache
                attempt += 1
                self.wire_resends += 1
                try:
                    with self._send_lock:
                        self._chaos_send_locked(frame)
                except OSError:
                    pass    # reconnect replay carries it instead
            with self._state_lock:
                reply = self._pending[rid][1]
            if reply is None:                     # woken by _mark_dead
                raise TransportError(
                    f"replica transport dead: {self._dead}")
            if "error" in reply:
                _raise_remote(reply["error"][0], reply["error"][1])
            return reply.get("value")
        finally:
            with self._state_lock:
                self._pending.pop(rid, None)
                self._pending_frames.pop(rid, None)
            self.rpc_inflight = max(self.rpc_inflight - 1, 0)

    # -- ReplicaTransport ---------------------------------------------------

    def place(self, req: Request) -> None:
        now = self.clock()
        remaining = (req.deadline - now if req.deadline is not None
                     else None)
        payload = {"op": "place", "id": req.id,
                   "prompt": list(map(int, req.prompt)),
                   "max_new_tokens": req.max_new_tokens,
                   "seed": req.seed, "priority": req.priority,
                   "attempts": req.attempts,
                   "remaining_s": remaining,
                   "age_s": max(now - req.submitted_at, 0.0),
                   "cancelled": bool(req.cancelled),
                   "trace": req.trace_id}
        # in flight BEFORE the RPC: the child may finish the request (a
        # prefill-only replica retires it at its first token) and ship its
        # response before this thread wakes from the reply
        with self._state_lock:
            self._inflight[req.id] = req
        try:
            self._rpc(payload)                    # raises remote errors
        except BaseException:
            with self._state_lock:
                self._inflight.pop(req.id, None)
            raise
        req.attempts += 1                         # placement ledger

    def poll(self) -> List[Response]:
        self._check()
        out: List[Response] = []
        with self._state_lock:
            while self._responses:
                out.append(self._responses.popleft())
        return out

    def salvage(self) -> List[Response]:
        """Drain the parent-side response buffer WITHOUT the liveness
        check. These responses were accepted off live frames (and their
        tokens counted into ``obs_tokens_out``) before the wire died;
        the controller's drop path delivers them instead of re-running
        their requests, keeping the delivered-token reconciliation
        exact across a SIGKILL."""
        out: List[Response] = []
        with self._state_lock:
            while self._responses:
                out.append(self._responses.popleft())
        return out

    def evict_queued(self) -> List[int]:
        return [int(i) for i in (self._rpc({"op": "evict"}) or [])]

    def cancel(self, request_id: int) -> bool:
        return bool(self._rpc({"op": "cancel", "id": request_id}))

    def drain(self) -> None:
        self._draining = True
        self._rpc({"op": "drain"})

    @property
    def drained(self) -> bool:
        with self._state_lock:
            quiet = not self._inflight and not self._responses
        return self._draining and quiet and bool(self._hb.get("drained"))

    @property
    def idle(self) -> bool:
        with self._state_lock:
            return not self._inflight and not self._responses

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._dead is None and self._proc.poll() is None:
                send_frame(self._sock, {"op": "shutdown"}, self._send_lock)
                self._proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            pass
        self._kill_child()
        for s in (self._sock, self._listener):
            try:
                s.close()
            except OSError:
                pass

    def _kill_child(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:     # pragma: no cover
                pass

    # -- placement surface --------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._state_lock:
            live = int(self._hb.get("live", 0))
            return max(len(self._inflight) - live, 0)

    @property
    def queue_capacity(self) -> int:
        return self.queue_capacity_

    @property
    def live_slots(self) -> int:
        return int(self._hb.get("live", 0))

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        # mirror of the child's admission checks, evaluated lazily: the
        # child re-validates at place() and ships the ValueError back
        if max_new_tokens > self.default_max_new_tokens_:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the engine cap "
                f"({self.default_max_new_tokens_})")
        if prompt_len + max_new_tokens > self.spec.max_len:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds the slot cache "
                f"({self.spec.max_len} rows)")

    @property
    def default_max_new_tokens(self) -> int:
        return self.default_max_new_tokens_

    # -- shipped telemetry ---------------------------------------------------

    def obs_view(self):
        """The parent-side view of everything this child shipped:
        ``(registry, age_s, seq, events)`` — the merged
        :class:`~..obs.telemetry.MetricsRegistry`, seconds since the
        newest obs frame (None before the first), the child's frame
        sequence number, and a copy of the bounded trace-event stream.
        """
        with self._state_lock:
            age = (time.monotonic() - self._obs_at
                   if self._obs_at is not None else None)
            return (self._obs_registry, age, self._obs_seq,
                    list(self._obs_events))

    # -- health -------------------------------------------------------------

    def health(self) -> ReplicaHealth:
        alive = self._dead is None and self._proc.poll() is None
        age = (time.monotonic() - self._hb_at
               if self._hb_at is not None else float("inf"))
        hb = self._hb
        return ReplicaHealth(
            slow_streak=int(hb.get("slow_streak", 0)),
            miss_ewma=float(hb.get("miss_ewma", 0.0)),
            stuck_slots=int(hb.get("stuck_slots", 0)),
            consecutive_decode_errors=int(hb.get("decode_errors", 0)),
            heartbeat_age_s=age if self._hb_at is not None else 0.0,
            alive=alive)

    # -- KV handoff ---------------------------------------------------------

    def export_prefix(self, prompt: Sequence[int]) -> Optional[dict]:
        payload = self._rpc({"op": "export_prefix",
                             "prompt": list(map(int, prompt))})
        return payload or None

    def import_prefix(self, payload: dict) -> int:
        n = int(self._rpc({"op": "import_prefix", "payload": payload}) or 0)
        if n:
            self.handoff_bytes += int(payload.get("nbytes", 0))
        return n

    def invalidate_prefix(self, prompt: Sequence[int]) -> int:
        return int(self._rpc({"op": "invalidate_prefix",
                              "prompt": list(map(int, prompt))}) or 0)

    def cached_prefix_blocks(self, prompt: Sequence[int]) -> int:
        return int(self._rpc({"op": "cached_prefix",
                              "prompt": list(map(int, prompt))}) or 0)

    def prefix_directory(self) -> Optional[dict]:
        # Read from the last heartbeat, never an RPC: placement runs
        # every tick and must not add a round trip per candidate. The
        # directory is at most one heartbeat stale — acceptable for a
        # placement heuristic (a stale hit just degrades to cold).
        kv = self._hb.get("kv")
        return kv.get("directory") if kv else None

    def hot_prefixes(self, min_refs: int) -> List[dict]:
        kv = self._hb.get("kv")
        return list(kv.get("hot", ())) if kv else []

    # -- test hook ----------------------------------------------------------

    def drop_connection(self) -> None:
        """Sever the current socket WITHOUT touching the child — the
        transport-drop drill. The child's reconnect loop re-dials the
        listener; pending RPCs re-send on the fresh connection."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# child side: the replica worker


def _build_engine(spec: ReplicaSpec, event_log=None):
    """Construct the replica's model/backend/engine from the handshake
    spec on ``spec.device``: imports deferred so the parent-side
    transport never pays for the model code."""
    import torch

    from ..inference import GenerationConfig
    from ..models.transformer_lm import (LMConfig, PipelinedLM,
                                         build_sequential)
    from ..resilience import TickWatchdog
    from ..serve.buckets import BucketSpec
    from ..serve.engine import ServeEngine, SingleDeviceSlotBackend
    from ..serve.queue import RequestQueue
    from ..utils.platform import resolve_device

    device = resolve_device(spec.device)
    cfg = LMConfig(**spec.lm_cfg)
    gen_rng = torch.Generator(device=device).manual_seed(spec.init_seed)
    model = PipelinedLM.from_sequential(
        cfg, build_sequential(cfg, device=device, generator=gen_rng),
        spec.n_stages)
    gen = GenerationConfig(**spec.gen)
    buckets = (BucketSpec.of(*spec.buckets)
               if spec.buckets is not None else None)
    backend = SingleDeviceSlotBackend(
        model, num_slots=spec.num_slots, max_len=spec.max_len,
        gen=gen, buckets=buckets, decode_chunk=spec.decode_chunk,
        kv_block_size=spec.kv_block_size,
        kv_pool_blocks=spec.kv_pool_blocks, kv_dtype=spec.kv_dtype,
        kv_offload=spec.kv_offload,
        kv_offload_blocks=spec.kv_offload_blocks,
        prefill_chunk=spec.prefill_chunk)
    wd = TickWatchdog() if spec.watchdog else None
    return ServeEngine(backend,
                       RequestQueue(capacity=spec.queue_capacity),
                       watchdog=wd, event_log=event_log,
                       phase=spec.role)


def _peak_bytes(engine) -> Optional[int]:
    """The child's device peak (``max_memory_allocated``), None off CUDA."""
    import torch
    dev = engine.backend.device
    return (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else None)


def _child_op(engine, msg: dict, now: float):
    """Apply one parent op; returns the reply value (exceptions
    propagate to the op loop, which ships them back by name)."""
    op = msg["op"]
    if op == "place":
        req = Request(
            id=int(msg["id"]), prompt=list(msg["prompt"]),
            max_new_tokens=int(msg["max_new_tokens"]),
            seed=int(msg["seed"]), priority=int(msg["priority"]),
            deadline=(now + msg["remaining_s"]
                      if msg.get("remaining_s") is not None else None),
            submitted_at=now - float(msg.get("age_s", 0.0)),
            cancelled=bool(msg.get("cancelled", False)),
            # engine.place() increments: the wire ships the
            # pre-placement count so both ledgers agree after
            attempts=int(msg["attempts"]),
            trace_id=msg.get("trace"))
        engine.place(req)
        return True
    if op == "cancel":
        return engine.cancel(int(msg["id"]))
    if op == "evict":
        return [r.id for r in engine.evict_queued()]
    if op == "drain":
        engine.drain()
        return True
    if op == "status":
        # the controller-restart reconciliation query: engine caps (the
        # rejoin handshake's replacement for the spec/ready exchange)
        # plus every request id this replica still holds
        return {"default_max_new_tokens": engine.backend.gen.max_new_tokens,
                "queue_capacity": engine.queue.capacity,
                "num_slots": engine.backend.num_slots,
                "queued": [r.id for r in engine.queue.admission_order()],
                "live": [s.req.id for s in engine._slots if s is not None],
                "codec": "msgpack" if HAVE_MSGPACK else "json",
                "peak_bytes": _peak_bytes(engine)}
    backend = engine.backend
    pool = getattr(backend, "pool", None)
    if op == "export_prefix":
        exp = getattr(backend, "export_prefix_payload", None)
        return exp(msg["prompt"], codec="int8") if exp is not None else None
    if op == "import_prefix":
        imp = getattr(backend, "import_prefix_payload", None)
        return imp(msg["payload"]) if imp is not None else 0
    if op == "invalidate_prefix":
        if pool is None:
            return 0
        return pool.invalidate(pool.prefix_hashes(msg["prompt"]))
    if op == "cached_prefix":
        if pool is None:
            return 0
        return pool.cached_prefix_blocks(msg["prompt"])
    raise ValueError(f"unknown fleet op {op!r}")


def _heartbeat(engine, kv_hot_refs: Optional[int] = None,
               crc_rejects: int = 0) -> dict:
    wd = engine.watchdog
    hb = {"op": "hb",
          "slow_streak": wd.slow_streak if wd is not None else 0,
          "miss_ewma": wd.miss_ewma if wd is not None else 0.0,
          "stuck_slots": wd.stuck_slots if wd is not None else 0,
          "decode_errors": engine.consecutive_decode_errors,
          "depth": engine.queue.depth, "live": engine.live_slots,
          "idle": engine.idle, "draining": engine.draining,
          "drained": engine.drained}
    if crc_rejects:
        # only when a corrupt frame was actually seen: a clean wire
        # ships exactly the former heartbeat bytes
        hb["crc_rejects"] = int(crc_rejects)
    # KV gen-2 directory: piggybacked on the heartbeat cadence (one
    # beat stale at the controller, which is fine — placement is a
    # heuristic, correctness never depends on the directory). Only when
    # kv_hot_refs is armed: an unarmed fleet ships exactly the plain
    # heartbeat bytes.
    if kv_hot_refs is not None:
        pool = getattr(engine.backend, "pool", None)
        if pool is not None:
            hb["kv"] = {
                "directory": pool.prefix_digest_summary(),
                "hot": pool.hot_prefixes(kv_hot_refs),
            }
    return hb


def worker(port: int, token: str, host: str = "127.0.0.1") -> None:
    """The replica process: connect back to the parent, build the
    engine from the spec frame, then self-tick — serve ops between
    ticks, stream terminal responses, heartbeat on an interval, and
    re-dial the listener if the connection drops. ``host`` is the
    parent's advertised address (loopback by default; a real interface
    address for cross-host fleets)."""
    import selectors

    def dial() -> socket.socket:
        s = socket.create_connection((host, port), timeout=30)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_frame(s, {"op": "hello", "token": token})
        return s

    sock = dial()
    spec_msg = recv_frame(sock)
    assert spec_msg and spec_msg.get("op") == "spec", spec_msg
    spec = ReplicaSpec(**spec_msg["spec"])
    if spec.telemetry:
        from ..obs.fleet_obs import TraceBuffer
        trace_buf = TraceBuffer()
    else:
        # zero-overhead pledge: a disabled registry hands the engine
        # the shared null instruments and the wire carries no obs
        # frames at all
        from ..obs.telemetry import null_registry, set_registry
        set_registry(null_registry())
        trace_buf = None
    engine = _build_engine(spec, event_log=trace_buf)
    send_frame(sock, {"op": "ready",
                      "default_max_new_tokens":
                          engine.backend.gen.max_new_tokens,
                      "queue_capacity": engine.queue.capacity,
                      "num_slots": engine.backend.num_slots})

    sel = selectors.DefaultSelector()
    sel.register(sock, selectors.EVENT_READ)
    send_lock = threading.Lock()
    link = {"sock": sock, "up": True}
    # wire-hardening state: responses carry a child->parent sequence
    # (the parent suppresses replays), recent response frames are
    # retained for post-reconnect replay, and replies to already-seen
    # rpc ids are answered from cache instead of re-executing the op
    wire = {"resp_seq": 0, "recv_max": 0, "epoch": 0, "crc_rejects": 0}
    reply_cache: OrderedDict = OrderedDict()
    sent_responses = deque(maxlen=256)

    def resync(old: socket.socket) -> Optional[socket.socket]:
        """Reconnect loop: re-dial the parent's listener until it
        answers or the window closes, then replay every retained
        response frame — the parent's sequence dedup swallows the ones
        it already took, so a response lost to a partition or a corrupt
        frame is delivered exactly once."""
        sel.unregister(old)
        try:
            old.close()
        except OSError:
            pass
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                s = dial()
            except OSError:
                time.sleep(0.1)
                continue
            sel.register(s, selectors.EVENT_READ)
            with send_lock:
                link["sock"] = s
                try:
                    for frame in list(sent_responses):
                        s.sendall(frame)
                except OSError:
                    pass     # the next recv failure re-enters resync
            return s
        return None

    def ship_response(resp) -> None:
        """Frame one terminal response with the next wire sequence and
        retain it for replay. The frame is appended to the retained
        window BEFORE the send, so a send that dies mid-frame still
        replays after resync."""
        msg = {"op": "response", "id": resp.request_id,
               "tokens": list(map(int, resp.tokens)),
               "status": resp.status,
               "finish_reason": resp.finish_reason,
               "prompt_len": resp.prompt_len,
               "ttft": resp.ttft, "latency": resp.latency}
        with send_lock:
            wire["resp_seq"] += 1
            frame = _frame(_pack(msg), wire["resp_seq"])
            sent_responses.append(frame)
            link["sock"].sendall(frame)

    obs_state = {"seq": 0, "base": {}, "dropped": 0}
    obs_lock = threading.Lock()

    def ship_obs() -> None:
        # Telemetry piggybacks on the heartbeat cadence: a mergeable
        # registry delta plus the drained trace-event buffer, bounded
        # by spec.obs_max_bytes. Oversized payloads shed their events
        # first (metrics are tiny and keep counters continuous), then
        # drop outright — telemetry is strictly lossy-over-blocking and
        # can never stall the data plane.
        with obs_lock:
            reg = get_registry()
            metrics = reg.snapshot(mergeable=True, base=obs_state["base"])
            events = trace_buf.drain() if trace_buf is not None else []
            if not metrics and not events:
                return
            obs_state["seq"] += 1
            msg = {"op": "obs", "seq": obs_state["seq"], "metrics": metrics,
                   "events": events, "dropped": obs_state["dropped"]}
            buf = _pack(msg)
            if len(buf) > spec.obs_max_bytes and events:
                obs_state["dropped"] += len(events)
                msg["events"] = []
                msg["dropped"] = obs_state["dropped"]
                buf = _pack(msg)
            if len(buf) > spec.obs_max_bytes:
                obs_state["dropped"] += 1
                return
            msg["nbytes"] = len(buf)
        send_frame(link["sock"], msg, send_lock)

    def hb_pump() -> None:
        # Heartbeats come from their OWN thread: the main loop blocks
        # inside graph captures and long prefills, and a parent watching
        # heartbeat age would declare a healthy-but-capturing replica
        # wedged. Torch releases the GIL inside its ops, so this thread
        # keeps the health signal flowing through those stalls. Send
        # failures are ignored — the main loop owns reconnect.
        while link["up"]:
            time.sleep(spec.heartbeat_interval_s)
            try:
                # heartbeats are UNSEQUENCED (seq 0): they interleave
                # with response frames on the wire, and advancing the
                # parent's response-seq window from here would let a
                # beat sent during a drop suppress a replayed response
                send_frame(link["sock"],
                           _heartbeat(engine, spec.kv_hot_refs,
                                      wire["crc_rejects"]),
                           send_lock)
                if spec.telemetry:
                    ship_obs()
            except OSError:
                pass

    threading.Thread(target=hb_pump, daemon=True).start()

    while True:
        now = time.monotonic()
        busy = not engine.idle or (engine.draining and not engine.drained)
        events = sel.select(timeout=0.0 if busy else 0.02)
        for _ in events:
            try:
                msg = recv_frame(sock)
                if msg is None:
                    raise OSError("EOF")
            except FrameCorrupt:
                # a frame that fails its checksum poisons the stream
                # boundary — never parse past it. Count it (shipped on
                # the next heartbeat) and resync on a fresh connection;
                # the parent re-sends whatever the bad frame carried
                wire["crc_rejects"] += 1
                sock = resync(sock)
                if sock is None:
                    return
                continue
            except OSError:
                sock = resync(sock)
                if sock is None:
                    return
                continue
            seq = int(msg.pop("_seq", 0))
            if msg.get("op") == "shutdown":
                try:
                    if spec.telemetry:
                        ship_obs()    # final deltas before the lights go out
                    send_frame(sock, {"op": "reply",
                                      "rpc": msg.get("rpc"),
                                      "value": True}, send_lock)
                except OSError:
                    pass
                return
            if seq:
                # parent seqs = (epoch << 20) | counter. A fresh epoch
                # is a NEW parent incarnation (controller restart):
                # reset the dedup window and reply cache so the new
                # parent's rpc ids are never mistaken for the dead
                # parent's
                ep, ctr = seq >> 20, seq & 0xFFFFF
                if ep != wire["epoch"]:
                    wire["epoch"] = ep
                    wire["recv_max"] = 0
                    reply_cache.clear()
                if ctr <= wire["recv_max"]:
                    # replayed or duplicated op frame (chaos wire_dup,
                    # an rpc-timeout re-send, or the reconnect replay).
                    # If the op already ran, re-ship its cached reply
                    # rather than running it twice; an unseen rpc under
                    # an old seq (post-corruption realignment) falls
                    # through and runs normally — the parent's
                    # reply/response dedup is the backstop
                    cached = reply_cache.get(msg.get("rpc"))
                    if cached is not None:
                        try:
                            send_frame(sock, cached, send_lock)
                        except OSError:
                            sock = resync(sock)
                            if sock is None:
                                return
                        continue
                else:
                    wire["recv_max"] = ctr
            try:
                value = _child_op(engine, msg, time.monotonic())
                reply = {"op": "reply", "rpc": msg.get("rpc"),
                         "value": value}
            except Exception as e:                # noqa: BLE001 — wire it
                reply = {"op": "reply", "rpc": msg.get("rpc"),
                         "error": [type(e).__name__, str(e)]}
            if msg.get("rpc") is not None:
                reply_cache[msg["rpc"]] = reply
                while len(reply_cache) > 512:
                    reply_cache.popitem(last=False)
            try:
                send_frame(sock, reply, send_lock)
            except OSError:
                sock = resync(sock)
                if sock is None:
                    return

        if busy:
            for resp in engine.tick():
                try:
                    ship_response(resp)
                except OSError:
                    sock = resync(sock)
                    if sock is None:
                        return



def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="pipe_tpu_torch fleet replica worker (spawned by "
                    "ProcessReplicaTransport; not a user entry point)")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--token", required=True)
    ap.add_argument("--host", default="127.0.0.1",
                    help="parent listener address to dial back to")
    args = ap.parse_args(argv)
    worker(args.port, args.token, args.host)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
