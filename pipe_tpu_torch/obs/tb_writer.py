"""Self-contained TensorBoard scalar writer (SURVEY §5: "stdout +
TensorBoard scalars").

Counterpart of ``pipe_tpu/obs/tb_writer.py``, copied: it is pure Python
(``os``, ``struct``, ``socket``) and writes the same bytes for the same tags,
values, steps and wall times. The event file format is implemented directly
(no ``tensorboard`` import): a TFRecord stream of binary-encoded ``Event``
protos --

* record framing: ``[len u64le][masked_crc32c(len) u32le][payload]
  [masked_crc32c(payload) u32le]``, CRC32C (Castagnoli) with TensorBoard's
  rotate-and-add mask;
* ``Event`` proto fields used: ``wall_time`` (1, double), ``step``
  (2, varint), ``file_version`` (3, string -- first record,
  ``"brain.Event:2"``), ``summary`` (5) -> repeated ``Summary.Value``
  (1) -> ``tag`` (1, string) + ``simple_value`` (2, float).

``tests/test_torch_obs.py`` holds the file to ``pipe_tpu``'s byte for byte
and checks every record's masked CRC32C.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import IO, Optional

__all__ = ["ScalarWriter"]

# --- CRC32C (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # reflected Castagnoli
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal proto encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # proto varints encode negative int64 as 10-byte two's complement;
        # Python's arithmetic shift would otherwise never reach 0
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    value_msg = (_len_delim(1, tag.encode("utf-8"))  # Summary.Value.tag
                 + _float32(2, value))               # .simple_value
    summary = _len_delim(1, value_msg)               # Summary.value
    return (_double(1, wall_time)                    # Event.wall_time
            + _key(2, 0) + _varint(step)             # Event.step
            + _len_delim(5, summary))                # Event.summary


def _version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


class ScalarWriter:
    """Append-only scalar event writer for one run directory.

    >>> w = ScalarWriter("/tmp/run0")
    >>> w.add_scalar("train/loss", 3.14, step=10)
    >>> w.close()
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        ts = time.time()
        host = socket.gethostname() or "host"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(ts)}.{host}")
        self._f: Optional[IO[bytes]] = open(self.path, "ab")
        self._write_record(_version_event(ts))
        self.flush()

    def _write_record(self, payload: bytes) -> None:
        if self._f is None:
            raise ValueError("writer is closed")
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(
            _scalar_event(tag, float(value), int(step),
                          time.time() if wall_time is None else wall_time))

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self) -> "ScalarWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
