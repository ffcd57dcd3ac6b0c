"""ctypes binding for the native corpus processor and batch prefetcher.

Counterpart of ``pipe_tpu/data/native.py`` over the port's own copies of the
two sources, ``pipe_tpu_torch/csrc/pipetpu_io.cpp`` (one C++ pass builds the
token-id stream and first-appearance vocabulary) and
``pipe_tpu_torch/csrc/pipetpu_prefetch.cpp`` (a producer thread assembles
(data, target) batches into a ring of slots). Each is compiled with ``g++`` at
first use into ``build/native/`` beside the package, named by a hash of its
source and flags (a build goes to a temporary name and is renamed, so
processes that race to build it each load a whole library). Everything falls
back to the pure-Python pipeline (``data.lm_text``) when no toolchain is
available, with the same ids and batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["native_available", "NativeCorpus", "process_corpus",
           "prefetch_available", "BatchPrefetcher", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "native"
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}          # source name -> loaded CDLL, or None (build failed)


def _build_lib(source: str, *extra_flags: str) -> Optional[Path]:
    """Compile ``csrc/source`` into ``build/native/`` unless its library is
    there; None when there is no toolchain or the build fails."""
    flags = (*_CXX_FLAGS, *extra_flags)
    src = _CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _load_io(lib: ctypes.CDLL) -> None:
    lib.ptio_from_bytes.restype = ctypes.c_void_p
    lib.ptio_from_bytes.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ptio_from_file.restype = ctypes.c_void_p
    lib.ptio_from_file.argtypes = [ctypes.c_char_p]
    lib.ptio_num_tokens.restype = ctypes.c_int64
    lib.ptio_num_tokens.argtypes = [ctypes.c_void_p]
    lib.ptio_vocab_size.restype = ctypes.c_int32
    lib.ptio_vocab_size.argtypes = [ctypes.c_void_p]
    lib.ptio_copy_ids.restype = None
    lib.ptio_copy_ids.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.ptio_token.restype = ctypes.c_char_p
    lib.ptio_token.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ptio_lookup.restype = ctypes.c_int32
    lib.ptio_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ptio_free.restype = None
    lib.ptio_free.argtypes = [ctypes.c_void_p]


def _load_prefetch(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ptpf_create.restype = ctypes.c_void_p
    lib.ptpf_create.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64, i32p, i32p]
    lib.ptpf_num_batches.restype = ctypes.c_int64
    lib.ptpf_num_batches.argtypes = [ctypes.c_void_p]
    lib.ptpf_next.restype = ctypes.c_int64
    lib.ptpf_next.argtypes = [ctypes.c_void_p]
    lib.ptpf_release.restype = None
    lib.ptpf_release.argtypes = [ctypes.c_void_p]
    lib.ptpf_free.restype = None
    lib.ptpf_free.argtypes = [ctypes.c_void_p]


_SOURCES = {"pipetpu_io.cpp": ((), _load_io),
            "pipetpu_prefetch.cpp": (("-pthread",), _load_prefetch)}


def _load(source: str) -> Optional[ctypes.CDLL]:
    with _lock:
        if source not in _libs:
            flags, bind = _SOURCES[source]
            path = _build_lib(source, *flags)
            lib = ctypes.CDLL(str(path)) if path is not None else None
            if lib is not None:
                bind(lib)
            _libs[source] = lib
        return _libs[source]


def native_available() -> bool:
    return _load("pipetpu_io.cpp") is not None


class NativeCorpus:
    """Token ids + vocabulary built by the C++ pass."""

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._h = handle
        self._lib = lib

    @staticmethod
    def _lib_or_raise() -> ctypes.CDLL:
        lib = _load("pipetpu_io.cpp")
        if lib is None:
            raise RuntimeError("native corpus library unavailable")
        return lib

    @classmethod
    def from_file(cls, path: str) -> "NativeCorpus":
        lib = cls._lib_or_raise()
        h = lib.ptio_from_file(path.encode())
        if not h:
            raise FileNotFoundError(
                f"{path}: unreadable, non-seekable, or out of memory")
        return cls(h, lib)

    @classmethod
    def from_text(cls, text: str) -> "NativeCorpus":
        lib = cls._lib_or_raise()
        data = text.encode()
        h = lib.ptio_from_bytes(data, len(data))
        if not h:
            raise MemoryError("native corpus build failed")
        return cls(h, lib)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ptio_free(self._h)
            self._h = None

    @property
    def num_tokens(self) -> int:
        return int(self._lib.ptio_num_tokens(self._h))

    @property
    def vocab_size(self) -> int:
        return int(self._lib.ptio_vocab_size(self._h))

    def ids(self) -> np.ndarray:
        out = np.empty(self.num_tokens, np.int32)
        self._lib.ptio_copy_ids(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def token(self, idx: int) -> str:
        raw = self._lib.ptio_token(self._h, idx)
        if raw is None:
            raise IndexError(idx)
        return raw.decode()

    def lookup(self, token: str) -> int:
        return int(self._lib.ptio_lookup(self._h, token.encode()))

    def vocab_list(self) -> List[str]:
        return [self.token(i) for i in range(self.vocab_size)]


def process_corpus(path: Optional[str] = None, text: Optional[str] = None
                   ) -> Tuple[np.ndarray, List[str]]:
    """(ids, vocab) via the native pass, falling back to pure Python.

    The native pass is used only for ASCII corpora: its lowercase and
    whitespace handling are byte-wise, while the Python tokenizer is
    Unicode-aware, so routing non-ASCII text natively would change ids.
    """
    if (path is None) == (text is None):
        raise ValueError("pass exactly one of path or text")
    if text is None:
        with open(path, encoding="utf-8") as f:
            text_content = f.read()
    else:
        text_content = text
    if native_available() and text_content.isascii():
        c = (NativeCorpus.from_file(path) if path is not None
             else NativeCorpus.from_text(text))
        return c.ids(), c.vocab_list()
    from . import lm_text
    lines = text_content.splitlines()
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, lines))
    return lm_text.data_process(lines, vocab), \
        [vocab.lookup_token(i) for i in range(len(vocab))]


def prefetch_available() -> bool:
    return _load("pipetpu_prefetch.cpp") is not None


class BatchPrefetcher:
    """Iterator over (data, target) LM batches assembled by a C++ thread.

    Matches ``lm_text.get_batch``'s walk exactly (slice + transpose per full
    batch; tail batches are never yielded), but the assembly runs on a
    producer thread writing into a ``depth``-slot ring of pre-allocated
    buffers, so batch preparation overlaps device compute.

    The arrays yielded for batch ``b`` are views into ring slot
    ``b % depth`` and are valid only until the next ``__next__`` call:
    advancing the iterator releases the previous slot to the producer,
    which may overwrite it at once. Callers that keep them across
    iterations must ``.copy()`` (``Trainer._batches`` does). ``opened``
    counts the prefetchers constructed in this process, ``closed`` those
    whose producer has been freed.
    """

    opened = 0
    closed = 0

    def __init__(self, source: np.ndarray, bptt: int, depth: int = 2):
        lib = _load("pipetpu_prefetch.cpp")
        if lib is None:
            raise RuntimeError("native prefetch library unavailable")
        if source.ndim != 2:
            raise ValueError(f"source must be [nbatch, bsz], got "
                             f"{source.shape}")
        if bptt <= 0 or depth <= 0:
            raise ValueError("bptt and depth must be positive")
        self._lib = lib
        # keep the producer's input alive and contiguous for its lifetime
        self._source = np.ascontiguousarray(source, dtype=np.int32)
        nrows, bsz = self._source.shape
        self._data = np.empty((depth, bsz, bptt), np.int32)
        self._target = np.empty((depth, bsz, bptt), np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._h = lib.ptpf_create(
            self._source.ctypes.data_as(i32p), nrows, bsz, bptt, depth,
            self._data.ctypes.data_as(i32p),
            self._target.ctypes.data_as(i32p))
        if not self._h:
            raise MemoryError("native prefetcher creation failed")
        BatchPrefetcher.opened += 1
        self._outstanding = False
        self.num_batches = int(lib.ptpf_num_batches(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        if self._outstanding:
            self._lib.ptpf_release(self._h)
            self._outstanding = False
        slot = int(self._lib.ptpf_next(self._h))
        if slot < 0:
            self.close()
            raise StopIteration
        self._outstanding = True
        return self._data[slot], self._target[slot]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ptpf_free(self._h)
            self._h = None
            BatchPrefetcher.closed += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
