"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, which :func:`load` opens with
``ctypes``. Libraries go to ``build/torch_kernels/`` beside the package, named
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header builds anew and an unchanged one is reused. :func:`build_all` starts one ``nvcc`` per missing
library, all at once. Nothing here runs at import time: the CPU path needs no
compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "cuda_tool",
           "load"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "flash_attn_bwd_dkv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``, ...): on PATH
    or under /usr/local/cuda/bin."""
    path = shutil.which(name)
    if path is None and os.path.exists(f"/usr/local/cuda/bin/{name}"):
        path = f"/usr/local/cuda/bin/{name}"
    if path is None:
        raise RuntimeError(
            f"{name} not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            f"of pipe_tpu_torch build on a machine with the CUDA toolkit")
    return path


def lib_path(source: str) -> Path:
    """Where ``source``'s library lives: named by its content, the headers'
    and the flags."""
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{source: {"seconds": wall time of its nvcc (0.0 if cached),
    "ptxas": the compiler's -Xptxas -v report}}``. Raises ``RuntimeError``
    with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out: Dict[str, dict] = {}
    for src in sources:
        dst = lib_path(src)
        if dst.exists():
            out[src] = {"seconds": 0.0, "ptxas": "(cached)"}
            continue
        nvcc = nvcc or cuda_tool()
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, dst, time.perf_counter())
    failed = []
    for src, (proc, tmp, dst, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, dst)
        out[src] = {"seconds": seconds, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    path = lib_path(source)
    if not path.exists():
        build_all([source])
    return ctypes.CDLL(str(path))
