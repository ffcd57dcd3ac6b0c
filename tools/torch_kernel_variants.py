"""Time variants of the flash forward and dK/dV kernels on one CUDA card.

    python3 tools/torch_kernel_variants.py [--out DIR]

Each variant is the committed source with a few lines replaced (tile sizes,
the TF32 rounding, a branch around the products, one TF32 pass instead of
three); the committed source is the variant ``fwd`` or ``dkv``. Every variant
is built by nvcc into ``build/kernel_variants/<name>/`` (one process per
variant, all at once), loaded by ctypes, held against the plain PyTorch
version and timed like ``chip_smoke.py`` times the kernels (a CUDA graph of
20 calls replayed 10 times), at the training, eval and two longer shapes,
with and without dropout. ``one_pass`` variants are wrong on purpose (TF32
error): they show what the two extra passes cost. Prints a line per shape
and rate, and writes the table as ``kernel_variants.json`` under ``--out``
(default ``build/kernel_variants/``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "build", "kernel_variants")
sys.path.insert(0, REPO)

ONE_PASS = ("  if (!A_EXACT) mma(c, as, bb);\n  if (!B_EXACT) mma(c, ab, bs);\n", "")
CVT = ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
       '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
       "  return r;")
BRANCHY = [(  # the forward's products only for the 8-key blocks a warp may see
    "        uint32_t bb[2], bs[2];\n"
    "        load_b_t<EX, LD>(ks, 8 * j, 8 * kk, bb, bs);\n"
    "        mma3<EX, EX>(sc[j], ab, as, bb, bs);\n",
    "        if (j < jn) {\n"
    "        uint32_t bb[2], bs[2];\n"
    "        load_b_t<EX, LD>(ks, 8 * j, 8 * kk, bb, bs);\n"
    "        mma3<EX, EX>(sc[j], ab, as, bb, bs);\n        }\n"), (
    "      uint32_t ab[4], as[4];\n      a_from_c<false>(sc[j], ab, as);\n",
    "      if (j >= jn) continue;\n"
    "      uint32_t ab[4], as[4];\n      a_from_c<false>(sc[j], ab, as);\n")]
BRANCHY_DKV = [(  # dK/dV's first products only for the 8-query blocks it may see
    "          uint32_t bb[2], bs[2];\n"
    "          load_b_t<EX, LD>(qs, 8 * j, 8 * kk, bb, bs);\n",
    "          if (j < jlo || j >= jhi) continue;\n"
    "          uint32_t bb[2], bs[2];\n"
    "          load_b_t<EX, LD>(qs, 8 * j, 8 * kk, bb, bs);\n"), (
    "        uint32_t pb[4], ps[4], sb[4], ss[4];\n",
    "        if (j < jlo || j >= jhi) continue;\n"
    "        uint32_t pb[4], ps[4], sb[4], ss[4];\n")]
FWD, DKV = "flash_attn_fwd.cu", "flash_attn_bwd_dkv.cu"
# name: (source, replacements in it, replacements in tc_tf32.cuh)
VARIANTS = {
    "fwd": (FWD, [], []),
    "fwd_cvt": (FWD, [], [CVT]),
    "fwd_branchy": (FWD, BRANCHY, []),
    "fwd_bk32": (FWD, [("constexpr int BK = 64;", "constexpr int BK = 32;")], []),
    "fwd_one_pass": (FWD, [], [ONE_PASS]),
    "dkv": (DKV, [], []),
    "dkv_cvt": (DKV, [], [CVT]),
    "dkv_branchy": (DKV, BRANCHY_DKV, []),
    "dkv_bq64": (DKV, [("constexpr int BQ = 32;", "constexpr int BQ = 64;")], []),
    "dkv_one_pass": (DKV, [], [ONE_PASS]),
}
SHAPES = [(256, 128, 64, True), (64, 128, 64, True), (16, 512, 64, True),
          (8, 256, 128, False)]


def build(out_dir: str = BUILD) -> dict:
    """Writes and compiles every variant; returns ``{name: ctypes function}``."""
    from pipe_tpu_torch import _build
    from pipe_tpu_torch.ops import flash_attention as fa
    nvcc = _build.cuda_tool()
    procs = {}
    for name, (src, subs, hsubs) in VARIANTS.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for path in [_build.CSRC / src, *_build.CSRC.glob("*.cuh")]:
            text = path.read_text()
            for old, new in (subs if path.name == src else
                             hsubs if path.name == "tc_tf32.cuh" else []):
                if old not in text:
                    raise RuntimeError(f"{name}: {path.name} no longer has "
                                       f"{old[:60]!r}")
                text = text.replace(old, new)
            with open(os.path.join(vdir, path.name), "w") as f:
                f.write(text)
        lib = os.path.join(vdir, "lib.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib, os.path.join(vdir, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log}")
        fwd = VARIANTS[name][0] == FWD
        fn = getattr(ctypes.CDLL(lib), "pipe_flash_attn_fwd" if fwd
                     else "pipe_flash_attn_bwd_dkv")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (5 if fwd else 8)
                       + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + fa._DROP_ARGTYPES)
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    import chip_smoke
    from pipe_tpu_torch.ops import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=BUILD)
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_device()
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = []
    for bh, s, d, causal in SHAPES:
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, dk, dv = (torch.empty_like(q) for _ in range(3))
        lse = torch.empty((bh, 1, s), device="cuda")
        for rate in (0.0, chip_smoke.DROPOUT):
            seed = chip_smoke.DROP_SEEDS[0]
            keep = fa.dropout_keep(seed, rate, bh, s, device="cuda") if rate else None
            o_r, l_r = fa.flash_attention_ref(q, k, v, causal, scale, keep)
            delta = fa.attention_delta(o_r, do)
            dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(
                q, k, v, do, l_r, delta, causal=causal, scale=scale, keep=keep)
            drop = fa._dropout_args(seed, rate)
            row = {"shape": [bh, s, d, causal], "rate": rate}
            for name, fn in fns.items():
                if VARIANTS[name][0] == FWD:
                    ptrs, outs, refs = (q, k, v, o, lse), (o,), (o_r,)
                else:
                    ptrs = (q, k, v, do, l_r, delta, dk, dv)
                    outs, refs = (dk, dv), (dk_r, dv_r)

                def call(fn=fn, ptrs=ptrs):
                    err = fn(*[t.data_ptr() for t in ptrs], bh, s, d,
                             int(causal), scale, 0, *drop,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")

                call()
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(outs, refs))
                row[name] = {"ms": chip_smoke.time_ms(call), "max_abs_err": err}
            table.append(row)
            print((bh, s, d, causal), f"rate={rate}", " ".join(
                f"{n}={r['ms']:.5f}({r['max_abs_err']:.1e})"
                for n, r in row.items() if isinstance(r, dict)), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
        json.dump({"device": smi, "rows": table}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
