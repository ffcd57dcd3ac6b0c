"""Device milliseconds a step of matrix-product kernels (cuBLAS and
CUTLASS GEMMs and their split-K reductions), from the profiled stretch."""

from harness import trace

KEYS = ("gemm", "cutlass", "cublas", "xmma", "sm90_", "splitk")


def read(ctx):
    summary, train = ctx.get("trace"), ctx.get("train")
    if not summary or not train:
        return None
    seconds = trace.kernel_seconds(summary, KEYS, exclude=("flash",))
    return 1e3 * seconds / train["profiled_steps"]
