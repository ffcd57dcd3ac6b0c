"""Device milliseconds a step of memory copies and copy kernels (the
executor's stacking, scatter and stashes), from the profiled stretch."""

from harness import trace

KEYS = ("memcpy", "copy")


def read(ctx):
    summary, train = ctx.get("trace"), ctx.get("train")
    if not summary or not train:
        return None
    return 1e3 * trace.kernel_seconds(summary, KEYS) / train["profiled_steps"]
