"""Device milliseconds a step of the kernels launched inside the
optimizer's step and, where the program clips, inside its global-norm
clip, from the profiled stretch."""


def read(ctx):
    summary, train = ctx.get("trace"), ctx.get("train")
    if not summary or not train:
        return None
    ranges = summary["range_device_s"]
    if not ranges:
        return None
    return 1e3 * sum(ranges.values()) / train["profiled_steps"]
