"""Share of a step in which no kernel or copy runs on the card: one minus
the device's busy time a step (the union of kernel and copy intervals
over the profiled steps, per step) over the window's unprofiled time a
step, in percent. The profiler stretches the host's side of the steps it
records, so the profiled stretch's own length would overstate the idle
time; the device's busy time it records is not stretched."""


def read(ctx):
    summary, train = ctx.get("trace"), ctx.get("train")
    if not summary or not train:
        return None
    busy = summary["busy_s"] / train["profiled_steps"]
    return 100 * (1 - busy / train["step_s"])
