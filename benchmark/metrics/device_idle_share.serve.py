"""Share of the profiled stretch at the end of the window in which no
kernel or copy ran on the card (one minus the union of their intervals
over the stretch), in percent."""


def read(ctx):
    summary = ctx.get("trace")
    if not summary or summary["window_s"] <= 0:
        return None
    return 100 * (1 - summary["busy_s"] / summary["window_s"])
