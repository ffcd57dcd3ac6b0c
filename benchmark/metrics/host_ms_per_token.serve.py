"""The engine's host overhead a generated token: the program's
``serve.engine.host_sec`` timer (every second of a tick outside the
backend's prefill and decode calls) over its ``serve.engine.tokens``
counter, across the window's unprofiled part, in milliseconds."""


def read(ctx):
    serve = ctx.get("serve")
    if not serve or serve["tokens"] <= 0:
        return None
    return 1e3 * serve["host_s"] / serve["tokens"]
