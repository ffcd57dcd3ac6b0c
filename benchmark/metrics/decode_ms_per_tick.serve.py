"""Milliseconds a decode launch of the backend takes (a resident launch
runs several chunks), by the host clock with a synchronise on each side,
across the window's unprofiled part."""


def read(ctx):
    serve = ctx.get("serve")
    if not serve or serve["decode_calls"] <= 0:
        return None
    return 1e3 * serve["decode_s"] / serve["decode_calls"]
