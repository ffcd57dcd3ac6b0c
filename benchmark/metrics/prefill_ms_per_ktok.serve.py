"""Milliseconds of the backend's prefills a thousand prompt tokens, by the
host clock with a synchronise on each side, across the window's
unprofiled part."""


def read(ctx):
    serve = ctx.get("serve")
    if not serve or serve["prefill_tokens"] <= 0:
        return None
    return 1e6 * serve["prefill_s"] / serve["prefill_tokens"]
