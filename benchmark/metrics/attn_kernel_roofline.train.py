"""The port's three flash-attention kernels (forward, dQ, dK/dV) against
their roofline: the sum over calls of each call's least time
(``yardstick.flash_call_bound_s`` at the cell's micro-batch shape) over
the sum of their device time, in percent. Nothing when no call ran."""

from harness import yardstick

KERNELS = {"flash_fwd_kernel": "fwd", "flash_bwd_dq_kernel": "bwd_dq",
           "flash_bwd_dkv_kernel": "bwd_dkv"}


def read(ctx):
    summary, train = ctx.get("trace"), ctx.get("train")
    if not summary or not train:
        return None
    shape = train["attention"]
    bound = spent = 0.0
    for name, s, e in summary["kernels"]:
        kind = next((k for key, k in KERNELS.items() if key in name), None)
        if kind is None:
            continue
        bound += yardstick.flash_call_bound_s(kind, shape["bh"], shape["s"],
                                              shape["d"], shape["causal"])
        spent += e - s
    if spent <= 0.0:
        return None
    return 100 * bound / spent
