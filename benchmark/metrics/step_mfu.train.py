"""Whole-step model FLOPs utilisation: the FLOPs a trained token requires
(the frozen ``train_flops_per_token`` count, no recomputation) times the
window's unprofiled tokens per second, over the card's dense 16-bit peak,
in percent."""

from harness import yardstick


def read(ctx):
    train = ctx.get("train")
    if not train:
        return None
    return (100 * train["flops_per_token"] * train["tokens_per_s"]
            / yardstick.PEAK_DENSE16_FLOPS)
