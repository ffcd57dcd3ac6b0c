"""The yardstick's counts against hand counts, and the frozen FLOPs model
against the port's."""

import types

import pytest

from harness import yardstick


@pytest.mark.parametrize("bh,s,d", [(24, 1024, 64), (256, 128, 64)])
def test_flash_costs_match_hand_counts(bh, s, d):
    pairs = bh * s * (s + 1) // 2          # causal query-key pairs
    mat = bh * s * d * 4                    # one fp32 [bh, s, d] tensor
    row = bh * s * 4                        # one fp32 [bh, s] statistic
    assert yardstick.flash_call_cost("fwd", bh, s, d, True) == (
        2 * 2 * d * pairs, 4 * mat + row)
    assert yardstick.flash_call_cost("bwd_dq", bh, s, d, True) == (
        2 * 2 * d * pairs, 5 * mat + 2 * row)
    assert yardstick.flash_call_cost("bwd_dkv", bh, s, d, True) == (
        2 * 2 * d * pairs, 6 * mat + 2 * row)
    flops, nbytes = yardstick.flash_call_cost("fwd", bh, s, d, False)
    assert flops == 4 * d * bh * s * s


def test_flash_bound_is_the_larger_of_compute_and_bytes():
    # GPT-2's forward call: 25.2 MB at 3.35 TB/s (7.5 us) over 3.2 GFLOP
    # at 989.4 TFLOP/s (3.3 us): bytes bound it
    b = yardstick.flash_call_bound_s("fwd", 24, 1024, 64, True)
    assert b == pytest.approx((4 * 24 * 1024 * 64 * 4 + 24 * 1024 * 4)
                              / 3.35e12)
    # a long sequence at one head: compute bounds it
    flops, _ = yardstick.flash_call_cost("bwd_dq", 1, 16384, 128, True)
    assert yardstick.flash_call_bound_s("bwd_dq", 1, 16384, 128, True) \
        == pytest.approx(flops / 989.4e12)


@pytest.mark.parametrize("d,ff,L,V,s,causal,ck,m,required", [
    # the tutorial LM: 1,332.1 M MACs a token, 7.993 GFLOP
    (4096, 4096, 12, 28782, 128, True, "except_last", 4,
     6 * (12 * (4 * 4096 ** 2 + 2 * 4096 * 4096 + 2 * 64 * 4096)
          + 4096 * 28782)),
    # GPT-2 small: 0.798 GFLOP a token
    (768, 3072, 12, 50257, 1024, True, "except_last", 16,
     6 * (12 * (4 * 768 ** 2 + 2 * 768 * 3072 + 2 * 512 * 768)
          + 768 * 50257)),
])
def test_train_flops_per_token_by_hand(d, ff, L, V, s, causal, ck, m,
                                       required):
    got = yardstick.train_flops_per_token(d, ff, L, V, s, causal, ck, m)
    assert got[0] == required
    layer = L * (4 * d * d + 2 * d * ff + 2 * (s / 2) * d)
    assert got[1] == required + 2 * layer * (m - 1) / m


@pytest.mark.parametrize("name", ["pipe-tutorial-lm", "gpt2-small"])
def test_frozen_flops_match_the_ports(name):
    from harness import core
    from pipe_tpu_torch.obs.telemetry import train_flops_per_token

    cfg = core.plan({"pipe-tutorial-lm": "lm-train-c4",
                     "gpt2-small": "gpt2s-train-c16"}[name]).config
    if name == "pipe-tutorial-lm":
        shape = dict(d_model=cfg["emsize"], d_ff=cfg["nhid"],
                     n_layers=cfg["nlayers"], vocab=cfg["ntokens"],
                     seq_len=cfg["bptt"])
    else:
        shape = dict(d_model=cfg["n_embd"], d_ff=4 * cfg["n_embd"],
                     n_layers=cfg["n_layer"], vocab=cfg["vocab_size"],
                     seq_len=cfg["n_positions"])
    for ck, m in (("except_last", 4), ("never", 1), ("always", 16)):
        port = train_flops_per_token(
            types.SimpleNamespace(causal=True, **shape), ck, m)
        assert yardstick.train_flops_per_token(
            causal=True, checkpoint=ck, chunks=m, **shape) == port
