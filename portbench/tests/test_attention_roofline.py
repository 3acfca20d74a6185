"""The attention kernels' bound (``attention_bounds.py``) against sums written
out by hand, and the reader of ``attention_roofline.train`` against traces
made up here: a transformer cell's share, nothing for the BiLSTM cell or a
trace without the kernels (the parent's program)."""

import pytest

from portbench import harness
from portbench.attention_bounds import attention_bounds_ms
from portbench.flops import PEAK_BYTES_PER_S, PEAK_FLOPS


def test_bounds_by_hand():
    # B=2, L=4, H=3, h=8 in bfloat16: a tensor is 2·4·3·8·2 = 384 bytes, the
    # mask 2·4·4 = 32; a product 2·2·3·4·4·8 = 1536 operations.
    got = attention_bounds_ms(2, 4, 3, 8, "bfloat16")
    assert got["fwd"] == pytest.approx(((4 * 384 + 32) / PEAK_BYTES_PER_S * 1e3, "bytes"))
    assert got["bwd"] == pytest.approx(((7 * 384 + 32) / PEAK_BYTES_PER_S * 1e3, "bytes"))
    plain = attention_bounds_ms(2, 4, 3, 8, "float32", masked=False)
    assert plain["fwd"][0] == pytest.approx(4 * 768 / PEAK_BYTES_PER_S * 1e3)
    # At L = 4096 the products outweigh the bytes.
    long = attention_bounds_ms(1, 4096, 1, 64, "bfloat16")
    assert long["fwd"] == pytest.approx((2 * 2 * 4096 ** 2 * 64 / PEAK_FLOPS["bfloat16"] * 1e3,
                                         "operations"))


def test_the_critic_loop_call():
    """B = 1024, L = 128, four heads of 16: 67.6 MB, 0.020 ms."""
    fwd = attention_bounds_ms(1024, 128, 4, 16, "bfloat16")["fwd"]
    assert fwd[1] == "bytes" and fwd[0] == pytest.approx(0.0202, rel=0.01)


def _trace(seconds, steps=78):
    ops = {"void (anonymous namespace)::attn_core_fwd_mma_kernel<16>(...)": [28 * steps, 0.0],
           "void (anonymous namespace)::attn_core_bwd_mma_kernel<16>(...)": [8 * steps, 0.0],
           "void at::native::elementwise_kernel<128, 2>(...)": [100, 1.0]}
    fwd, bwd = list(ops)[:2]
    ops[fwd][1], ops[bwd][1] = seconds / 2, seconds / 2
    return {"steps": steps, "ops": ops}


def test_reader_share_of_the_step(cell_of):
    cell = cell_of("varlen_transformer.train")
    read = harness.reader("attention_roofline.train")
    critic = attention_bounds_ms(1024, 128, 4, 16, "bfloat16")
    joint = attention_bounds_ms(512, 128, 4, 16, "bfloat16")
    step_ms = 4 * (5 * critic["fwd"][0] + 2 * (joint["fwd"][0] + joint["bwd"][0]))
    seconds = 0.5
    got = read({"cell": cell, "trace": _trace(seconds)})
    assert got == pytest.approx(100 * step_ms * 78 / (seconds * 1e3))


def test_reader_finds_nothing(cell_of):
    read = harness.reader("attention_roofline.train")
    cell = cell_of("varlen_transformer.train")
    assert read({"cell": cell}) is None
    assert read({"cell": cell, "trace": {"steps": 78, "ops": {
        "void at::native::softmax_warp_forward(...)": [100, 0.3]}}}) is None
    assert read({"cell": cell_of("flagship.train"), "trace": _trace(0.5)}) is None
