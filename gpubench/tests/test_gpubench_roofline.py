"""The implementation-free work model at the benchmark's two transforms."""

import pytest

from gpubench import roofline


@pytest.mark.parametrize("log_n, elem_bytes, ops_ms, bytes_ms, by", [
    (22, 32, 0.1015, 0.0801, "operations"),     # BLS12-381 Fr 2^22
    (24, 8, 0.0326, 0.0801, "bytes"),           # Goldilocks 2^24
])
def test_least_time(log_n, elem_bytes, ops_ms, bytes_ms, by):
    n = 1 << log_n
    t_ops = roofline.transform_ops(n, elem_bytes) / roofline.INT8_OPS_PER_S
    t_bytes = (roofline.transform_bytes(n, elem_bytes)
               / roofline.HBM_BYTES_PER_S)
    assert round(t_ops * 1e3, 4) == ops_ms
    assert round(t_bytes * 1e3, 4) == bytes_ms
    t, bound = roofline.least_time(n, elem_bytes)
    assert bound == by and t == max(t_ops, t_bytes)


def test_counts():
    assert roofline.butterflies(1 << 22) == (1 << 21) * 22
    assert roofline.macs_per_butterfly(32) == 2176
    assert roofline.macs_per_butterfly(8) == 160
    assert roofline.transform_bytes(1 << 24, 8) == 2 * 8 << 24
