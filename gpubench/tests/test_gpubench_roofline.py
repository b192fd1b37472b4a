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


@pytest.mark.parametrize("log_n", range(10, 31, 2))
@pytest.mark.parametrize("elem_bytes", [4, 8, 32])
def test_one_card_has_no_exchange(log_n, elem_bytes):
    """At chips=1 the least time is the larger of operations and bytes,
    as before cards were counted."""
    n = 1 << log_n
    t_ops = roofline.transform_ops(n, elem_bytes) / roofline.INT8_OPS_PER_S
    t_bytes = (roofline.transform_bytes(n, elem_bytes)
               / roofline.HBM_BYTES_PER_S)
    want = ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))
    assert roofline.least_time(n, elem_bytes) == want
    assert roofline.least_time(n, elem_bytes, chips=1) == want
    assert roofline.exchange_bytes(n, elem_bytes, 1) == 0


def test_four_cards_at_bls_2e30():
    """BLS12-381 Fr at 2^30 over four cards: operations 8.85 ms, bytes
    5.13 ms, the exchange 14.32 ms, which binds."""
    n, d, D = 1 << 30, 32, 4
    t_ops = roofline.transform_ops(n, d) / (D * roofline.INT8_OPS_PER_S)
    t_bytes = roofline.transform_bytes(n, d) / (D * roofline.HBM_BYTES_PER_S)
    assert round(t_ops * 1e3, 2) == 8.85
    assert round(t_bytes * 1e3, 2) == 5.13
    assert roofline.exchange_bytes(n, d, D) == 3 * n * d / 16
    t, by = roofline.least_time(n, d, chips=D)
    assert by == "exchange" and round(t * 1e3, 2) == 14.32
