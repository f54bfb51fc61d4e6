"""The frozen yardstick on a synthetic block list."""

import pytest

from harness import yardstick


def test_bytes_operations_and_bound_of_a_block_list():
    blocks = [(128, 128), (128, 64), (640, 640, 8), (256, 512, 3)]
    entries = yardstick.stored_entries(blocks)
    assert entries == 128 * 128 + 128 * 64 + 8 * 1280 + 3 * 768
    n, k = 1000, 4
    b = yardstick.product_bytes(entries * 4, n, n, k, 4)
    assert b == entries * 4 + 2 * n * k * 4
    assert yardstick.product_ops(entries, k, False) == 2 * entries * k
    assert yardstick.product_ops(entries, k, True) == 8 * entries * k
    t, by = yardstick.product_bound(entries * 4, n, n, k, 4, False)
    assert by == "bytes" and t == pytest.approx(b / 3.35e12)


def test_wide_complex_products_are_bound_by_operations():
    entries = 10_000_000
    t, by = yardstick.product_bound(entries * 8, 1000, 1000, 512, 8, True)
    assert by == "operations"
    assert t == pytest.approx(8 * entries * 512 / 495e12)


def test_the_bound_is_never_above_either_rate():
    for k in (1, 8, 128):
        t, _ = yardstick.product_bound(294_400_000, 40_000, 40_000, k, 4,
                                       False)
        assert t >= 294_400_000 / yardstick.HBM_BYTES_PER_S
        assert t >= 2 * 73_600_000 * k / yardstick.TF32_FLOP_PER_S
