"""The frozen yardstick of ``perfbench/roofline.py`` on hand-counted
dispatches."""

import pytest
import torch

from perfbench import roofline

# three lists of 10, 20 and 30 live rows and an empty one
LIVE = torch.tensor([10, 20, 30, 0])


@pytest.mark.parametrize("probes,rows,pairs", [
    ([[0, 1], [1, 2]], 60, 80),        # list 1 read once for two queries
    ([[2, 3]], 30, 30),                # an empty list costs nothing
    ([[0, 1], [0, 1], [0, 1]], 30, 90),
    ([[3, 2], [2, 3]], 30, 60),
])
def test_probed_work(probes, rows, pairs):
    assert roofline.probed_work(torch.tensor(probes), LIVE) == (rows, pairs)


def test_flat_scan_bytes_bound():
    # 60 rows of 4 int8 bytes and their 4-byte ids, 2 queries of 4 bytes
    s = roofline.flat_scan_s(2, 4, 1, "int8", 60, 80)
    assert s == pytest.approx((60 * 8 + 8) / 3.35e12)


def test_flat_scan_operations_bound():
    # one row, a million queries on it: 2 d operations a pair dominate
    s = roofline.flat_scan_s(1, 768, 1, "int8", 1, 10**9)
    assert s == pytest.approx(2 * 768 * 1e9 / 1.979e15)
    bf = roofline.flat_scan_s(1, 768, 2, "bf16", 1, 10**9)
    assert bf == pytest.approx(2 * 768 * 1e9 / 0.989e15)


def test_adc_scan_bounds():
    # 60 rows of 192 one-byte codes + ids, 2 queries' 16 x 192 int8 tables
    s = roofline.adc_scan_s(2, 192, 192, 16, 1, 60, 80)
    assert s == pytest.approx((60 * 196 + 2 * 16 * 192) / 3.35e12)
    # 192 lookups a pair at the shared-memory rate
    s = roofline.adc_scan_s(1, 192, 96, 16, 1, 1, 10**8)
    assert s == pytest.approx(192e8 / (132 * 128 * 1.98e9))


def test_ten_million_rows_q1024():
    """The headline cell's order of magnitude: every list probed, 10M
    rows of 768 int8 bytes and their ids, 2.3 ms of HBM."""
    s = roofline.flat_scan_s(1024, 768, 1, "int8", 10_000_000,
                             1024 * 32 * 2441)
    assert 2.2e-3 < s < 2.4e-3
