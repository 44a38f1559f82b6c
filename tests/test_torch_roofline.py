"""The port's bounds and peaks (``utils/roofline.py``), on the CPU.

``chip_smoke.py`` and ``tools/time_kernels.py`` each kept a copy of these
functions; each value below is what those copies gave for the same input,
so the move keeps every formula. The exponential floor and the share of
empty 16 x 16 blocks are new, and are pinned to a count by hand.
"""

import pytest
import torch

from rag_foundation_tpu_torch.utils import roofline

REL = 1e-12


def _lists():
    """Three lists of 256 slots: 192 live, none, 128 live."""
    row_ids = torch.tensor([[0, 1, -1, 3] * 64, [-1] * 256,
                            [5, -1, -1, 7] * 64], dtype=torch.int32)
    return row_ids, torch.tensor([3, 0, 16], dtype=torch.int32)


def _segments():
    """Rows of 100, 128 and 5 real tokens (1) then pads (0), S=128."""
    return torch.tensor([[1] * 100 + [0] * 28, [1] * 128, [1] * 5 + [0] * 123],
                        dtype=torch.int32)


@pytest.mark.parametrize("esize,kind,want", [
    (1, "int8", 7.901970149253731e-05), (2, "bf16", 0.00015673671641791044)])
def test_scan_bound(esize, kind, want):
    row_ids, live_n = _lists()
    ms, by, counts = roofline.scan_bound(row_ids, live_n, 16, 3, esize, 768,
                                         kind)
    assert (ms, by) == (pytest.approx(want, rel=REL), "bytes")
    assert counts == {"lists_read": 2, "live_slots": 19, "rows_needed": 320,
                      "rows_in_lists_read": 512}


@pytest.mark.parametrize("case,want", [
    ("int8 LUT", (3.8212537313432834e-05, "bytes")),
    ("bf16 LUT, packed codes", (4.646567164179105e-05, "bytes")),
    ("every slot live", (0.0010343434343434343, "operations"))])
def test_pq_scan_bound(case, want):
    row_ids, live_n = _lists()
    if case == "int8 LUT":
        got = roofline.pq_scan_bound(row_ids, live_n, 16, 8, 192, 192, 1)
    elif case == "bf16 LUT, packed codes":
        got = roofline.pq_scan_bound(row_ids, live_n, 16, 8, 192, 96, 2)
    else:
        full = torch.arange(4 * 2816, dtype=torch.int32).view(4, 2816)
        got = roofline.pq_scan_bound(full, torch.full((4,), 16), 16, 8, 192,
                                     192, 1)
    assert got[:2] == (pytest.approx(want[0], rel=REL), want[1])


@pytest.mark.parametrize("args,want", [
    ((1024, 640, 768), 0.15204352), ((8, 4096, 768), 0.00759227223880597)])
def test_gather_bound(args, want):
    assert roofline.gather_bound(*args) == (pytest.approx(want, rel=REL),
                                            "bytes")


@pytest.mark.parametrize("args,want", [
    ((1024, 1_000_000, 768, 10, 2, "bf16"),
     (1.5903579373104146, "operations")),
    ((33, 1000, 64, 7, 4, "f32"), (7.949134328358209e-05, "bytes"))])
def test_topk_bound(args, want):
    ms, by = roofline.topk_bound(*args)
    assert (ms, by) == (pytest.approx(want[0], rel=REL), want[1])


@pytest.mark.parametrize("full,want", [
    (False, 0.0003530507462686567), (True, 0.000941468656716418)])
def test_attention_bound(full, want):
    seg = torch.ones((2, 512), dtype=torch.int32) if full else _segments()
    ms, by, counts = roofline.attention_bound(seg, seg, 12, 32, 2)
    assert (ms, by) == (pytest.approx(want, rel=REL), "bytes")
    assert counts["pairs"] == roofline.same_segment_pairs(seg, seg)


@pytest.mark.parametrize("full,outputs,ops,want", [
    (False, 2, 8, (0.0005401217910447762, "bytes")),
    (False, 1, 6, (0.00045208835820895524, "bytes")),
    (True, 2, 8, (0.0016285265278058645, "operations")),
    (True, 1, 6, (0.0012213948958543985, "operations"))])
def test_attention_bwd_bound(full, outputs, ops, want):
    seg = torch.ones((2, 512), dtype=torch.int32) if full else _segments()
    ms, by, _ = roofline.attention_bwd_bound(seg, seg, 12, 32, 2, outputs,
                                             ops)
    assert (ms, by) == (pytest.approx(want[0], rel=REL), want[1])


def test_exp_floor_and_empty_blocks():
    seg = _segments()
    # 100^2 + 28^2 + 128^2 + 5^2 + 123^2 same-segment pairs
    pairs = 100 ** 2 + 28 ** 2 + 128 ** 2 + 5 ** 2 + 123 ** 2
    assert roofline.same_segment_pairs(seg, seg) == pairs
    assert roofline.exp_floor_ms(pairs, 12) == pytest.approx(
        pairs * 12 / (132 * 16 * 1.98e9) * 1e3, rel=REL)
    # at S=512 with every pair live: 805M exponentials, 0.193 ms
    assert roofline.exp_floor_ms(256 * 512 * 512, 12) == pytest.approx(
        0.1926, abs=1e-4)
    # row 0: groups 0-5 real, group 6 mixed (rows 96-99 real), group 7 pad:
    # 6 x 1 + 1 x 6 real x pad blocks are empty; row 1 none; row 2: group
    # 0 mixed, groups 1-7 pad: none empty
    assert roofline.empty_block_share(seg, seg) == pytest.approx(
        12 / (3 * 64), rel=REL)
    # a ragged S: the last group holds rows before S only
    assert roofline.empty_block_share(seg[:, :120], seg[:, :120]) \
        == pytest.approx(12 / (3 * 64), rel=REL)
    ids = torch.tensor([[0] * 16 + [1] * 16], dtype=torch.int32)
    assert roofline.empty_block_share(ids, ids) == pytest.approx(0.5)
