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


def _attention_segments(full):
    """The rows of ``test_attention_bound``'s cases: False ``_segments()``;
    True B=2, S=512 every token real; "short" B=256, S=32 every token
    real; "chunks" B=4, S=512, 300 real tokens then pads."""
    if full == "short":
        return torch.ones((256, 32), dtype=torch.int32)
    if full == "chunks":
        return (torch.arange(512)[None, :] < 300).int().expand(4, 512) \
            .contiguous()
    return torch.ones((2, 512), dtype=torch.int32) if full else _segments()


@pytest.mark.parametrize("full,want", [
    (False, 0.0003530507462686567), (True, 0.000941468656716418),
    ("short", 0.007531749253731344), ("chunks", 0.001882937313432836)])
def test_attention_bound(full, want):
    """``want`` is the bytes time; the bound is the larger of it, the
    tensor-core operations and one exponential a same-segment pair."""
    seg = _attention_segments(full)
    ms, by, counts = roofline.attention_bound(seg, seg, 12, 32, 2)
    pairs = roofline.same_segment_pairs(seg, seg)
    assert counts["pairs"] == pairs
    assert counts["bytes"] / roofline.HBM_BYTES_S * 1e3 == pytest.approx(
        want, rel=REL)
    exp_ms = roofline.exp_floor_ms(pairs, 12)
    assert counts["exponentials"] == pairs * 12
    assert counts["exp_floor_ms"] == pytest.approx(exp_ms, rel=REL)
    ops_ms = 4.0 * 12 * 32 * pairs / roofline.PEAK_OPS_S["bf16"] * 1e3
    assert (ms, by) == (pytest.approx(max(want, ops_ms, exp_ms), rel=REL),
                        "bytes" if want >= max(ops_ms, exp_ms)
                        else "operations")
    if full is True:
        # every pair at S=512: 6.3M exponentials outweigh the bytes
        assert by == "operations" and ms == pytest.approx(exp_ms, rel=REL)
    if full == "chunks":
        # 32-row warps and 64-key tiles: a real row's warp (rows 0-287)
        # computes the 5 tiles of keys 0-319, a pad row's warp (rows
        # 320-511) the 4 tiles of keys 256-511, the warp of rows 288-319
        # all 8: (9 x 5 + 6 x 4 + 8) blocks of 32 x 64 pairs a row and head
        assert roofline.fwd_tile(512, 32) == (32, 64)
        assert counts["exponentials_issued"] == \
            4 * 12 * (9 * 5 + 6 * 4 + 8) * 32 * 64


@pytest.mark.parametrize("s,d,want", [(1, 32, (16, 32)), (32, 32, (16, 32)),
                                      (33, 32, (32, 64)), (255, 32, (32, 64)),
                                      (256, 32, (32, 64)), (512, 64, (16, 64))])
def test_fwd_tile(s, d, want):
    assert roofline.fwd_tile(s, d) == want


def test_fwd_exponentials_issued():
    seg = _segments()
    # 32-row warps, 64-key tiles at S=128. Row 0 (100 real): warps 0-2 real
    # meet tile 0 (ids 1) and tile 1 (ids 1, 0); warp 3 (rows 96-127,
    # mixed) meets both: 8 blocks. Row 1 (all real): 8. Row 2 (5 real):
    # warp 0 (mixed) meets both tiles, warps 1-3 (pads) both too (tile 0
    # holds pads from key 5 on): 8.
    assert roofline.fwd_exponentials_issued(seg, seg, 12, 32) \
        == (8 + 8 + 8) * 32 * 64 * 12
    # 16-row warps at D=64: row 0's warp 7 (rows 112-127, pads) meets only
    # tile 1: 15 blocks; rows 1 and 2: 16 each
    assert roofline.fwd_exponentials_issued(seg, seg, 12, 64) \
        == (15 + 16 + 16) * 16 * 64 * 12
    # ids that never meet: nothing is computed
    q = torch.zeros((1, 64), dtype=torch.int32)
    assert roofline.fwd_exponentials_issued(q, q + 1, 3, 32) == 0


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
