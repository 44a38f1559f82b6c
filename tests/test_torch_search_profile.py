"""``engine/profile.py``'s tracing of ``StoreIndex``'s search on the CPU:
the probe counters against ``build_dispatch``'s own count, the int8 scan's
row counters against the interleaved layout of known list sizes, the host
stages nested in the old ones, the device stages' arithmetic (fake
events: the CPU records none), and the ``index.*`` profiler ranges,
opened only while a profiler records and carrying the batch's number."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rag_foundation_tpu_torch.engine import ivf, ivfpq
from rag_foundation_tpu_torch.engine import profile as prof
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.engine.profile import (StageProfile,
                                                     search_profile)
from rag_foundation_tpu_torch.ops.quantize import quantize_int8

D, NLIST, NPROBE, Q = 32, 16, 4, 256
MODES = {"int8": dict(mode="ivf_flat_int8"), "f32": dict(mode="ivf_flat"),
         "pq": dict(mode="ivf_pq", pq_m=8)}
OLD = ("q_upload", "body_dispatch", "tail_dispatch", "tail_fetch",
       "rows_fetch", "idmap_merge")
NEW = {"q_upload": ("q_copy",), "body_dispatch": ("route", "scan",
                                                  "regather")}


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((4096, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    out = {}
    for name, kw in MODES.items():
        s = StoreIndex(D, nlist=NLIST, nprobe=NPROBE, build_threshold=4096,
                       device="cpu", **kw)
        s.add(rows, np.arange(len(rows)))
        assert s.body is not None and s.tail.count == 0
        out[name] = s
    return out, rows


def batches(rows):
    """A skewed batch (every query near one row: every query probes the
    same lists, past their ``qcap``), a uniform one, a skewed one."""
    rng = np.random.default_rng(1)
    skew = rows[7] + 0.01 * rng.standard_normal((Q, D)).astype(np.float32)
    return [skew, rows[rng.choice(len(rows), Q, replace=False)],
            skew[::-1].copy()]


@pytest.mark.parametrize("mode", list(MODES))
def test_dropped_probes_are_build_dispatchs_own_count(stores, mode,
                                                      monkeypatch):
    """Through ``search_many``: ``probes_dropped`` is the sum of what
    ``build_dispatch`` itself counted, and ``probes`` Q x nprobe a
    batch."""
    seen = []
    real = ivf.build_dispatch

    def counting(*args, **kw):
        out = real(*args, **kw)
        seen.append(int(out[3]))
        return out

    monkeypatch.setattr(ivf, "build_dispatch", counting)
    monkeypatch.setattr(ivfpq, "build_dispatch", counting)
    store, rows = stores[0][mode], stores[1]
    search_profile.reset()
    store.search_many(batches(rows), 10)
    got = search_profile.counts()
    assert len(seen) == 3 and seen[0] > 0 and seen[2] > 0
    assert {k: got[k] for k in ("probes", "probes_dropped")} == {
        "probes": 3 * Q * NPROBE, "probes_dropped": sum(seen)}


def test_a_small_batch_counts_its_probes_and_drops_none(stores):
    """``ivf_search_small`` (Q x nprobe x 8 <= nlist) has no ``qcap``."""
    store, rows = stores[0]["int8"], stores[1]
    search_profile.reset()
    store.search_many([rows[:1], rows[1:2]], 10)
    got = search_profile.counts()
    assert {k: got[k] for k in ("probes", "probes_dropped")} == {
        "probes": 2 * NPROBE, "probes_dropped": 0}
    assert search_profile.calls["route"] == 2


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_new_stages_nest_in_the_old(stores, mode):
    """One call a batch of each old stage, as before; the new stages
    once a batch each, inside their old stage's seconds."""
    store, rows = stores[0][mode], stores[1]
    search_profile.reset()
    store.search_many(batches(rows), 10)
    calls, secs = search_profile.calls, search_profile.seconds
    for name in OLD + ("q_quantize",) + sum(NEW.values(), ()):
        assert calls[name] == 3, name
    for outer, inner in NEW.items():
        assert sum(secs[n] for n in inner) <= secs[outer]
    assert secs["q_quantize"] + secs["q_copy"] <= secs["q_upload"]
    # the CPU records no event: no device stage, no own_wait
    assert not [n for n in calls if n.startswith("device.")]
    assert "own_wait" not in calls


# rows a list, laid out as the index interleaves them over cap_len // 128
# sub-blocks: none, one, live extents of at most 32, 64 and 128 rows, all
SIZES = (0, 1, 7, 31 * 5, 32 * 5 + 1, 64 * 5, 64 * 5 + 3, 640)
CAP_LEN = 640


def _known_store(nlist):
    """A store whose body has ``nlist`` lists of ``SIZES`` rows in turn."""
    rng = np.random.default_rng(5)
    cap_len = CAP_LEN
    sizes = [SIZES[l % len(SIZES)] for l in range(nlist)]
    centroids = rng.standard_normal((nlist, D)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    rows = rng.standard_normal((sum(sizes), D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    assign = np.repeat(np.arange(nlist), sizes)
    rank = np.concatenate([np.arange(m) for m in sizes])
    dest = assign * cap_len + ivf.interleave_slots(rank, cap_len)
    q, scale = quantize_int8(torch.as_tensor(rows))
    lists = torch.zeros((nlist * cap_len, D), dtype=torch.int8)
    lists[torch.as_tensor(dest)] = q
    ids = torch.full((nlist * cap_len,), -1, dtype=torch.int32)
    ids[torch.as_tensor(dest)] = torch.arange(len(rows), dtype=torch.int32)
    body = ivf.IVFFlatIndex(torch.as_tensor(centroids),
                            lists.view(nlist, cap_len, D),
                            ids.view(nlist, cap_len),
                            float(np.float32(scale)), len(rows))
    store = StoreIndex(D, nlist=nlist, nprobe=2, device="cpu",
                       **MODES["int8"])
    store.adopt_body(body, np.arange(len(rows)))
    return store, rows, sizes


def _interleaved_rows(m: int, nsub: int, blocks: int) -> tuple[int, int]:
    """(live rows, stage rows) of a pass of ``ivf_scan_s8`` over a list of
    m rows: sub-block b holds ranks b, b + nsub, ... (``interleave_slots``),
    so its live extent is ceil((m - b) / nsub); block j of the list's
    ``blocks`` takes sub-blocks j, j + blocks, ... and packs their extents
    in order into groups of at most 128 rows, 128 stage rows a group."""
    extents = [-(-(m - b) // nsub) if b < m else 0 for b in range(nsub)]
    groups = 0
    for j in range(blocks):
        fill = 129
        for e in extents[j::blocks]:
            if e and fill + e > 128:
                groups, fill = groups + 1, 0
            fill += e
    return m, 128 * groups


@pytest.mark.parametrize("nlist,blocks", [(8, 5), (264, 1)])
def test_scan_rows_are_the_interleaved_layouts(monkeypatch, nlist, blocks):
    """Through ``search_many`` on lists of known sizes: each probed int8
    list adds its rows and the stage rows its interleaved layout implies,
    a pass of 16 query slots at a time (lists of no query add nothing);
    its sub-blocks split over five blocks (small nlist: each one a group)
    or one (extents packed); over more than ``SCAN_FOLD`` batches, so the
    device sums are exercised."""
    seen = []
    real = ivf.build_dispatch

    def capturing(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[1])
        return out

    monkeypatch.setattr(ivf, "build_dispatch", capturing)
    store, rows, sizes = _known_store(nlist)
    rng = np.random.default_rng(2)
    # batches of 40 queries at stored rows, padded to 64: at most 16 slots
    # a list where nlist is 264, qcap 32 (two passes of 16) where it is 8
    picks = [rng.choice(len(rows), 40) for _ in range(prof.SCAN_FOLD + 3)]
    search_profile.reset()
    store.search_many([rows[i] + 0.01 for i in picks], 10)
    got = search_profile.counts()
    nsub = CAP_LEN // 128
    per_list = np.asarray([_interleaved_rows(m, nsub, blocks) for m in sizes])
    want = np.zeros(2, np.int64)
    for dispatch in seen:
        n = (dispatch >= 0).sum(dim=1).numpy()
        want += ((-(-n // 16))[:, None] * per_list).sum(axis=0)
    assert len(seen) == prof.SCAN_FOLD + 3 and want[0] > 0
    if nlist == 8:
        assert max(int((d >= 0).sum(dim=1).max()) for d in seen) > 16
    assert (got["scan_rows_live"], got["scan_rows_staged"]) == tuple(want)
    assert 0 < got["scan_rows_live"] < got["scan_rows_staged"]


@pytest.mark.parametrize("mode", ["f32", "pq"])
def test_scan_rows_count_only_int8_lists(stores, mode):
    """f32 lists take another route and PQ bodies another kernel."""
    store, rows = stores[0][mode], stores[1]
    search_profile.reset()
    store.search_many(batches(rows), 10)
    got = search_profile.counts()
    assert got["probes"] > 0
    assert got["scan_rows_live"] == got["scan_rows_staged"] == 0


def test_scan_rows_sum_passes_on_the_device():
    """A held scan adds its lists' passes (live slots over ``slots``,
    rounded up) times their rows; past ``SCAN_FOLD`` scans they are
    summed."""
    p = StageProfile()
    rows = torch.tensor([[10, 32], [5, 64], [7, 128]])
    live_n = torch.tensor([17, 0, 3], dtype=torch.int32)
    for _ in range(prof.SCAN_FOLD + 1):
        p.count_scan_rows(live_n, rows, 16)
    assert len(p._scans) == 1
    n = prof.SCAN_FOLD + 1
    assert p.counts() == {"probes": 0, "probes_dropped": 0,
                          "scan_rows_live": n * (2 * 10 + 7),
                          "scan_rows_staged": n * (2 * 32 + 128)}
    p.reset()
    assert p.counts()["scan_rows_staged"] == 0


class FakeEvent:
    """Records the next time of a fixed list; ``elapsed_time`` in ms."""
    times = iter([])

    def record(self, stream):
        self.t = next(FakeEvent.times)

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_stages_and_reset(monkeypatch):
    """Each device stage runs from the event before it; the events go
    back to the pool; ``reset`` clears host and device stages and the
    counters."""
    p = StageProfile()
    monkeypatch.setattr(p, "_event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "times", iter([1.0, 3.0, 6.0, 10.0,
                                                  15.0]))
    batch = prof.Batch(p, 0, stream="s")
    with batch:
        with p.stage("q_upload"), p.stage("q_quantize"):
            pass
        with p.stage("q_upload"), p.stage("q_copy"):
            pass
        with p.stage("body_dispatch"):
            for name in ("route", "scan", "regather"):
                with p.stage(name):
                    pass
    assert [m[0] for m in batch.marks] == ["start", "q_copy", "route",
                                           "scan", "regather"]
    p.close_batch(batch)
    assert batch.marks is None and len(p._events) == 5
    assert {k: (p.seconds[k], p.calls[k]) for k in p.seconds
            if k.startswith("device.")} == {
        "device.upload": (0.002, 1), "device.route": (0.003, 1),
        "device.scan": (0.004, 1), "device.regather": (0.005, 1)}
    p.count_probes(40, torch.tensor(3, dtype=torch.int32))
    p.count_probes(8)
    p.count_probes(40, torch.tensor(2, dtype=torch.int32))
    assert p.counts() == {"probes": 88, "probes_dropped": 5,
                          "scan_rows_live": 0, "scan_rows_staged": 0}
    # past FOLD held scalars, they are summed into the accumulator
    for _ in range(prof.FOLD + 1):
        p.count_probes(1, torch.tensor(1, dtype=torch.int32))
    assert len(p._pending) == 1
    assert p.counts() == {"probes": 89 + prof.FOLD,
                          "probes_dropped": 6 + prof.FOLD,
                          "scan_rows_live": 0, "scan_rows_staged": 0}
    p.reset()
    assert dict(p.seconds) == {} and dict(p.calls) == {}
    assert p.counts() == {"probes": 0, "probes_dropped": 0,
                          "scan_rows_live": 0, "scan_rows_staged": 0}


def test_no_range_opens_without_a_profiler(stores, monkeypatch):
    opened = []
    real = prof._RANGE

    def counting(*args):
        opened.append(args[0])
        return real(*args)

    monkeypatch.setattr(prof, "_RANGE", counting)
    store, rows = stores[0]["pq"], stores[1]
    store.search_many(batches(rows), 10)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        store.search_many(batches(rows)[:1], 10)
    assert "index.body_dispatch" in opened and "index.scan" in opened


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_ranges_carry_the_batch_number(stores, mode):
    """Under a capture every stage is an ``index.<stage>`` range with its
    batch's number: a batch's dispatch and finalize carry one number, and
    each new stage lies inside its old stage of the same batch."""
    store, rows = stores[0][mode], stores[1]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as p:
        store.search_many(batches(rows), 10)
    spans = {}
    for e in p.events():
        if e.name.startswith("index."):
            spans.setdefault(e.name[6:], []).append(
                (e.kwinputs["batch"], e.time_range.start, e.time_range.end))
    nums = sorted(b for b, _, _ in spans["body_dispatch"])
    assert len(nums) == 3 and nums == list(range(nums[0], nums[0] + 3))
    for name in OLD:
        assert sorted(b for b, _, _ in spans[name]) == nums, name
    for outer, inner in NEW.items():
        for name in inner:
            for b, a, z in spans[name]:
                assert any(b == ob and oa <= a and z <= oz
                           for ob, oa, oz in spans[outer]), name


def test_the_cost_tool_on_the_cpu():
    """``tools/trace_cost.py`` replays a batch's tracing (microseconds a
    batch; the numbers that count come from the card)."""
    from rag_foundation_tpu_torch.tools import trace_cost
    out = trace_cost.main(["--device", "cpu", "--reps", "40"])
    assert out["device"] == "cpu" and out["reps"] == 40
    assert out["old_us"] > 0
    assert {"always_on_us", "profiled_us"} <= set(out)


def test_the_operators_capture_carries_the_batch_number(stores, tmp_path,
                                                        monkeypatch):
    """``maybe_trace`` (``RAGTPU_TRACE_DIR``) records shapes, so its trace
    file holds each stage's range with its batch's number."""
    import json

    from rag_foundation_tpu_torch.utils.profiling import maybe_trace
    monkeypatch.setenv("RAGTPU_TRACE_DIR", str(tmp_path))
    store, rows = stores[0]["int8"], stores[1]
    with maybe_trace("search"):
        store.search_many(batches(rows)[:2], 10)
    (trace,) = tmp_path.glob("search.*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    got = {}
    for e in events:
        if e.get("name", "").startswith("index."):
            got.setdefault(e["name"], set()).add(e["args"]["batch"])
    assert len(got["index.body_dispatch"]) == 2
    assert got["index.rows_fetch"] == got["index.body_dispatch"]
    assert got["index.scan"] == got["index.body_dispatch"]
