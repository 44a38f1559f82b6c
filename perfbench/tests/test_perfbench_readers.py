"""The per-layer readers of the program's device stages, waits and probe
counters on fake contexts: what each reads, and nothing (no raise) where
the program has no such stage or counter."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench.harness import load_module

METRICS = Path(__file__).resolve().parents[1] / "metrics"
PROFILE = {"q_copy": (0.030, 10), "device.upload": (0.004, 8),
           "device.route": (0.012, 8), "device.regather": (0.020, 8),
           "rows_fetch": (0.090, 8), "own_wait": (0.070, 8),
           "body_dispatch": (0.050, 10)}
# milliseconds a batch each reader finds in PROFILE
WANT = {"index.route_device_ms": 1.5, "index.regather_device_ms": 2.5,
        "index.upload_wait_ms": 3.0 - 0.5, "index.fetch_behind_ms": 2.5}
# the stages without which each reads nothing
NEEDS = {"index.route_device_ms": ["device.route"],
         "index.regather_device_ms": ["device.regather"],
         "index.upload_wait_ms": ["q_copy", "device.upload"],
         "index.fetch_behind_ms": ["rows_fetch", "own_wait"]}
TWINS = [(name + tail, want) for name, want in WANT.items()
         for tail in ("", ".pq")]


def reader(name):
    return load_module(METRICS / f"{name}.py")


@pytest.mark.parametrize("name,want", TWINS)
def test_a_stage_reader(name, want):
    r = reader(name)
    assert r.UNIT == "ms"
    assert r.read(SimpleNamespace(profile=PROFILE)) == pytest.approx(want)


@pytest.mark.parametrize("name", [n for n, _ in TWINS])
def test_a_stage_reader_without_its_stages(name):
    """The parent program, or the CPU (no CUDA events): nothing."""
    r = reader(name)
    for stage in NEEDS[name.removesuffix(".pq")]:
        got = {k: v for k, v in PROFILE.items() if k != stage}
        assert r.read(SimpleNamespace(profile=got)) is None, stage
    assert r.read(SimpleNamespace(profile={})) is None


@pytest.mark.parametrize("counts,want", [
    ({"probes": 4096, "probes_dropped": 512}, 12.5),
    ({"probes": 4096, "probes_dropped": 0}, 0.0),
    ({"probes": 0, "probes_dropped": 0}, None)])
def test_the_dropped_probe_share(monkeypatch, counts, want):
    r = reader("index.dropped_probe_pct")
    assert r.UNIT == "%"
    monkeypatch.setitem(sys.modules, r.PROFILE, SimpleNamespace(
        search_profile=SimpleNamespace(counts=lambda: counts)))
    assert r.read(SimpleNamespace()) == want


@pytest.mark.parametrize("module", [
    None, SimpleNamespace(search_profile=SimpleNamespace())])
def test_the_dropped_probe_share_without_counters(monkeypatch, module):
    """No program loaded, or one without the counters: nothing."""
    r = reader("index.dropped_probe_pct")
    if module is None:
        monkeypatch.delitem(sys.modules, r.PROFILE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, r.PROFILE, module)
    assert r.read(SimpleNamespace()) is None
