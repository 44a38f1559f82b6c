"""The whole run on the CPU at a tiny size (the kernels' plain
versions), as ``python3 -m perfbench.run`` in a copy of the benchmark:
the result line, the refusals, and a cell added by files alone."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.conftest import REPO, make_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
E2E = {"qps", "batch_p95_ms", "recall_at_10", "build_vec_s", "setup_s"}
# the PQ cell's host-paced metrics spread too widely on the card for a
# bound: it reports them per layer (``index.qps``, ``index.batch_p95_ms``,
# ``build.vec_s``)
E2E_OF = {"ivf_pq_10m.q1024": {"recall_at_10", "setup_s"},
          "ivf_pq_10m.q64": {"recall_at_10", "setup_s"}}


def run(root: Path, *args, device="cpu", pythonpath=True, pre=""):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if pythonpath:
        env["PYTHONPATH"] = str(REPO)
    argv = [*args] + (["--device", device] if device else [])
    code = (f"import sys; {pre}from perfbench.harness import main; "
            f"sys.exit(main({argv!r}))")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["ivf_int8_10m.q1024", "ivf_pq_10m.q1024",
                                  "ivf_int8_10m.q64", "ivf_pq_10m.q64"])
def test_a_cell_runs_end_to_end(tiny_root, cell):
    proc = run(tiny_root, "--workload", cell, "--seed", "2147483777",
               "--seconds", "1", "--trace", "0")
    out = last_line(proc)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == E2E_OF.get(cell, E2E)
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert 0.5 < out["metrics"]["recall_at_10"]["value"] <= 1
    assert out["attempted"] > 0
    # the numbers compared are the last lines of standard error too
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {name}" for name in out["checks"]]


def test_a_traced_run(tiny_root):
    out = last_line(run(tiny_root, "--workload", "ivf_int8_10m.q64",
                        "--seed", "5", "--seconds", "3", "--trace", "1"))
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: only the host stages' metrics and the
    # program's counters read
    assert set(out["metrics"]) == {"index.dispatch_host_ms",
                                   "index.merge_host_ms",
                                   "index.dropped_probe_pct"}
    assert list(out)[-1] == "checks"


def test_a_traced_pq_run(tiny_root):
    """The PQ cell's host-paced rates come per layer, read over the
    untraced part of the window."""
    out = last_line(run(tiny_root, "--workload", "ivf_pq_10m.q1024",
                        "--seed", "6", "--seconds", "3", "--trace", "1"))
    assert out["correct"] is True
    # the CPU has no device trace: the roofline and idle share read none
    assert set(out["metrics"]) == {
        "index.qps", "index.batch_p95_ms", "build.vec_s",
        "index.dispatch_host_ms.pq", "index.merge_host_ms.pq",
        "index.dropped_probe_pct"}
    assert all(m["value"] > 0 for m in out["metrics"].values()
               if m is not out["metrics"]["index.dropped_probe_pct"])
    assert out["metrics"]["index.qps"]["value"] <= out["attempted"] / 1.5


def test_served_rates_count_all_work_over_all_time():
    """Every batch finalized by the close counts, over the time from the
    window's start to the close; a batch finalized later does not."""
    handed = [0.0, 1.0, 2.0, 3.0]
    done = [2.0, 3.0, 4.5, 6.0]
    got = harness.served_rates(handed, done, 0.0, 5.0, 8)
    assert got["qps"] == 3 * 8 / 5.0
    assert got["batch_p95_ms"] == pytest.approx(
        np.percentile([2000.0, 2000.0, 2500.0], 95))
    with pytest.raises(SystemExit):
        harness.served_rates(handed, done, 0.0, 1.0, 8)


def test_no_card_no_result(tiny_root):
    proc = run(tiny_root, "--workload", "ivf_int8_10m.q64", "--seed", "1",
               "--seconds", "1", device=None)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tiny_root):
    """A directory holding BENCHMARK.json and perfbench/ alone: the
    program is missing, so no result."""
    proc = run(tiny_root, "--workload", "ivf_int8_10m.q64", "--seed", "1",
               "--seconds", "1", pythonpath=False)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_jax_loaded_no_result(tiny_root):
    proc = run(tiny_root, "--workload", "ivf_int8_10m.q64", "--seed", "1",
               "--seconds", "1",
               pre="import types; sys.modules['jax'] = "
                   "types.ModuleType('jax'); ")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "jax" in proc.stderr


LOAD_JAX = "sys.modules.__setitem__('jax', types.ModuleType('jax'))"


@pytest.mark.parametrize("where", ["metric_reader", "program_state"])
def test_jax_loaded_after_the_window_no_result(tmp_path, where):
    """Code that runs after the window (the program's state read for the
    reference, a per-layer reader) loads JAX: no result line."""
    root = make_tiny(tmp_path)
    pre = ""
    if where == "metric_reader":
        (root / "perfbench" / "metrics" / "index.jax_ms.py").write_text(
            f"import sys\nimport types\n\nUNIT = \"ms\"\n\n\n"
            f"def read(ctx):\n    {LOAD_JAX}\n    return 1.0\n")
        bench = json.loads((root / "BENCHMARK.json").read_text())
        bench["per_layer"].append({
            "name": "index.jax_ms", "unit": "ms", "better": "lower",
            "source": "program_span", "layer": "index", "moves": "qps"})
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
    else:
        pre = ("import types; import perfbench.systems as s; "
               "real = s.Built.state; s.Built.state = lambda self, x: "
               f"({LOAD_JAX}, real(self, x))[1]; ")
    proc = run(root, "--workload", "ivf_int8_10m.q64", "--seed", "1",
               "--seconds", "1", "--trace", "1" if where == "metric_reader"
               else "0", pre=pre)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "jax" in proc.stderr.splitlines()[-1]


def test_a_cell_added_by_files_alone(tmp_path):
    root = make_tiny(tmp_path)
    data = root / "perfbench"
    cfg = json.loads((data / "configs" / "ivf_int8_10m.json").read_text())
    cfg.update(name="extra", nprobe=8)
    (data / "configs" / "extra.json").write_text(json.dumps(cfg))
    (data / "traffic" / "q128.json").write_text(json.dumps(
        {"batch": 128, "pool": 512, "qnoise": 0.2, "skew": 1.1}))
    (data / "metrics" / "index.upload_host_ms.py").write_text(
        'UNIT = "ms"\n\n\ndef read(ctx):\n'
        '    s, n = ctx.profile.get("q_upload", (0.0, 0))\n'
        '    return s / n * 1e3 if n else None\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra", "source": "a test",
                             "file": "perfbench/configs/extra.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "extra.q128", "config": "extra",
                               "traffic": "q128", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "index.upload_host_ms", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "index", "moves": "qps",
        "workloads": ["extra.q128"]})
    for m in bench["end_to_end"]:
        if "ivf_int8_10m.q64" in m.get("workloads", []):
            m["workloads"].append("extra.q128")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = last_line(run(root, "--workload", "extra.q128", "--seed", "9",
                        "--seconds", "1", "--trace", "1"))
    assert out["correct"] is True
    assert "index.upload_host_ms" in out["metrics"]
    out = last_line(run(root, "--workload", "extra.q128", "--seed", "9",
                        "--seconds", "2", "--trace", "0"))
    assert out["correct"] is True
    assert set(out["metrics"]) == E2E
    # a closed loop: every batch handed over is a whole batch of 128, and
    # those done inside the window are at most all of them
    assert out["attempted"] % 128 == 0 and out["attempted"] > 0
    assert out["metrics"]["qps"]["value"] <= out["attempted"] / 2


@pytest.mark.cuda
def test_a_traced_part_without_device_operations_is_traced_again(
        monkeypatch):
    """On the card: the window's traced part is made to read as if the
    profiler had recorded no device operation; the run traces the same
    traffic again and reports the card busy."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import harness, trace
    real = trace.Tracer._read
    reads = []

    def first_empty(self):
        real(self)
        reads.append(self.busy_s)
        if len(reads) == 1:
            self.kernels, self.busy_s = {}, 0.0
    monkeypatch.setattr(trace.Tracer, "_read", first_empty)
    args = harness.parse(["--workload", "ivf_int8_10m.q64", "--seed",
                          "2147495002", "--seconds", "4", "--trace", "1"])
    out = harness.run(args, REPO, 0.0)
    assert len(reads) == 2 and out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert "ivf_list_scan_roofline" in out["metrics"]
