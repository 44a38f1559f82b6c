"""The port app's ``/metrics`` (Prometheus text from the port's own
registry, no prometheus_client) against the JAX app's
(``prometheus_client.generate_latest``), both parsed with
prometheus_client's parser: the same families, types, help texts, label
names and bucket bounds, and for the same traffic the same counts (as
deltas: the JAX app's registry is global to the process)."""

import math
import re
import subprocess
import sys
from pathlib import Path

from prometheus_client.parser import text_string_to_metric_families

from tests.test_torch_app_helpers import run_both

ROOT = Path(__file__).resolve().parents[1]
DOC = ("Penguins are flightless seabirds living almost exclusively in the "
       "southern hemisphere, especially Antarctica. " * 6)


def _families(text: str) -> dict:
    return {f.name: f for f in text_string_to_metric_families(text)}


def _samples(fams: dict) -> dict:
    """{(sample, labels): value} of every deterministic sample: all but
    the ``_created`` timestamps, and of a latency histogram only its
    ``_count`` (its buckets and sum depend on the clock)."""
    out = {}
    for name, fam in fams.items():
        if name.endswith("_created"):
            continue
        for s in fam.samples:
            if name.endswith("_seconds") and not s.name.endswith("_count"):
                continue
            labels = tuple(sorted(
                (k, re.sub(r"-[0-9a-f]{8}$", "-<hex>", v))
                for k, v in s.labels.items()))
            out[(s.name, labels)] = out.get((s.name, labels), 0) + s.value
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0) != 0}


def test_metrics_parse_to_the_same_families_and_counts(tmp_path):
    def scenario(app):
        before = app.client.get("/metrics").text
        h = app.signup()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC, "penguins.txt")
        app.drain()
        for q in ("Where do penguins live?", "What are penguins?"):
            app.client.post("/api/chat", headers=h, json_body={
                "question": q, "store_ids": [sid]})
        app.client.get("/api/stores/abc", headers=h)
        r = app.client.get("/metrics")
        assert r.headers["content-type"].startswith("text/plain")
        return before, r.text

    jax, port = run_both(tmp_path, scenario)
    (jb, ja), (pb, pa) = jax[-1][1], port[-1][1]
    jf, pf = _families(ja), _families(pa)
    base = sorted(n for n in jf if not n.endswith("_created"))
    assert sorted(n for n in pf if not n.endswith("_created")) == base
    assert len(base) == 12
    for name in base:
        assert (pf[name].type, pf[name].documentation) == \
            (jf[name].type, jf[name].documentation), name
    # every _created family of the port's is one of the JAX app's
    assert {n for n in pf if n.endswith("_created")} <= set(jf)
    # bucket bounds of every histogram child the traffic touched
    for name in base:
        if pf[name].type != "histogram":
            continue
        les = {s.labels["le"] for s in pf[name].samples
               if s.name.endswith("_bucket")}
        jles = {s.labels["le"] for s in jf[name].samples
                if s.name.endswith("_bucket")}
        assert les <= jles, name
    got = _delta(_samples(_families(pb)), _samples(pf))
    want = _delta(_samples(_families(jb)), _samples(jf))
    assert got == want
    assert got[("http_requests_total", (("method", "POST"),
                                        ("path", "/api/chat"),
                                        ("status", "200")))] == 2
    assert got[("engine_search_batch_size_count", ())] == 2
    assert any(k[0] == "engine_index_vectors" for k in got)


def test_metrics_render_counters_like_prometheus_client():
    """The counter's text by hand: ``# TYPE name counter`` with the
    ``_total`` sample, then its ``_created`` gauge family."""
    from rag_foundation_tpu_torch.engine.metrics import Counter

    c = Counter("t_requests_total", "Requests", ["path"])
    c.labels("/a").inc()
    c.labels(path="/a").inc(2)
    text = c.render()
    lines = text.splitlines()
    assert lines[:3] == ["# HELP t_requests_total Requests",
                         "# TYPE t_requests_total counter",
                         't_requests_total{path="/a"} 3.0']
    assert lines[3:5] == ["# HELP t_requests_created Requests",
                          "# TYPE t_requests_created gauge"]
    fams = _families(text)
    assert fams["t_requests"].type == "counter"
    assert [s.value for s in fams["t_requests"].samples] == [3.0]
    assert math.isclose(fams["t_requests_created"].samples[0].value,
                        c._created[("/a",)])
    try:
        c.labels("/a").inc(-1)
    except ValueError:
        pass
    else:
        raise AssertionError("a counter went down")


def test_port_app_imports_neither_pydantic_nor_prometheus_client():
    code = ("import sys\n"
            "import rag_foundation_tpu_torch.app.main\n"
            "import rag_foundation_tpu_torch.benchmark.runner\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('pydantic', 'prometheus_client', 'jax', 'rag_foundation_tpu')]"
            "\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)},
                   timeout=120)
