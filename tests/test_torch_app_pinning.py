"""The reader's stem sets pinned by the port's app as the JAX engine pins
them, and the benchmark client's ``benchmarks.yml`` reader.

- Both apps from the same settings, their engines in process: after the
  uploads, a document delete, a store delete and a restart on the same
  ``DATA_DIR``, each package's ``textnorm._PINNED`` and ``_PIN_REFS``
  hold the same texts, stem sets and reference counts. The first chat
  after ingest finds every text it assembles already pinned.
- ``RAGTPU_ENGINE_RPC_MODE=connect``: the app's process takes no
  reference-counted pin; the engine behind the socket (built as
  ``engine_main`` builds it) pins nothing either.
- ``benchmark.runner.read_bench_config`` equals ``yaml.safe_load`` on
  ``benchmarks/quality/benchmarks.yml`` and on the scalar forms it
  reads, refuses what it does not read, and ``--config`` resolves the
  bench's questions, documents and knobs with PyYAML unimportable.
"""

import importlib
import json
import sys
from pathlib import Path

import pytest
import yaml

from rag_foundation_tpu_torch.benchmark import runner
from tests.test_torch_app_helpers import PACKAGES, App, build, mod

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "benchmarks" / "quality"
DOCS = {p.name: p.read_text() for p in sorted((QUALITY / "docs").glob("*.md"))}
STORE_A = ["telescope.md", "cryogenics.md", "staffing.md"]
STORE_B = ["telescope.md", "network.md"]    # telescope.md in both stores


@pytest.fixture()
def textnorms(monkeypatch):
    """Each package's ``textnorm`` with empty pin tables."""
    mods = {pkg: importlib.import_module(f"{name}.app.services.textnorm")
            for pkg, name in PACKAGES.items()}
    for tn in mods.values():
        monkeypatch.setattr(tn, "_PINNED", {})
        monkeypatch.setattr(tn, "_PIN_REFS", {})
    return mods


def _state(tn) -> tuple[dict, dict]:
    return dict(tn._PINNED), dict(tn._PIN_REFS)


def _upload(app, h, sid, name):
    r = app.client.post("/api/upload", headers=h,
                        data={"store_id": str(sid)},
                        files={"file": (name, DOCS[name].encode(),
                                        "text/markdown")})
    assert r.status_code == 201, r.text


def _fill(app) -> tuple[dict, dict, dict]:
    """Two stores of the quality documents, one document in both."""
    h = app.signup()
    sids = {}
    for store, names in (("A", STORE_A), ("B", STORE_B)):
        sids[store] = app.create_store(h, store)["id"]
        for name in names:
            _upload(app, h, sids[store], name)
    app.drain()
    docs = {row["filename"]: row["id"] for row in app.ctx.db.query(
        "SELECT id, filename FROM documents WHERE store_id=?", (sids["A"],))}
    return h, sids, docs


def test_pins_equal_the_jax_engines_through_delete_and_restore(
        tmp_path, textnorms):
    states = {"ingest": {}, "doc_delete": {}, "store_delete": {},
              "restore": {}}
    for pkg in ("jax", "port"):
        tn = textnorms[pkg]
        client, ctx = build(pkg, tmp_path / pkg)
        app = App(pkg, client, ctx)
        h, sids, docs = _fill(app)
        states["ingest"][pkg] = _state(tn)
        # a chunk of telescope.md pinned by both stores, once each
        engine = ctx.rag.engine
        chunks = [m.text for key in engine.list_stores()
                  for m in engine._store(key).chunks.values()]
        assert all(tn._PIN_REFS[t] >= 1 for t in chunks)
        assert max(tn._PIN_REFS.values()) >= 2
        # the first chat assembles only texts pinned at ingest
        pinned = set(tn._PINNED)
        r = client.post("/api/chat", headers=h, json_body={
            "question": "What coating does the primary mirror carry?",
            "store_ids": [sids["A"]]})
        assert r.status_code == 200 and "source-document" in r.text
        assert set(tn._PINNED) == pinned
        r = client.delete(f"/api/documents/{docs['cryogenics.md']}",
                          headers=h)
        assert r.status_code == 200, r.text
        states["doc_delete"][pkg] = _state(tn)
        # a store delete reaches the engine through the stale-store janitor
        r = client.delete(f"/api/stores/{sids['B']}", headers=h)
        assert r.status_code == 200, r.text
        assert mod(pkg, "app.services.cleanup").cleanup_stale_stores(
            ctx.db, ctx.rag, grace_s=-1.0) == 1
        states["store_delete"][pkg] = _state(tn)
        # a restart on the same DATA_DIR re-pins what the stores hold
        tn._PINNED.clear()
        tn._PIN_REFS.clear()
        _, ctx2 = build(pkg, tmp_path / pkg)
        assert ctx2.rag.engine.list_stores() == engine.list_stores()
        states["restore"][pkg] = _state(tn)
    for step, got in states.items():
        assert got["port"] == got["jax"], step
    ingest, doc_delete, store_delete, restore = (
        states[s]["port"] for s in states)
    assert len(ingest[1]) > len(doc_delete[1]) > len(store_delete[1]) > 0
    assert restore[1] == store_delete[1]


def test_connect_mode_takes_no_counted_pin(tmp_path, textnorms):
    from rag_foundation_tpu_torch.engine import Engine
    from rag_foundation_tpu_torch.engine.rpc import (EngineRpcServer,
                                                     RemoteEngine)
    tn = textnorms["port"]
    _, inproc_ctx = build("port", tmp_path / "inproc")
    sock = str(tmp_path / "engine.sock")
    # built as engine_main builds it: no stem_pins hook
    server = EngineRpcServer(Engine(inproc_ctx.rag.engine.config),
                             sock).start()
    try:
        client, ctx = build("port", tmp_path / "connect",
                            ENGINE_RPC_MODE="connect",
                            ENGINE_RPC_SOCKET=sock)
        assert isinstance(ctx.rag.engine, RemoteEngine)
        app = App("port", client, ctx)
        h, sids, _ = _fill(app)
        assert len(server.engine.list_stores()) == 2
        assert _state(tn) == ({}, {})
        r = client.post("/api/chat", headers=h, json_body={
            "question": "What coating does the primary mirror carry?",
            "store_ids": [sids["A"]]})
        assert r.status_code == 200 and "source-document" in r.text
        # hit assembly pins without a count; nothing holds a reference
        assert tn._PINNED and tn._PIN_REFS == {}
    finally:
        server.shutdown()
        ctx.rag.engine.close()


# -- benchmarks.yml without PyYAML ---------------------------------------------

def test_bench_config_reader_equals_safe_load_on_every_entry():
    text = (QUALITY / "benchmarks.yml").read_text()
    want = yaml.safe_load(text)
    got = runner.read_bench_config(text)
    assert set(got) == set(want) == {"quality", "quality_multiturn"}
    for name in want:
        assert got[name] == want[name], name
        assert [type(v) for v in got[name].values()] == \
            [type(v) for v in want[name].values()]


SCALARS = """\
# a comment
bench:
  name: plain words here   # trailing comment
  count: 42
  neg: -7
  ratio: 0.35
  small: .5
  flag: true
  other_flag: False
  legacy: yes
  nothing: ~
  empty:
  quoted: 'it''s quoted: here'
  path: a/b-c_d.jsonl
  text: >
    first line
    second line

    after a blank line
other:
  text: >
    one line
"""


def test_bench_config_reader_scalars_equal_safe_load():
    assert runner.read_bench_config(SCALARS) == yaml.safe_load(SCALARS)


@pytest.mark.parametrize("text", [
    "top: scalar\n",
    "bench:\n  list: [1, 2]\n",
    "bench:\n  map: {a: 1}\n",
    'bench:\n  q: "double"\n',
    "bench:\n  a: 1\n    b: 2\n",
    "bench:\n  nested:\n    deeper: 1\n",
    "bench:\n  t: >\n    folded\n      more indented\n",
    "bench:\n  t: |\n    literal\n",
    "bench:\n  octal: 0755\n",
    "bench:\n  minutes: 1:30\n",
    "bench:\n  day: 2001-12-14\n",
    "bench:\n  inf: .inf\n",
])
def test_bench_config_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        runner.read_bench_config(text)


def test_config_flag_resolves_the_bench_without_pyyaml(monkeypatch,
                                                       tmp_path):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    seen = {}

    class Client:
        def ensure_store(self, name):
            seen["store"] = name
            return {"id": 7}

        def upload_and_poll(self, store_id, path):
            seen.setdefault("docs", []).append(path.name)
            return {"status": "DONE"}

    def fake_run(client, store_id, questions, concurrency, top_k):
        seen.update(store_id=store_id, questions=questions,
                    concurrency=concurrency, top_k=top_k)
        return {"results": [], "summary": {"total": len(questions)}}

    monkeypatch.setattr(runner.ApiClient, "from_credentials",
                        classmethod(lambda cls, *a, **kw: Client()))
    monkeypatch.setattr(runner, "run_benchmark", fake_run)
    monkeypatch.setattr(sys, "argv", [
        "runner", "--base-url", "http://127.0.0.1:1", "--config",
        str(QUALITY / "benchmarks.yml"), "--bench", "quality_multiturn",
        "--out-dir", str(tmp_path / "out")])
    runner.main()
    turns = [json.loads(line) for line in (
        QUALITY / "questions_multiturn.jsonl").read_text().splitlines()
        if line.strip()]
    assert seen["store"] == "quality-meridian"
    assert seen["docs"] == sorted(DOCS)
    assert seen["questions"] == turns and len(turns) == 24
    assert all(q["history"] for q in seen["questions"])
    assert (seen["store_id"], seen["concurrency"], seen["top_k"]) == (7, 4, 5)
    assert json.loads((tmp_path / "out" / "summary.json").read_text()) == \
        {"total": 24}
