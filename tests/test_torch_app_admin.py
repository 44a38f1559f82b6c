"""The port app's admin, settings and costs routes against the JAX app's:
the cases of ``tests/test_app_admin_security.py`` (RBAC, user management
and audit, notes and budgets, system counts, branding settings, the
recall probe) run through both apps from the same settings and give the
same statuses and bodies, timestamps masked. Also the recall probe's
repair: on an ``ivf_pq`` store whose stored rows are gone (as after
loading an old checkpoint) both engines' ``recall_probe`` return the
same ``skipped`` dict and the admin route answers 200."""

import shutil

import pytest

from tests.test_torch_app_helpers import App, build, run_both

DOC = ("Quarterly revenue grew twelve percent driven by cloud "
       "subscriptions and enterprise contracts. " * 8)

_SYL = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "zu", "pe", "shi")


def _facts(lo: int, hi: int) -> str:
    """One document of made-up project facts, a sentence each."""
    return " ".join(
        f"Project {_SYL[i % 10]}{_SYL[i // 10 % 10]}{_SYL[i // 100 % 10]}"
        f" has the codename ZEBRA{i * 7} and sits in sector {i % 23}."
        for i in range(lo, hi))


ADMIN_ROUTES = [
    ("GET", "/api/admin/users", None),
    ("PATCH", "/api/admin/users/1", {"role": "admin"}),
    ("PUT", "/api/admin/budgets/1", {"monthly_usd": "5"}),
    ("GET", "/api/admin/audit", None),
    ("GET", "/api/admin/system", None),
    ("POST", "/api/admin/watchdog/reset-stuck", None),
    ("POST", "/api/admin/engine/recall-probe", {"store_id": 1}),
    ("GET", "/api/admin/deletions", None),
    ("POST", "/api/admin/documents/1/restore", None),
    ("POST", "/api/admin/stores/1/restore", None),
    ("PUT", "/api/settings", {"app_name": "x"}),
]


def test_admin_endpoints_require_admin(tmp_path):
    def scenario(app):
        for method, path, body in ADMIN_ROUTES:
            app.see(app.client.request(method, path, json_body=body),
                    f"anonymous {method} {path}")
        h = app.signup()
        for method, path, body in ADMIN_ROUTES:
            app.see(app.client.request(method, path, json_body=body,
                                       headers=h), f"user {method} {path}")

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    statuses = [s for note, s, _ in port if note.startswith(("anon",
                                                              "user "))]
    n = len(ADMIN_ROUTES)
    assert statuses[:n] == [401] * n and statuses[n:] == [403] * n


def test_admin_user_management_and_audit(tmp_path):
    def scenario(app):
        h_admin = app.signup("admin@example.com")
        app.make_admin("admin@example.com")
        app.signup("u@example.com")
        users = app.see(app.client.get("/api/admin/users",
                                       headers=h_admin)).json()["users"]
        uid = next(u["id"] for u in users if u["email"] == "u@example.com")
        admin_id = next(u["id"] for u in users
                        if u["email"] == "admin@example.com")
        for body in ({"role": "admin"}, {"role": "root"}, {},
                     {"is_active": False}, {"is_active": True}):
            app.see(app.client.patch(f"/api/admin/users/{uid}",
                                     headers=h_admin, json_body=body),
                    f"patch {body}")
        for body in ({"role": "user"}, {"is_active": False}):
            app.see(app.client.patch(f"/api/admin/users/{admin_id}",
                                     headers=h_admin, json_body=body),
                    f"self {body}")
        app.see(app.client.patch("/api/admin/users/999", headers=h_admin,
                                 json_body={"role": "user"}), "no user")
        for amount in ("12.50", "-1", "abc", None, 3, 0.1, "1e2"):
            app.see(app.client.put(f"/api/admin/budgets/{uid}",
                                   headers=h_admin,
                                   json_body={"monthly_usd": amount}),
                    f"budget {amount!r}")
        app.see(app.client.put("/api/admin/budgets/999", headers=h_admin,
                               json_body={"monthly_usd": "1"}), "no user")
        app.see(app.client.get("/api/admin/audit", headers=h_admin))
        app.see(app.client.patch(f"/api/admin/users/{uid}", headers=h_admin,
                                 json_body={"role": "user",
                                            "is_active": False}))
        app.see(app.client.post("/api/auth/login", json_body={
            "email": "u@example.com", "password": "Passw0rd-123"}),
            "deactivated login")
        app.see(app.client.get("/api/admin/users", headers=h_admin))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    by_note = {note: (s, b) for note, s, b in port}
    assert by_note["self {'role': 'user'}"][0] == 409
    assert by_note["self {'is_active': False}"][0] == 409
    assert by_note["budget '12.50'"] == (200, {
        "status": "updated", "user_id": 2, "monthly_usd": "12.50"})
    assert by_note["budget '-1'"][0] == 422
    assert by_note["deactivated login"][0] == 401
    actions = {a["action"] for _, s, b in port if isinstance(b, dict)
               for a in b.get("audit", [])}
    assert {"user_update", "budget_set"} <= actions


def test_admin_notes_and_budget_in_user_list(tmp_path):
    def scenario(app):
        h_admin = app.signup("admin@example.com")
        app.make_admin("admin@example.com")
        app.signup("u@example.com")
        uid = 2
        for body in ({"admin_notes": "pilot cohort"},
                     {"admin_notes": ""}, {"admin_notes": None},
                     {"admin_notes": "x" * 2000},
                     {"admin_notes": "x" * 2001}, {"admin_notes": 42}):
            app.see(app.client.patch(f"/api/admin/users/{uid}",
                                     headers=h_admin, json_body=body),
                    f"notes {str(body)[:30]}")
            app.see(app.client.get("/api/admin/users", headers=h_admin))
        app.see(app.client.put(f"/api/admin/budgets/{uid}", headers=h_admin,
                               json_body={"monthly_usd": "7.25"}))
        app.see(app.client.get("/api/admin/users", headers=h_admin))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    last = port[-1][2]["users"]
    assert last[1]["monthly_usd"] == "7.25"
    assert [s for note, s, _ in port if note.startswith("notes")] == [
        200, 200, 200, 200, 422, 422]


def test_admin_system_counts_equal_the_sqlite_rows(tmp_path):
    def scenario(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.create_store(h, "Other")
        app.upload_text(h, sid, DOC)
        app.upload_text(h, sid, DOC, "two.txt")
        app.drain()
        app.see(app.client.post("/api/chat", headers=h, json_body={
            "question": "How did revenue grow?", "store_ids": [sid]}))
        counts = app.see(app.client.get("/api/admin/system",
                                        headers=h)).json()
        db = app.ctx.db
        rows = {t: db.one(f"SELECT COUNT(*) AS n FROM {t}")["n"]
                for t in ("users", "stores", "documents", "query_log",
                          "chat_sessions")}
        assert {t: counts[t] for t in rows} == rows
        assert counts["documents_by_status"] == {"DONE": 2}
        assert counts["jobs"] == app.ctx.queue.stats()

    jax, port = run_both(tmp_path, scenario)
    assert port == jax


@pytest.mark.parametrize("body", [
    {"app_name": "Docs", "primary_color": "#aabbcc", "theme": "dark"},
    {"primary_color": "red"}, {"accent_color": "#abc"},
    {"accent_color": "#12345678"}, {"accent_color": "#123456789"},
    {"unknown_key": "x"}, {"theme": "ocean"}, {"theme": "neon"},
    {"theme": ""}, {"welcome_message": "x" * 2001}, {"footer_text": 5},
    {"welcome_prompts": ["a", "b"]}, {"app_icon": None}, [1], "x", {},
], ids=lambda b: repr(b)[:40])
def test_branding_settings_round_trip(tmp_path, body):
    def scenario(app):
        h = app.signup()
        app.see(app.client.get("/api/settings"), "public read")
        app.see(app.client.put("/api/settings", headers=h,
                               json_body={"app_name": "Docs"}), "as user")
        app.make_admin()
        app.see(app.client.put("/api/settings", headers=h,
                               json_body=body), "put")
        app.see(app.client.get("/api/settings"), "read back")
        audit = app.see(app.client.get("/api/admin/audit",
                                       headers=h)).json()["audit"]
        return [(a["action"], a["detail"]) for a in audit]

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    assert port[2][1] == 200 and port[3][1] == 403


def test_settings_upload_limits_follow_the_profile(tmp_path):
    def scenario(app):
        app.see(app.client.get("/api/settings"))

    for profile in ("office", "text"):
        jax, port = run_both(tmp_path / profile, scenario,
                             UPLOAD_PROFILE=profile, MAX_UPLOAD_MB=7,
                             ALLOWED_MODELS=["m-a", "m-b"],
                             DEFAULT_MODEL="m-b")
        assert port == jax
        assert port[0][2]["upload"]["max_mb"] == 7


def test_costs_summary_renders_decimals_as_the_jax_route(tmp_path):
    def scenario(app):
        h = app.signup()
        app.see(app.client.get("/api/costs/summary", headers=h), "empty")
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC)
        app.drain()
        for q in ("How did revenue grow?", "What drove growth?"):
            app.see(app.client.post("/api/chat", headers=h, json_body={
                "question": q, "store_ids": [sid]}))
        app.see(app.client.get("/api/costs/summary", headers=h), "spent")
        app.make_admin()
        app.see(app.client.put("/api/admin/budgets/1", headers=h,
                               json_body={"monthly_usd": "0.50"}))
        app.see(app.client.get("/api/costs/summary", headers=h),
                "budgeted")
        app.see(app.client.get("/api/costs/summary"), "anonymous")

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    by_note = {note: (s, b) for note, s, b in port}
    assert by_note["spent"][1]["queries"] == 2
    assert by_note["budgeted"][1]["budget_usd"] == "0.50"
    assert by_note["anonymous"][0] == 401


def test_admin_recall_probe_exact(tmp_path):
    def scenario(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, "quick brown fox " * 80)
        app.drain()
        for body in ({"store_id": sid, "k": 5}, {"store_id": 999},
                     {"store_id": sid, "k": 0}, {"store_id": sid, "k": 101},
                     {"store_id": str(sid)}, {"k": 5},
                     {"store_id": sid, "sample": 4}):
            app.see(app.client.post("/api/admin/engine/recall-probe",
                                    json_body=body, headers=h),
                    f"probe {body}")
        app.see(app.client.get("/api/admin/audit", headers=h))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    probes = [(s, b) for note, s, b in port if note.startswith("probe")]
    assert probes[0][0] == 200 and probes[0][1]["recall"] == 1.0
    assert probes[0][1]["sample"] > 0
    assert [s for s, _ in probes[1:]] == [404, 422, 422, 422, 422, 200]
    assert any(a["action"] == "recall_probe"
               for a in port[-1][2]["audit"])


def _jax_store_served_by_both(tmp_path, probe, **knobs):
    """A store built through the JAX app's uploads, then served by the
    JAX app and by the port app from a copy of that deployment's
    database and data dir (the port's k-means does not draw JAX's
    centroids, so each app's own build would be another body).
    ``probe(app, headers)`` runs through each; returns their records."""
    client, ctx = build("jax", tmp_path / "jax", **knobs)
    jax = App("jax", client, ctx)
    h = jax.signup()
    jax.make_admin()
    sid = jax.create_store(h)["id"]
    for i in range(4):
        jax.upload_text(h, sid, _facts(60 * i, 60 * i + 60),
                        f"facts{i}.txt")
    jax.drain()
    segment = ctx.rag.engine._store(ctx.rag.engine.list_stores()[0]).segment
    assert segment.body is not None and segment.count >= 64
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    client, ctx = build("port", tmp_path / "port", **knobs)
    port = App("port", client, ctx)
    records = []
    for app in (jax, port):
        app.record = []
        probe(app, h)
        records.append(app.record)
    return records


def test_recall_probe_on_an_int8_ivf_store_built_through_uploads(tmp_path):
    """The probe's sampled queries (``sample_live_rows`` from
    ``default_rng(seed)``), its approximate search over the IVF body and
    its exact scan give the same recall, sample and k through both apps'
    routes on one store."""
    def probe(app, h):
        for body in ({"store_id": 1, "k": 10},
                     {"store_id": 1, "k": 3, "sample": 16}):
            app.see(app.client.post("/api/admin/engine/recall-probe",
                                    json_body=body, headers=h),
                    f"probe {body}")

    jax, port = _jax_store_served_by_both(
        tmp_path, probe, ENGINE_INDEX_MODE="ivf_flat_int8",
        ENGINE_NLIST=16, ENGINE_NPROBE=2, ENGINE_BUILD_THRESHOLD=64)
    assert port == jax
    probes = [b for note, s, b in port]
    assert 16 < probes[0]["sample"] <= 32 and probes[0]["k"] == 10
    assert 8 < probes[1]["sample"] <= 16 and probes[1]["k"] == 3
    assert 0.0 < probes[0]["recall"] <= 1.0


def test_reset_stuck_with_and_without_a_queue(tmp_path):
    def stuck(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC)
        app.ctx.db.execute("UPDATE documents SET status='RUNNING',"
                           " status_updated_at=0")
        return h

    def with_queue(app):
        h = stuck(app)
        app.see(app.client.post("/api/admin/watchdog/reset-stuck",
                                headers=h))
        app.see(app.client.get("/api/admin/system", headers=h))
        app.drain()
        app.see(app.client.get("/api/upload/op-status/doc-1", headers=h))
        app.see(app.client.post("/api/admin/watchdog/reset-stuck",
                                headers=h), "nothing stuck")

    def without_queue(app):
        h = app.signup()
        app.make_admin()
        app.see(app.client.post("/api/admin/watchdog/reset-stuck",
                                headers=h))

    jax, port = run_both(tmp_path / "q", with_queue)
    assert port == jax
    assert port[-4][2] == {"reset": 1} and port[-1][2] == {"reset": 0}
    assert port[-2][2]["status"] == "DONE"
    jax, port = run_both(tmp_path / "noq", without_queue,
                         with_worker=False)
    assert port == jax
    assert port[-1][1:] == (503, {"detail": "Ingestion queue unavailable"})


def test_deletions_are_listed(tmp_path):
    def scenario(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        keep = app.create_store(h, "Keep")["id"]
        app.upload_text(h, sid, DOC)
        app.upload_text(h, keep, DOC, "kept.txt")
        app.upload_text(h, keep, DOC, "gone.txt")
        app.drain()
        app.see(app.client.delete("/api/documents/3", headers=h))
        app.see(app.client.delete(f"/api/stores/{sid}", headers=h))
        listed = app.see(app.client.get("/api/admin/deletions",
                                        headers=h)).json()
        app.record[-1] = app.record[-1][:2]     # deletion times differ
        return {kind: [dict(r, deleted_at=r["deleted_at"] is not None)
                       for r in rows] for kind, rows in listed.items()}

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    listed = port[-1][1]
    assert [s["id"] for s in listed["stores"]] == [1]
    assert sorted(d["id"] for d in listed["documents"]) == [1, 3]


# -- the recall probe's repair ------------------------------------------------

def test_recall_probe_skips_a_pq_store_without_stored_rows():
    """``exact_reference_search`` raises ``NotImplementedError`` on a PQ
    body with neither the refine store nor the host archive; both
    engines' probes then return the same ``skipped`` dict."""
    from tests.test_torch_engine import (QUERIES, STORE, _ingest, _pq_jax,
                                         _pq_port)

    out = {}
    for name, make in (("jax", _pq_jax), ("port", _pq_port)):
        engine = make(None, refine="none")
        engine.create_store(STORE)
        _ingest(engine, 0, 200)
        seg = engine._store(STORE).segment
        seg._pq_archive = None      # as after loading an old checkpoint
        with pytest.raises(NotImplementedError, match="refine store"):
            seg.exact_reference_search(
                engine.encoder.encode(QUERIES[:2]), 5)
        out[name] = engine.recall_probe(STORE, k=10)
    assert out["port"] == out["jax"]
    assert out["port"]["recall"] is None and out["port"]["sample"] == 32
    assert out["port"]["k"] == 10
    assert "codes alone are lossy" in out["port"]["skipped"]


def test_recall_probe_route_answers_200_on_a_pq_store_without_rows(
        tmp_path):
    def probe(app, h):
        engine = app.ctx.rag.engine
        seg = engine._store(engine.list_stores()[0]).segment
        seg._pq_archive = None      # as after loading an old checkpoint
        app.see(app.client.post("/api/admin/engine/recall-probe",
                                json_body={"store_id": 1, "k": 5},
                                headers=h), "probe")
        app.see(app.client.get("/api/admin/audit", headers=h))

    jax, port = _jax_store_served_by_both(
        tmp_path, probe, ENGINE_INDEX_MODE="ivf_pq", ENGINE_PQ_M=32,
        ENGINE_PQ_REFINE="none", ENGINE_NLIST=16, ENGINE_NPROBE=4,
        ENGINE_BUILD_THRESHOLD=64)
    assert port == jax
    status, body = port[0][1:]
    assert status == 200 and body["recall"] is None and body["sample"] > 0
    assert "codes alone are lossy" in body["skipped"]
    assert port[1][2]["audit"][0]["detail"] == "store=1 recall=None"


def test_in_process_recall_audit_cron(tmp_path):
    """``ENGINE_RECALL_AUDIT_S`` > 0: the in-process worker's cron probes
    every store and sets the recall gauge (exact mode: 1.0)."""
    client, ctx = build("port", tmp_path, ENGINE_RECALL_AUDIT_S=60.0)
    app = App("port", client, ctx)
    h = app.signup()
    sid = app.create_store(h)["id"]
    app.upload_text(h, sid, "lorem ipsum dolor sit " * 400)
    app.drain()
    for _, fn, _last in ctx.worker.crons:
        fn()
    key = ctx.rag.engine.list_stores()[0]
    gauge = ctx.rag.engine.metrics.recall_at_k.labels(store=key, k="10")
    assert gauge.value == 1.0
