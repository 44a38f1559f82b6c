"""The port's pydantic-free ``Settings`` against the JAX app's pydantic one:
the same fields and defaults, the same values from the same ``RAGTPU_*``
variables (lax-mode coercion of ints, floats, bools, JSON or comma lists
and the pricing table; secret files), and a raise in both where the JAX
model raises (``ValueError``, which pydantic's ``ValidationError`` is)."""

import decimal

import pytest

from rag_foundation_tpu.app.config import Settings as JaxSettings
from rag_foundation_tpu_torch.app import validation as v
from rag_foundation_tpu_torch.app.config import Settings
from rag_foundation_tpu_torch.app.services.rag import (
    engine_config_from_settings, engine_device)

_INTS = ["5", " 5 ", "5.0", "-5.00", "5.5", "1_000", "1__0", "+5", "0x10",
         "abc", "", "1e3", "\t7\n", "١٢", "99999999999999999999"]
_BOOLS = ["1", "true", "TRUE", "yes", "on", "t", "y", "0", "false", "no",
          "off", "f", "n", "N", "2", "", " true", "tru"]
_FLOATS = ["1.5", " 2.5 ", "1e3", "inf", "-inf", "1_000.5", ".5", "5.",
           "abc", "", "0x1p3", "١"]
_LISTS = ["a,b", " a , ,b ", '["x", "y"]', "[]", "", "  ", '[1, 2]', "[",
          '["a", null]', "*", 'x,"y"']
_PRICING = ['{"m": {"input": "1", "output": "2"}}', '{"m": {"input": 1}}',
            "notjson", '{"m": {"input": "-1"}}', '{"m": {"input": "abc"}}',
            '{"m": "x"}', "[]", '{"INDEX": {}}']

CASES = (
    [{}]
    + [{"RAGTPU_JWT_TTL_S": x} for x in _INTS]
    + [{"RAGTPU_MOCK_MODE": x} for x in _BOOLS]
    + [{"RAGTPU_STREAM_KEEPALIVE_S": x} for x in _FLOATS]
    + [{"RAGTPU_CORS_ORIGINS": x} for x in _LISTS]
    + [{"RAGTPU_ALLOWED_MODELS": x} for x in _LISTS[:4]]
    + [{"RAGTPU_MODEL_PRICING": x} for x in _PRICING]
    + [{"RAGTPU_ENVIRONMENT": x} for x in ("staging", "bogus", "test",
                                           "production", "Production")]
    + [{"RAGTPU_ENVIRONMENT": "staging", "RAGTPU_WORKER_IN_PROCESS": "1"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40,
        "RAGTPU_DATABASE_PATH": "/data/app.db"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40,
        "RAGTPU_DATABASE_PATH": "/data/app.db",
        "RAGTPU_DEV_LOGIN_ENABLED": "true"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "short",
        "RAGTPU_DATABASE_PATH": "/data/app.db"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40,
        "RAGTPU_DATABASE_PATH": "/d.db", "RAGTPU_CORS_ORIGINS": "*"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40,
        "RAGTPU_DATABASE_PATH": "/d.db", "RAGTPU_CSRF_ENABLED": "0"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40,
        "RAGTPU_DATABASE_PATH": "/d.db", "RAGTPU_MOCK_MODE": "1"},
       {"RAGTPU_ENVIRONMENT": "production", "RAGTPU_JWT_SECRET": "s" * 40,
        "RAGTPU_DATABASE_PATH": "/d.db", "RAGTPU_MOCK_MODE": "1",
        "RAGTPU_ALLOW_MOCK_IN_PROD": "yes"},
       {"RAGTPU_ENGINE_CHUNK_TOKENS": "40", "RAGTPU_ENGINE_CHUNK_OVERLAP":
        "40"},
       {"RAGTPU_ENGINE_INDEX_MODE": "ivf_pq"},
       {"RAGTPU_ENGINE_INDEX_MODE": "hnsw"},
       {"RAGTPU_ENGINE_ANSWER_MODE": "sentences"},
       {"RAGTPU_ENGINE_ANSWER_MODE": "llm"},
       {"RAGTPU_ENGINE_GENERATOR": "mock_generative"},
       {"RAGTPU_ENGINE_GENERATOR": "generative"},
       {"RAGTPU_ENGINE_GENERATOR": "generative",
        "RAGTPU_ENGINE_GENERATOR_CKPT": "d.npz"},
       {"RAGTPU_ENGINE_GENERATOR": "gpt"},
       {"RAGTPU_ENGINE_PQ_REFINE": "host"},
       {"RAGTPU_ENGINE_PQ_REFINE": "disk"},
       {"RAGTPU_ENGINE_RPC_MODE": "connect"},
       {"RAGTPU_ENGINE_RPC_MODE": "proxy"},
       {"RAGTPU_ENGINE_BATCH_WINDOW_MS": "20", "RAGTPU_ENGINE_NLIST":
        "4096", "RAGTPU_ENGINE_NPROBE": "32", "RAGTPU_ENGINE_IVF_P": "3"},
       {"RAGTPU_BUDGET_HOLD_USD": "0.5", "RAGTPU_UNKNOWN_THING": "x",
        "RAGTPU_METADATA_FILTER_ALLOWED_KEYS": "doc_name,ordinal"},
       {"RAGTPU_ENGINE_PLATFORM": "cpu", "RAGTPU_ENGINE_RPC_SOCKET":
        "/run/e.sock", "RAGTPU_KV_PATH": "/k.db"}])


def _outcome(cls, env=None, **kw):
    """("ok", values, fields set) or ("raise", exception kind)."""
    try:
        s = cls.from_env(env, **kw) if env is not None else cls(**kw)
    except ValueError:
        return ("raise", "ValueError")
    except decimal.InvalidOperation:
        return ("raise", "InvalidOperation")
    names = list(JaxSettings.model_fields)
    values = {n: getattr(s, n) for n in names}
    derived = (s.kv_path, s.engine_rpc_socket, s.is_production,
               s.budget_hold)
    # repr: NaN != NaN, and a bool must not pass for an int
    return ("ok", repr(values), derived)


@pytest.mark.parametrize("env", CASES, ids=lambda e: repr(e)[:60])
def test_from_env_matches_pydantic(env):
    assert _outcome(Settings, env) == _outcome(JaxSettings, env)


@pytest.mark.parametrize("kw", [
    dict(CORS_ORIGINS=["a", "b"], MODEL_PRICING={"m": {"input": "1"}}),
    dict(JWT_TTL_S=5.0, MOCK_MODE=1, STREAM_KEEPALIVE_S=2),
    dict(JWT_TTL_S=5.5), dict(MOCK_MODE=2), dict(MOCK_MODE=None),
    dict(ENVIRONMENT=5), dict(CORS_ORIGINS=("a",)), dict(TRUSTED_PROXIES=7),
    dict(MODEL_PRICING={"m": {"input": 1}}), dict(JWT_TTL_S=True),
    dict(ENVIRONMENT="staging", WORKER_IN_PROCESS=True),
    dict(ENVIRONMENT="staging", WORKER_IN_PROCESS="false"),
    dict(DATA_DIR=b"/srv/data", not_a_field=3),
], ids=lambda k: repr(k)[:60])
def test_constructor_matches_pydantic(kw):
    assert _outcome(Settings, **kw) == _outcome(JaxSettings, **kw)


def test_fields_defaults_and_secret_files(tmp_path):
    assert Settings.field_names() == tuple(JaxSettings.model_fields)
    assert _outcome(Settings) == _outcome(JaxSettings)
    secret = tmp_path / "jwt"
    value = "read from the file " * 2
    secret.write_text(f"  {value}\n")
    env = {"RAGTPU_JWT_SECRET_FILE": str(secret),
           "RAGTPU_JWT_SECRET": "ignored when a file is given"}
    assert Settings.from_env(env).JWT_SECRET == \
        JaxSettings.from_env(env).JWT_SECRET == value.strip()
    s = Settings.from_env({"RAGTPU_ENVIRONMENT": "staging"},
                          WORKER_IN_PROCESS=True)
    assert s.WORKER_IN_PROCESS and "WORKER_IN_PROCESS" in s.fields_set


def test_engine_config_and_device_from_settings(monkeypatch):
    """The in-process engine's config maps the same settings the JAX
    app maps; its device comes from ``RAGTPU_ENGINE_PLATFORM``: ``cpu``
    on the CPU, anything else the card (no fallback)."""
    from rag_foundation_tpu.app.services.rag import \
        engine_config_from_settings as jax_config
    env = {"RAGTPU_ENGINE_INDEX_MODE": "ivf_flat_int8",
           "RAGTPU_ENGINE_NLIST": "64", "RAGTPU_ENGINE_NPROBE": "16",
           "RAGTPU_ENGINE_BATCH_WINDOW_MS": "20",
           "RAGTPU_ENGINE_GENERATOR_CKPT": "", "RAGTPU_DATA_DIR": "/d"}
    ours = engine_config_from_settings(Settings.from_env(env), device="cpu")
    theirs = jax_config(JaxSettings.from_env(env))
    for name in theirs.__dataclass_fields__:
        if name != "approx_routing" or hasattr(ours, name):
            assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.device == "cpu"
    assert engine_device({"RAGTPU_ENGINE_PLATFORM": "cpu"}) == "cpu"
    assert engine_device({}) == engine_device(
        {"RAGTPU_ENGINE_PLATFORM": "tpu"}) == "cuda"
    monkeypatch.setenv("RAGTPU_ENGINE_PLATFORM", "cpu")
    assert engine_config_from_settings(Settings()).device == "cpu"
    monkeypatch.delenv("RAGTPU_ENGINE_PLATFORM")
    assert engine_config_from_settings(Settings()).device == "cuda"


def test_lax_coercion_matches_pydantic_field_by_field():
    """Each coercion against pydantic's on one field of its type, inputs
    a JSON body or an environment can carry."""
    from pydantic import BaseModel, ValidationError

    class M(BaseModel):
        i: int | None = None
        f: float | None = None
        b: bool | None = None
        s: str | None = None
        li: list[int] | None = None

    samples = (_INTS + _BOOLS + _FLOATS + [0, 1, 2, -1, 1.0, 1.5, 0.0,
                                           True, False, [1], ["1", 2.0],
                                           [1.5], {"a": 1}, "1 ", 10 ** 20])
    for name, ours in (("i", v.to_int), ("f", v.to_float),
                       ("b", v.to_bool), ("s", v.to_str),
                       ("li", v.list_of(v.to_int))):
        for x in samples:
            try:
                want = ("ok", repr(getattr(M(**{name: x}), name)))
            except ValidationError as e:
                want = ("err", e.errors()[0]["msg"])
            try:
                got = ("ok", repr(ours(x, (name,))))
            except v.FieldError as e:
                got = ("err", e.msg)
            assert got == want, (name, x)
