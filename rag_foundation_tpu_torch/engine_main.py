"""Dedicated engine process on the card: serves the engine RPC socket.

    python -m rag_foundation_tpu_torch.engine_main

Counterpart of ``rag_foundation_tpu/app/engine_main.py``. It reads the
same ``RAGTPU_*`` variables the JAX app maps into its engine config
(``ENGINE_DIM``, ``ENGINE_ENCODER``, ``ENGINE_ENCODER_CKPT``,
``ENGINE_HYBRID_W``, ``ENGINE_INDEX_MODE``, ``ENGINE_NLIST``, ...,
``DATA_DIR``, ``ENGINE_RPC_SOCKET``, ``ENVIRONMENT``) with its own small
reader, builds the port's ``Engine`` and serves ``EngineRpcServer`` on
``RAGTPU_ENGINE_RPC_SOCKET`` (default ``DATA_DIR/engine.sock``). API
processes connect with ``RAGTPU_ENGINE_RPC_MODE=connect``.

The engine runs on the card; ``RAGTPU_ENGINE_PLATFORM=cpu`` runs it on
the CPU instead. Without a card and without that variable it exits with
an error. It also exits, before it opens the socket, when
``RAGTPU_ENGINE_GENERATOR_CKPT`` is set: the generative decoder is not
ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from pathlib import Path

from rag_foundation_tpu_torch.engine.api import EngineConfig

_PREFIX = "RAGTPU_"
# (config field, variable, type, default) — the JAX app's Settings
# defaults (rag_foundation_tpu/app/config.py)
_FIELDS = (
    ("dim", "ENGINE_DIM", int, 384),
    ("chunk_tokens", "ENGINE_CHUNK_TOKENS", int, 200),
    ("chunk_overlap", "ENGINE_CHUNK_OVERLAP", int, 40),
    ("encoder", "ENGINE_ENCODER", str, "hash"),
    ("encoder_ckpt", "ENGINE_ENCODER_CKPT", str, ""),
    ("hybrid_w", "ENGINE_HYBRID_W", float, 0.35),
    ("index_mode", "ENGINE_INDEX_MODE", str, "exact"),
    ("nlist", "ENGINE_NLIST", int, 1024),
    ("nprobe", "ENGINE_NPROBE", int, 64),
    ("build_threshold", "ENGINE_BUILD_THRESHOLD", int, 100_000),
    ("pq_m", "ENGINE_PQ_M", int, 48),
    ("pq_packed", "ENGINE_PQ_PACKED", bool, False),
    ("pq_refine", "ENGINE_PQ_REFINE", str, "device"),
    ("pq_cap_slack", "ENGINE_PQ_CAP_SLACK", float, 1.5),
    ("ivf_p", "ENGINE_IVF_P", int, 4),
    ("approx_routing", "ENGINE_APPROX_ROUTING", bool, False),
    ("mesh_shards", "ENGINE_MESH_SHARDS", int, 1),
)


def _parse_bool(raw: str) -> bool:
    v = raw.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"not a boolean: {raw!r}")


def _get(env: dict[str, str], name: str, typ, default):
    raw = env.get(_PREFIX + name)
    if raw is None:
        return default
    return _parse_bool(raw) if typ is bool else typ(raw)


def config_from_env(env: dict[str, str] | None = None
                    ) -> tuple[EngineConfig, str, bool]:
    """``(EngineConfig, rpc socket path, allow_pad)`` from ``RAGTPU_*``
    variables."""
    env = dict(os.environ if env is None else env)
    if env.get(_PREFIX + "ENGINE_GENERATOR_CKPT"):
        # the JAX engine process prewarms the decoder at startup; the
        # port has none, so it refuses here rather than fail the first chat
        raise ValueError(
            f"{_PREFIX}ENGINE_GENERATOR_CKPT is set, but the generative "
            f"decoder is not ported yet: unset {_PREFIX}ENGINE_GENERATOR_CKPT"
            f" (the extractive span_reader needs no decoder)")
    kw = {f: _get(env, name, typ, default)
          for f, name, typ, default in _FIELDS}
    kw["encoder_ckpt"] = kw["encoder_ckpt"] or None
    kw["batch_window_s"] = _get(env, "ENGINE_BATCH_WINDOW_MS", float,
                                0.0) / 1000.0
    data_dir = _get(env, "DATA_DIR", str, "./data")
    kw["data_dir"] = str(data_dir) + "/engine" if data_dir else None
    platform = _get(env, "ENGINE_PLATFORM", str, "")
    kw["device"] = "cpu" if platform == "cpu" else "cuda"
    socket_path = _get(env, "ENGINE_RPC_SOCKET", str, "") or \
        str(Path(data_dir or ".") / "engine.sock")
    allow_pad = _get(env, "ENVIRONMENT", str, "development") != "production"
    return EngineConfig(**kw), socket_path, allow_pad


def main() -> None:  # pragma: no cover — production entrypoint
    from rag_foundation_tpu_torch.engine.api import Engine
    from rag_foundation_tpu_torch.engine.rpc import EngineRpcServer

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("engine_main")
    try:
        cfg, socket_path, allow_pad = config_from_env()
    except ValueError as e:
        raise SystemExit(f"engine_main: {e}") from None
    engine = Engine(cfg)
    server = EngineRpcServer(engine, socket_path,
                             allow_pad=allow_pad).start()
    log.info(json.dumps({"event": "engine_rpc_started",
                         "socket": socket_path, "device": str(engine.device),
                         "stores": len(engine.list_stores()),
                         "batch_window_s": cfg.batch_window_s}))
    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    stop.wait()
    server.shutdown()
    log.info(json.dumps({"event": "engine_rpc_stopped"}))


if __name__ == "__main__":
    main()
