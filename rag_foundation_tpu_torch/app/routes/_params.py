"""Shared request-parsing helpers for route modules.

Non-numeric path params and non-object JSON bodies are CLIENT errors:
without these helpers a probing request like ``GET /api/stores/abc`` or
a body of ``[1,2]`` raised raw ValueError/TypeError through the global
boundary as 500s (round-2 review finding)."""

from __future__ import annotations

from rag_foundation_tpu_torch.runtime.http import HTTPError


def int_param(req, name: str) -> int:
    """Path parameter as int; non-numeric -> 404 (the resource space is
    numeric ids, so /api/stores/abc simply does not exist — and 404
    matches the tenancy-safe not-found contract)."""
    raw = req.path_params.get(name, "")
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise HTTPError(404, "Not found") from None


def json_object(req) -> dict:
    """Request body as a JSON OBJECT; anything else is a 422."""
    body = req.json()
    if not isinstance(body, dict):
        raise HTTPError(422, "Expected a JSON object body")
    return body
