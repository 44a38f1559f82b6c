"""Decimal-precise cost math, token estimation, and budget enforcement.

Reference parity: backend/app/costs.py — per-model pricing
with longest-prefix fallback, query/index cost calculators, byte->token
heuristics, month-to-date spend, budget checks, and a pricing-configured
guard dependency.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from decimal import Decimal

from rag_foundation_tpu_torch.runtime.http import HTTPError

MTOK = Decimal(1_000_000)


@dataclass(frozen=True)
class QueryCost:
    input_cost_usd: Decimal
    output_cost_usd: Decimal

    @property
    def total_cost_usd(self) -> Decimal:
        return self.input_cost_usd + self.output_cost_usd


def resolve_pricing(settings, model: str) -> dict[str, Decimal]:
    """Exact match, then longest-prefix fallback (reference:
    costs.py:32-107)."""
    pricing = settings.MODEL_PRICING
    if model in pricing:
        p = pricing[model]
    else:
        best = ""
        for name in pricing:
            if model.startswith(name) and len(name) > len(best):
                best = name
        if not best:
            raise HTTPError(503, f"No pricing configured for model {model!r}")
        p = pricing[best]
    return {"input": Decimal(str(p.get("input", "0"))),
            "output": Decimal(str(p.get("output", "0")))}


def calc_query_cost(settings, model: str, prompt_tokens: int,
                    completion_tokens: int) -> QueryCost:
    p = resolve_pricing(settings, model)
    return QueryCost(
        input_cost_usd=p["input"] * Decimal(prompt_tokens) / MTOK,
        output_cost_usd=p["output"] * Decimal(completion_tokens) / MTOK)


def calc_index_cost(settings, tokens: int) -> Decimal:
    p = resolve_pricing(settings, "INDEX")
    return p["input"] * Decimal(tokens) / MTOK


def estimate_tokens_from_bytes(size: int, content_type: str = "") -> int:
    """Byte->token heuristic with modality awareness (reference:
    costs.py:156-171). Text ~4 bytes/token; binary formats discount."""
    if size <= 0:
        return 0
    ct = content_type.lower()
    if ct.startswith("text/") or ct in {"application/json",
                                        "application/xml"}:
        divisor = 4
    elif "pdf" in ct or "officedocument" in ct or "msword" in ct:
        divisor = 6
    else:
        divisor = 8
    return max(1, size // divisor)


def estimate_tokens_from_text(text: str) -> int:
    return max(1, len(text) // 4)


def month_start_ts(now: float | None = None) -> float:
    t = time.gmtime(now if now is not None else time.time())
    return time.mktime((t.tm_year, t.tm_mon, 1, 0, 0, 0, 0, 0, 0)) \
        - time.timezone


def month_to_date_spend(db, user_id: int) -> Decimal:
    rows = db.query(
        "SELECT cost_usd FROM query_log WHERE user_id=? AND created_at>=?",
        (user_id, month_start_ts()))
    return sum((Decimal(r["cost_usd"]) for r in rows), Decimal(0))


def get_budget(db, user_id: int, settings) -> Decimal | None:
    row = db.one("SELECT monthly_usd FROM budgets WHERE user_id=?", (user_id,))
    if row is not None:
        return Decimal(row["monthly_usd"])
    if settings.DEFAULT_MONTHLY_BUDGET_USD:
        return Decimal(settings.DEFAULT_MONTHLY_BUDGET_USD)
    return None


def remaining_budget(db, user_id: int, settings) -> Decimal | None:
    budget = get_budget(db, user_id, settings)
    if budget is None:
        return None
    return budget - month_to_date_spend(db, user_id)


def check_budget_or_402(db, user_id: int, settings,
                        hold: Decimal | None = None) -> Decimal | None:
    """Pre-check with a hold amount; raises 402 when exhausted
    (reference: chat.py:915-935, costs.py:185-220)."""
    remaining = remaining_budget(db, user_id, settings)
    if remaining is None:
        return None
    hold = settings.budget_hold if hold is None else hold
    if remaining - hold <= 0:
        raise HTTPError(402, "Monthly budget exhausted")
    return remaining


def record_query_cost(db, *, user_id: int, store_id: int | None, model: str,
                      prompt_tokens: int, completion_tokens: int,
                      cost_usd: Decimal, status: str = "ok",
                      tags: dict[str, str] | None = None) -> None:
    import json as _json
    db.execute(
        "INSERT INTO query_log(user_id, store_id, model, prompt_tokens,"
        " completion_tokens, cost_usd, status, created_at, tags)"
        " VALUES(?,?,?,?,?,?,?,?,?)",
        (user_id, store_id, model, prompt_tokens, completion_tokens,
         str(cost_usd), status, time.time(),
         _json.dumps(tags) if tags else None))


def require_pricing_configured(settings, model: str) -> None:
    resolve_pricing(settings, model)  # raises 503 when missing
