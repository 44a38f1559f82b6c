"""Monthly cost summary (reference: backend/app/routes/costs.py:15-70).

Counterpart of ``rag_foundation_tpu/app/routes/costs_routes.py``: sums
are ``Decimal`` and rendered with ``str`` as the JAX route renders them.
"""

from __future__ import annotations

from decimal import Decimal

from rag_foundation_tpu_torch.app.auth import get_current_user
from rag_foundation_tpu_torch.app.costs import (get_budget,
                                                month_start_ts,
                                                month_to_date_spend)
from rag_foundation_tpu_torch.runtime.http import Response


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    @app.get("/api/costs/summary")
    async def costs_summary(req):
        user = get_current_user(req, db, ctx.kv, settings)
        rows = db.query(
            "SELECT model, prompt_tokens, completion_tokens, cost_usd FROM"
            " query_log WHERE user_id=? AND created_at>=?",
            (user.id, month_start_ts()))
        query_cost = Decimal(0)
        index_cost = Decimal(0)
        prompt_tokens = completion_tokens = index_tokens = 0
        queries = 0
        for r in rows:
            if r["model"] == "INDEX":
                index_cost += Decimal(r["cost_usd"])
                index_tokens += r["prompt_tokens"]
            else:
                query_cost += Decimal(r["cost_usd"])
                prompt_tokens += r["prompt_tokens"]
                completion_tokens += r["completion_tokens"]
                queries += 1
        budget = get_budget(db, user.id, settings)
        spend = month_to_date_spend(db, user.id)
        return Response({
            "month_to_date_usd": str(spend),
            "query_cost_usd": str(query_cost),
            "index_cost_usd": str(index_cost),
            "queries": queries,
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "index_tokens": index_tokens,
            "budget_usd": str(budget) if budget is not None else None,
            "remaining_usd": str(budget - spend)
            if budget is not None else None,
        })
