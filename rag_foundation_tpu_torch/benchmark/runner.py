"""End-to-end benchmark runner against a live API deployment.

Reference parity: scripts/benchmark/run_benchmark.py —
authenticate, ensure a store, upload + poll documents, then fire
questions concurrently over the SSE chat endpoint and score EM/F1,
refusal behavior, citation hits, and latency (avg/p95); writes
results.jsonl and summary.json. Counterpart of
``rag_foundation_tpu/benchmark/runner.py``; beside its numbers each
result here also keeps the citations' titles and the SSE frame types in
order (``frames``: the stream's contract can be checked), and
``run_benchmark`` takes one store id or a list of them.

Questions file: jsonl rows
  {"question": ..., "answers": [...], "answerable": true,
   "expected_sources": ["doc.txt"]}

Usage:
  python -m rag_foundation_tpu_torch.benchmark.runner --base-url http://...
      --email bench@example.com --password ... --docs dir/ \
      --questions q.jsonl --concurrency 4 [--register]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import time
import urllib.error
import urllib.request
from pathlib import Path

from rag_foundation_tpu_torch.benchmark import metrics


class ApiClient:
    """Minimal stdlib HTTP client (keeps the harness dependency-free)."""

    def __init__(self, base_url: str, token: str | None = None,
                 timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    retries = 3           # on 429/5xx (reference run_benchmark.py
    retry_backoff_s = 1.0  # retries-on-429/5xx behavior)

    def _request(self, method: str, path: str, *, json_body=None,
                 body: bytes | None = None, headers=None, stream=False):
        hdrs = dict(headers or {})
        data = body
        if json_body is not None:
            data = json.dumps(json_body).encode()
            hdrs["Content-Type"] = "application/json"
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        last: urllib.error.HTTPError | None = None
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(self.base_url + path, data=data,
                                         headers=hdrs, method=method)
            try:
                resp = urllib.request.urlopen(  # noqa: S310
                    req, timeout=self.timeout)
            except urllib.error.HTTPError as e:
                if e.code in (429, 500, 502, 503) \
                        and attempt < self.retries:
                    last = e
                    retry_after = e.headers.get("Retry-After")
                    try:  # HTTP-date forms fall back to backoff
                        delay = float(retry_after) if retry_after \
                            else self.retry_backoff_s * (attempt + 1)
                    except ValueError:
                        delay = self.retry_backoff_s * (attempt + 1)
                    time.sleep(min(delay, 30.0))
                    continue
                raise
            if stream:
                return resp
            payload = resp.read()
            return resp.status, json.loads(payload) if payload else {}
        raise last  # pragma: no cover — loop always returns or raises

    @classmethod
    def from_credentials(cls, base_url: str, email: str, password: str,
                         *, register: bool = False) -> "ApiClient":
        c = cls(base_url)
        if register:
            try:
                c._request("POST", "/api/auth/register",
                           json_body={"email": email, "password": password})
            except urllib.error.HTTPError as e:
                if e.code != 409:
                    raise
        _, out = c._request("POST", "/api/auth/login",
                            json_body={"email": email, "password": password})
        return cls(base_url, token=out["access_token"])

    def ensure_store(self, name: str) -> dict:
        import html
        _, out = self._request("GET", "/api/stores")
        for s in out["stores"]:
            # the server stores the html.escape-sanitized name
            if s["name"] in (name, html.escape(name)):
                return s
        _, store = self._request("POST", "/api/stores",
                                 json_body={"name": name})
        return store

    poll_interval_s = 0.5  # injectable (tests lower it)

    def upload_and_poll(self, store_id: int, path: Path,
                        timeout_s: float = 120.0) -> dict:
        boundary = "ragtpubench0123456789"
        data = path.read_bytes()
        ctype = "text/markdown" if path.suffix == ".md" else "text/plain"
        body = (
            f"--{boundary}\r\nContent-Disposition: form-data;"
            f" name=\"store_id\"\r\n\r\n{store_id}\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data;"
            f" name=\"file\"; filename=\"{path.name}\"\r\n"
            f"Content-Type: {ctype}\r\n\r\n").encode() + data + \
            f"\r\n--{boundary}--\r\n".encode()
        _, out = self._request(
            "POST", "/api/upload", body=body,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        op_id = out["op_id"]
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            _, st = self._request("GET", f"/api/upload/op-status/{op_id}")
            if st["done"]:
                if st.get("error"):  # done=True covers ERROR too
                    raise RuntimeError(
                        f"ingestion failed for {path.name}: "
                        f"{st['error']}")
                return st
            time.sleep(self.poll_interval_s)
        raise TimeoutError(f"ingestion timeout for {path.name}")

    def ask(self, question: str, store_ids: list[int],
            timeout_s: float = 120.0, top_k: int | None = None,
            history: list[dict] | None = None) -> dict:
        """POST /api/chat and consume the SSE stream to [DONE].

        ``history`` (multi-turn questions): prior turns sent as the
        AssistantUI ``messages`` array, current question last — the
        same wire shape the frontend sends (static/chat.js)."""
        t0 = time.perf_counter()
        body = {"question": question, "store_ids": store_ids}
        if history:
            body = {"messages": list(history)
                    + [{"role": "user", "content": question}],
                    "store_ids": store_ids}
        if top_k is not None:
            body["top_k"] = top_k
        resp = self._request("POST", "/api/chat", json_body=body,
                             stream=True)
        text_parts: list[str] = []
        citations: list[dict] = []
        frames: list[str] = []      # frame types in order, then [DONE]
        error = None
        ttft = None
        deadline = t0 + timeout_s
        for raw in resp:
            if time.perf_counter() > deadline:
                error = error or "client deadline exceeded"
                break
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                frames.append(payload)
                break
            frame = json.loads(payload)
            kind = frame.get("type")
            frames.append(kind)
            if kind == "text-delta":
                if ttft is None:
                    ttft = time.perf_counter() - t0
                text_parts.append(frame.get("delta", ""))
            elif kind == "source-document":
                citations.append(frame)
            elif kind in ("error", "budget_exceeded"):
                error = frame.get("message") or kind
        return {
            "answer": "".join(text_parts),
            "citations": citations,
            "error": error,
            "latency_s": time.perf_counter() - t0,
            "ttft_s": ttft,
            "frames": frames,
        }


def run_benchmark(client: ApiClient, store_id: int | list[int],
                  questions: list[dict], concurrency: int = 4,
                  top_k: int | None = None) -> dict:
    results: list[dict] = []
    store_ids = store_id if isinstance(store_id, list) else [store_id]

    def _one(q: dict) -> dict:
        try:
            out = client.ask(q["question"], store_ids, top_k=top_k,
                             history=q.get("history"))
        except Exception as e:  # noqa: BLE001 — record, don't abort run
            return {"question": q["question"], "error": str(e)}
        answers = q.get("answers", [])
        return {
            "question": q["question"],
            "answer": out["answer"],
            "error": out["error"],
            "latency_s": out["latency_s"],
            "ttft_s": out["ttft_s"],
            "em": metrics.exact_match(out["answer"], answers),
            "contains": metrics.contains_match(out["answer"], answers),
            "f1": metrics.f1_score(out["answer"], answers),
            "refusal_ok": metrics.refusal_ok(
                out["answer"], q.get("answerable", True)),
            "citation_hit": metrics.citation_hit(
                out["citations"], q.get("expected_sources", [])),
            "citations": [c.get("title") for c in out["citations"]],
            "frames": out["frames"],
        }

    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        results = list(pool.map(_one, questions))

    ok = [r for r in results if not r.get("error")]
    latencies = [r["latency_s"] for r in ok]
    summary = {
        "total": len(results),
        "errors": len(results) - len(ok),
        "error_rate": (len(results) - len(ok)) / max(1, len(results)),
        "em": metrics.mean([r["em"] for r in ok]),
        "contains": metrics.mean([r["contains"] for r in ok]),
        "f1": metrics.mean([r["f1"] for r in ok]),
        "refusal_ok": metrics.mean([r["refusal_ok"] for r in ok]),
        "citation_hit": metrics.mean([r["citation_hit"] for r in ok]),
        "latency_avg_s": metrics.mean(latencies),
        "latency_p95_s": metrics.p95(latencies),
    }
    return {"results": results, "summary": summary}


_YAML_BOOLS = {v: b for b, vs in ((True, "y Y yes Yes YES true True TRUE on "
                                      "On ON"),
                                     (False, "n N no No NO false False "
                                      "FALSE off Off OFF"))
               for v in vs.split()}
_YAML_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_YAML_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")


def _yaml_scalar(text: str):
    """One plain or single-quoted scalar, resolved as ``yaml.safe_load``
    resolves it (null, bool, int, float or string)."""
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _YAML_BOOLS:
        return _YAML_BOOLS[text]
    if _YAML_INT.fullmatch(text):
        return int(text)
    if _YAML_FLOAT.fullmatch(text):
        return float(text)
    if text[0] in "-+.0123456789":      # octal, 1_000, 1:30, dates, .inf
        raise ValueError(f"unsupported YAML number {text!r}")
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if text[0] in "[]{}&*!|>%@`\"'" or ": " in text or text.endswith(":"):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


def _yaml_folded(lines: list[str]) -> str:
    """A folded (``>``) block's lines as ``yaml.safe_load`` joins them:
    a line break between two lines becomes a space, an empty line a
    newline, and one newline ends the text."""
    while lines and not lines[-1].strip():
        lines.pop()
    if not lines:
        return ""
    indent = len(lines[0]) - len(lines[0].lstrip(" "))
    parts: list[str] = []
    for line in lines:
        if not line.strip():
            parts.append("\n")
            continue
        if line[:indent].strip() or line[indent:indent + 1] in (" ", "\t"):
            raise ValueError(f"unsupported folded line {line!r}")
        if parts and parts[-1] != "\n":
            parts.append(" ")
        parts.append(line[indent:])
    return "".join(parts) + "\n"


def read_bench_config(text: str) -> dict:
    """``benchmarks.yml`` without PyYAML, which the card machine lacks:
    top-level keys, each a mapping of scalars and folded (``>``)
    strings, comments on their own lines or after a scalar. Equal to
    ``yaml.safe_load`` on that shape; anything else raises
    ``ValueError``."""
    out: dict = {}
    entry, entry_indent = None, None
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = re.sub(r"(^|\s)#.*", "", lines[i]).rstrip()
        i += 1
        if not line:
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        value = value.strip()
        if not sep or not key or (value and not line.strip()[
                len(key) + 1].isspace()):
            raise ValueError(f"unsupported YAML line {line!r}")
        if indent == 0:
            if value:
                raise ValueError(f"top-level scalar {line!r}")
            entry, entry_indent = out.setdefault(key, {}), None
            continue
        if entry is None or entry_indent not in (None, indent):
            raise ValueError(f"unsupported nesting at {line!r}")
        entry_indent = indent
        if value == ">":
            block = []
            while i < len(lines) and (
                    not lines[i].strip()
                    or len(lines[i]) - len(lines[i].lstrip(" ")) > indent):
                block.append(lines[i])
                i += 1
            entry[key] = _yaml_folded(block)
        else:
            entry[key] = _yaml_scalar(value)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-url", required=True)
    ap.add_argument("--email", default="bench@example.com")
    ap.add_argument("--password", default="Bench-Passw0rd-1")
    ap.add_argument("--register", action="store_true")
    ap.add_argument("--store", default="benchmark")
    ap.add_argument("--docs", type=Path)
    ap.add_argument("--questions", type=Path)
    ap.add_argument("--config", type=Path,
                    help="benchmarks.yml (reference benchmarks.yml:1-9 "
                         "shape); --bench picks the entry")
    ap.add_argument("--bench", default="quality")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--max-questions", type=int, default=None)
    ap.add_argument("--out-dir", type=Path, default=Path("bench-out"))
    args = ap.parse_args()

    top_k = args.top_k
    max_questions = args.max_questions
    if args.config:
        cfg = read_bench_config(args.config.read_text())[args.bench]
        root = args.config.parent
        args.questions = args.questions or \
            (root / cfg["questions"]).resolve()
        if args.docs is None and cfg.get("docs_path"):
            args.docs = (root / cfg["docs_path"]).resolve()
        args.store = cfg.get("store", args.store)
        args.concurrency = cfg.get("concurrency", args.concurrency)
        top_k = top_k or cfg.get("top_k")
        max_questions = max_questions or cfg.get("max_questions")
    if args.questions is None:
        ap.error("--questions or --config required")

    client = ApiClient.from_credentials(args.base_url, args.email,
                                        args.password,
                                        register=args.register)
    store = client.ensure_store(args.store)
    if args.docs:
        for path in sorted(args.docs.glob("*")):
            if path.is_file():
                st = client.upload_and_poll(store["id"], path)
                print(f"ingested {path.name}: {st['status']}")
    questions = [json.loads(line) for line in
                 args.questions.read_text().splitlines() if line.strip()]
    if max_questions:
        questions = questions[:max_questions]
    out = run_benchmark(client, store["id"], questions,
                        concurrency=args.concurrency, top_k=top_k)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    with open(args.out_dir / "results.jsonl", "w") as f:
        for r in out["results"]:
            f.write(json.dumps(r) + "\n")
    (args.out_dir / "summary.json").write_text(
        json.dumps(out["summary"], indent=2))
    print(json.dumps(out["summary"], indent=2))


if __name__ == "__main__":
    main()
