"""Train the evidence-conditioned generative decoder and save an npz
checkpoint that the engine serves through ``generator_ckpt``
(``RAGTPU_ENGINE_GENERATOR_CKPT``) and JAX's ``TextGenerator`` loads.

    python scripts/build_text_corpus.py --out corpus.jsonl
    python -m rag_foundation_tpu_torch.tools.train_decoder \\
        --corpus corpus.jsonl --steps 4000 --batch 64 --out decoder.npz
    python -m rag_foundation_tpu_torch.tools.train_decoder --smoke \\
        --device cpu                   # the tiny CI model, a minute here

Counterpart of ``scripts/train_decoder.py``: the same flags, defaults,
``--smoke`` overrides, log lines (stderr) and result line (stdout), plus
``--device`` (default ``cuda``, which raises without a card: there is no
CPU fallback). Supervision is the script's self-distillation of the
product's extractive pipeline: a pseudo-question over a corpus chunk
(a cloze question, a keyword bag or a sentence), the gold chunk among
distractors, the evidence picked by ``prep_evidence`` and the answer
labelled by ``rag.compose_answer``, the span-reader cascade (the port's
JAX-free copies in ``app/services``), or the refusal text when the gold
chunk is left out.

The host side (corpus, vocabulary, triples, token arrays) is numpy and
``np.random.default_rng`` as in the script, bit for bit its arrays for
the same seed and corpus. The tokenized dataset is kept on the device;
each step draws its batch there from a ``torch.Generator`` seeded
``--seed + 1`` (other numbers than ``jax.random``) and runs one
``models/decoder.make_train_step`` step: ``lm_loss``, its gradients,
``clip_by_global_norm`` at 1.0 and AdamW (weight decay 0.01) on the
script's warmup-cosine schedule. The script's ``lax.scan`` block of
``--steps-per-call`` steps is a loop of steps, and ``--steps-per-call``
remains the logging cadence. The checkpoint is written before the eval,
which streams through the port's ``TextGenerator``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from rag_foundation_tpu_torch.app.services import textnorm
from rag_foundation_tpu_torch.app.services.generator import (REFUSAL_TEXT,
                                                             prep_evidence)
from rag_foundation_tpu_torch.app.services.rag import compose_answer
from rag_foundation_tpu_torch.models import encoder as _enc
from rag_foundation_tpu_torch.models.decoder import (DecoderConfig,
                                                     TextGenerator,
                                                     init_params,
                                                     make_train_step,
                                                     save_decoder)
from rag_foundation_tpu_torch.models.gen_tokenizer import (EOS_ID, PAD_ID,
                                                           GenTokenizer,
                                                           train_gen_vocab)
from rag_foundation_tpu_torch.models.optim import (
    adamw, warmup_cosine_decay_schedule)
from rag_foundation_tpu_torch.tools.train_encoder import (keyword_query,
                                                          load_chunks,
                                                          sentence_query)
from rag_foundation_tpu_torch.utils.device import resolve_device


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# triples: (query, evidence segments, answer) via extractive
# self-distillation. Evidence segments are built through the SAME
# generator.prep_evidence the serving path uses (ranked sentences), so
# train-time prompts match serve-time prompts exactly.

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_NUM_SPAN_RE = re.compile(r"\b\d[\w.,%-]*\b")
_CAP_SPAN_RE = re.compile(r"(?<!^)(?<![.!?] )\b[A-Z][a-zA-Z0-9-]{2,}\b")
_Q_STOP = frozenset(
    "a an the is are was were be been do does did to of in on at by for "
    "with from as and or but not no this that these those it its".split())


def cloze_question(rng: np.random.Generator, chunk: str
                   ) -> tuple[str, str] | None:
    """(question, answer_span): remove a number(+context) or proper-noun
    span from a sentence and interrogate the rest — the question SHAPE
    the quality benchmark and real users send, which the ICT pseudo-
    queries (keyword bags) do not cover."""
    sents = [s.strip() for s in _SENT_RE.split(chunk)
             if 6 <= len(s.split()) <= 40]
    if not sents:
        return None
    for _ in range(4):
        s = sents[int(rng.integers(len(sents)))]
        nums = _NUM_SPAN_RE.findall(s)
        caps = _CAP_SPAN_RE.findall(s)
        numeric = bool(nums) and (not caps or rng.random() < 0.6)
        spans = nums if numeric else caps
        if not spans:
            continue
        span = spans[int(rng.integers(len(spans)))]
        rest = [w for w in s.replace(span, " ").split()
                if w.lower().strip(".,;:!?()'\"") not in _Q_STOP
                and w.lower() != span.lower()]
        if len(rest) < 3:
            continue
        head = "How many" if numeric and rng.random() < 0.4 else \
            ("What is the" if rng.random() < 0.6 else "What")
        q = f"{head} {' '.join(rest[:12])}?"
        return q, span
    return None


def build_triples(chunks: list[str], n: int, *, seed: int,
                  refusal_frac: float = 0.08, cloze_frac: float = 0.60,
                  keyword_frac: float = 0.15,
                  max_ans_words: int = 60) -> list[dict]:
    # token_f1 is defined below in this module; resolved at call time
    settings = SimpleNamespace(ENGINE_ANSWER_MODE="span")
    rng = np.random.default_rng(seed)
    out: list[dict] = []
    n_chunks = len(chunks)
    attempts = 0
    while len(out) < n and attempts < n * 6:
        attempts += 1
        gi = int(rng.integers(n_chunks))
        gold = chunks[gi]
        refusal = rng.random() < refusal_frac
        cloze_span = None
        r = rng.random()
        if r < cloze_frac:
            got = cloze_question(rng, gold)
            if got is None:
                continue
            q, cloze_span = got
        elif r < cloze_frac + keyword_frac:
            q = keyword_query(rng, gold)
        else:
            q = sentence_query(rng, gold)
        if not q.strip():
            continue
        d1, d2 = (chunks[int(rng.integers(n_chunks))] for _ in range(2))
        pool = [d1, d2, chunks[int(rng.integers(n_chunks))]] if refusal \
            else [gold, d1, d2]
        rng.shuffle(pool)
        hits = [SimpleNamespace(text=ev, doc_name=f"doc{j}.txt")
                for j, ev in enumerate(pool)]
        evs = prep_evidence(q, hits)
        if refusal:
            ans = REFUSAL_TEXT
        else:
            ans = compose_answer(settings, q, hits)
            # quote-fallback answers embed synthetic doc names the
            # serve-time corpus won't have; span/sentence answers only
            if ans.startswith("From ") or ans == REFUSAL_TEXT:
                continue
            if len(ans.split()) > max_ans_words:
                continue
            # cloze supervision: when the extractive cascade recovers
            # the removed span, distill its output (keeps the reader's
            # span formatting); when it misses, supervise with the
            # span itself — but ONLY if the span is present in the
            # prompt evidence (training a target absent from the
            # prompt would teach hallucination)
            if cloze_span is not None \
                    and token_f1(ans, cloze_span) < 0.5:
                ev_norm = set(_norm_tokens(" ".join(evs)))
                if set(_norm_tokens(cloze_span)) <= ev_norm:
                    ans = cloze_span
                else:
                    continue
        out.append({"q": q, "evs": evs, "ans": ans,
                    "refusal": bool(refusal),
                    "cloze": cloze_span is not None})
    return out


def tokenize_triples(tokenizer, triples: list[dict], *, max_len: int,
                     prefix_len: int, log=log
                     ) -> tuple[np.ndarray, np.ndarray]:
    """``(tokens [n, max_len], loss_mask [n, max_len])`` — prompt ids
    packed left, answer + EOS contiguous after (matching serving, where
    decode starts at position len(prompt)); PAD tail."""
    rows, masks = [], []
    dropped = 0
    for t in triples:
        prompt = tokenizer.encode_prompt(t["q"], t["evs"], prefix_len)
        ans = tokenizer.encode_text(t["ans"]) + [EOS_ID]
        if len(prompt) + len(ans) > max_len:
            dropped += 1
            continue
        row = np.full((max_len,), PAD_ID, np.int32)
        mask = np.zeros((max_len,), np.int8)
        row[: len(prompt)] = prompt
        row[len(prompt): len(prompt) + len(ans)] = ans
        mask[len(prompt): len(prompt) + len(ans)] = 1
        rows.append(row)
        masks.append(mask)
    if dropped:
        log(f"dropped {dropped} over-length triples")
    return np.stack(rows), np.stack(masks)


# ---------------------------------------------------------------------------
# eval: serve-style greedy generation vs the distillation target

_NORM_RE = re.compile(r"[^a-z0-9 ]")


def _norm_tokens(s: str) -> list[str]:
    return _NORM_RE.sub(" ", s.lower()).split()


def token_f1(pred: str, gold: str) -> float:
    p, g = _norm_tokens(pred), _norm_tokens(gold)
    if not p or not g:
        return float(p == g)
    common: dict[str, int] = {}
    for t in p:
        common[t] = common.get(t, 0) + 1
    overlap = 0
    for t in g:
        if common.get(t, 0) > 0:
            common[t] -= 1
            overlap += 1
    if overlap == 0:
        return 0.0
    prec, rec = overlap / len(p), overlap / len(g)
    return 2 * prec * rec / (prec + rec)


def grounded(pred: str, evs: list[str], q: str) -> bool:
    allowed = set()
    for src in evs + [q]:
        allowed |= set(textnorm.content_stems(src))
    missing = [t for t in textnorm.content_stems(pred)
               if not any(textnorm.stems_match(t, a) for a in allowed)]
    return len(missing) <= 1


def run_eval(gen, eval_triples: list[dict], *, log=log) -> dict:
    refusal_head = " ".join(REFUSAL_TEXT.lower().split()[:4])
    f1s, ground, n_ref, ref_ok = [], 0, 0, 0
    f1_by: dict[str, list[float]] = {"cloze": [], "other": []}
    t0 = time.perf_counter()
    for t in eval_triples:
        pred = "".join(gen.stream(t["q"], t["evs"]))
        if t["refusal"]:
            n_ref += 1
            ref_ok += int(pred.lower().startswith(refusal_head))
            continue
        f1 = token_f1(pred, t["ans"])
        f1s.append(f1)
        f1_by["cloze" if t.get("cloze") else "other"].append(f1)
        ground += int(grounded(pred, t["evs"], t["q"]))
    n_ans = max(1, len(f1s))
    res = {
        "answerable_f1": round(float(np.mean(f1s)) if f1s else 0.0, 4),
        # cloze = natural-question shape: the quality-bench proxy
        "cloze_f1": round(float(np.mean(f1_by["cloze"])), 4)
        if f1_by["cloze"] else None,
        "other_f1": round(float(np.mean(f1_by["other"])), 4)
        if f1_by["other"] else None,
        "grounded_rate": round(ground / n_ans, 4),
        "refusal_acc": round(ref_ok / n_ref, 4) if n_ref else None,
        "n_answerable": len(f1s), "n_refusal": n_ref,
        "eval_s": round(time.perf_counter() - t0, 1),
    }
    log(f"eval: {res}")
    return res


# ---------------------------------------------------------------------------

SMOKE_SENTENCES = [
    "The {a} subsystem reports {n} {u} under nominal load.",
    "Operators must check the {a} panel every {n} {u}.",
    "A {a} fault raises an alert within {n} {u}.",
    "The {a} budget is capped at {n} {u} per quarter.",
    "Maintenance of the {a} unit takes {n} {u} on average.",
]
SMOKE_NOUNS = ["cooling", "power", "telemetry", "storage", "network",
               "backup", "sensor", "optics", "vacuum", "guidance"]
SMOKE_UNITS = ["seconds", "minutes", "hours", "watts", "liters",
               "degrees", "percent", "meters"]


def smoke_corpus(seed: int, n_chunks: int = 400) -> list[str]:
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(n_chunks):
        sents = []
        for _ in range(4):
            t = SMOKE_SENTENCES[int(rng.integers(len(SMOKE_SENTENCES)))]
            sents.append(t.format(
                a=SMOKE_NOUNS[int(rng.integers(len(SMOKE_NOUNS)))],
                n=int(rng.integers(2, 90)),
                u=SMOKE_UNITS[int(rng.integers(len(SMOKE_UNITS)))]))
        chunks.append(" ".join(sents))
    return chunks


# ---------------------------------------------------------------------------
# the run

def train(args, log=log) -> dict:
    """The script's ``main`` after parsing: corpus, vocabulary, triples,
    token arrays, ``args.steps`` steps on ``args.device``, the checkpoint
    (written before the eval) and the eval through ``TextGenerator``.
    Returns ``{"summary": the result line's dict, "losses": f32 [steps]
    numpy, "params", "cfg", "tokenizer", "step": the training step (its
    optimizer state), "tokens"/"loss_mask": the training arrays,
    "eval_triples", "n_params", "seconds": unrounded host seconds of
    "vocab", "triples", "tokenize", "train" and "eval"}``; the result
    line is printed by ``main``."""
    dev = resolve_device(args.device)
    seconds = {}
    if args.smoke:
        chunks = smoke_corpus(args.seed)
    else:
        chunks = load_chunks(args.corpus, max_chunks=args.max_chunks)
    log(f"{len(chunks)} chunks (backend: {dev.type})")

    # vocab over a corpus sample + the refusal text (its words must be
    # single-piece-ish so the refusal behavior is easy to emit)
    rng = np.random.default_rng(args.seed)
    sample_idx = rng.permutation(len(chunks))[: args.vocab_sample]
    t0 = time.perf_counter()
    vocab = train_gen_vocab([chunks[i] for i in sample_idx]
                            + [REFUSAL_TEXT] * 50, args.vocab_size)
    tokenizer = GenTokenizer(vocab)
    seconds["vocab"] = time.perf_counter() - t0
    log(f"vocab {tokenizer.vocab_size} pieces in {seconds['vocab']:.0f}s")

    cfg = DecoderConfig(vocab_size=max(tokenizer.vocab_size, 8),
                        hidden=args.hidden, layers=args.layers,
                        heads=args.heads, ffn=args.ffn,
                        max_len=args.max_len, ans_len=args.ans_len)

    t0 = time.perf_counter()
    triples = build_triples(chunks, args.n_examples, seed=args.seed)
    seconds["triples"] = time.perf_counter() - t0
    log(f"{len(triples)} triples in {seconds['triples']:.0f}s")
    n_eval = min(args.eval_n * 2, len(triples) // 10)
    eval_triples = triples[:n_eval][: args.eval_n]
    train_triples = triples[n_eval:]
    t0 = time.perf_counter()
    tokens, loss_mask = tokenize_triples(
        tokenizer, train_triples, max_len=cfg.max_len,
        prefix_len=cfg.prefix_len, log=log)
    seconds["tokenize"] = time.perf_counter() - t0
    log(f"tokenized {len(tokens)} rows in {seconds['tokenize']:.0f}s")

    tok_dev = torch.as_tensor(tokens, device=dev)
    mask_dev = torch.as_tensor(loss_mask, device=dev)
    n_rows = len(tokens)

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg)
    n_params = sum(t.numel() for t in _enc._leaves(params).values())
    log(f"model: {n_params/1e6:.1f}M params, cfg={cfg._asdict()}")

    warmup = min(200, args.steps // 10)
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup, args.steps, end_value=args.lr * 0.05)
    step = make_train_step(cfg, adamw(sched, weight_decay=0.01),
                           max_grad_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    spc = min(args.steps_per_call, args.steps)
    losses = torch.empty(args.steps, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        count = min(spc, args.steps - done)
        for i in range(done, done + count):
            idx = torch.randint(0, n_rows, (args.batch,), generator=gen,
                                device=dev)
            losses[i] = step(params, tok_dev[idx], mask_dev[idx])
        mloss = float(losses[done:done + count].mean())
        done += count
        log(f"step {done}/{args.steps}: loss {mloss:.4f} "
            f"({(time.perf_counter()-t0)/done*1000:.0f} ms/step)")
    seconds["train"] = dur = time.perf_counter() - t0
    log(f"trained {args.steps} steps in {dur:.0f}s")
    # checkpoint BEFORE eval (an eval crash must not discard the run)
    save_decoder(params, args.out, cfg, tokenizer)
    log(f"saved {args.out}")

    t0 = time.perf_counter()
    textgen = TextGenerator(args.out, block=16, device=dev)
    res = run_eval(textgen, eval_triples, log=log)
    for t in eval_triples[:3]:
        log(f"  Q: {t['q'][:90]}")
        log(f"  gold: {t['ans'][:90]}")
        log(f"  pred: {''.join(textgen.stream(t['q'], t['evs']))[:90]}")
    seconds["eval"] = time.perf_counter() - t0
    summary = {
        "mode": "smoke" if args.smoke else "distill",
        "steps": args.steps, "batch": args.batch,
        "params_m": round(n_params / 1e6, 2),
        "triples": len(triples), "ckpt": args.out,
        "train_s": round(dur, 1), **res,
    }
    return {"summary": summary, "losses": losses.cpu().numpy(),
            "params": params, "cfg": cfg, "tokenizer": tokenizer,
            "step": step, "tokens": tokens, "loss_mask": loss_mask,
            "eval_triples": eval_triples, "n_params": n_params,
            "seconds": seconds}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default=None,
                    help="corpus.jsonl from build_text_corpus.py")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + synthetic corpus (CI checkpoint)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--n-examples", type=int, default=60_000)
    ap.add_argument("--max-chunks", type=int, default=120_000)
    ap.add_argument("--vocab-size", type=int, default=8192)
    ap.add_argument("--vocab-sample", type=int, default=12_000,
                    help="chunks sampled for BPE vocab training")
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--ffn", type=int, default=1536)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--ans-len", type=int, default=96)
    ap.add_argument("--steps-per-call", type=int, default=50,
                    help="steps between two log lines")
    ap.add_argument("--eval-n", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "decoder.npz"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.vocab_size = min(args.vocab_size, 2048)
        args.hidden, args.layers, args.heads = 96, 2, 2
        args.ffn, args.max_len, args.ans_len = 192, 192, 48
        args.steps = min(args.steps, 300)
        args.batch = min(args.batch, 32)
        args.n_examples = min(args.n_examples, 2000)
        args.eval_n = min(args.eval_n, 24)
    elif not args.corpus:
        ap.error("--corpus is required without --smoke")
    return args


def main(argv: list[str] | None = None) -> None:
    print(json.dumps(train(parse_args(argv))["summary"]), flush=True)


if __name__ == "__main__":
    main()
