"""Train the MiniLM-class encoder and save an npz checkpoint that the
engine loads through ``encoder_ckpt`` (``ENGINE_ENCODER_CKPT``).

    python -m rag_foundation_tpu_torch.tools.train_encoder \\
        --corpus corpus.jsonl --steps 3000 --batch 256 --out minilm_ict.npz
    python -m rag_foundation_tpu_torch.tools.train_encoder   # synthetic

Counterpart of ``scripts/train_encoder.py``: the same two modes, flags,
defaults, log lines (stderr) and result line (stdout), plus ``--device``
(default ``cuda``; ``cpu`` runs the plain attention on the host).

1. ``--corpus corpus.jsonl`` (the production recipe; build the corpus
   with ``scripts/build_text_corpus.py``): self-supervised Inverse Cloze
   Task training. Each chunk yields a keyword pseudo-query and a sentence
   pseudo-query, trained against the chunk with symmetric InfoNCE and
   in-batch negatives, then evaluated on held-out chunks beside the hash
   encoder.
2. no ``--corpus``: the synthetic-paraphrase loop, the fast mechanics
   check.

The dataset is tokenized on the host (numpy, bit for bit the script's
arrays) and kept on the device. Each step draws its batch on the device
from a ``torch.Generator`` seeded ``--seed + 1`` with the script's
structure (chunks first, then a view per draw; other numbers than
``jax.random``) and runs one ``make_train_step`` step: the script's
``lax.scan`` block of ``--steps-per-call`` steps is a loop of steps, and
``--steps-per-call`` remains the logging cadence. The checkpoint is
written in the JAX npz format, which both packages read.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from rag_foundation_tpu_torch.models.encoder import (MiniLMEncoder,
                                                     make_train_step,
                                                     save_params)
from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder
from rag_foundation_tpu_torch.models.optim import (
    adamw, warmup_cosine_decay_schedule)
from rag_foundation_tpu_torch.utils.device import resolve_device

TOPICS = [
    "quarterly revenue growth", "tpu kernel latency", "customer churn",
    "cloud migration cost", "security incident response",
    "vector index rebuild", "employee onboarding", "api rate limits",
    "budget forecast accuracy", "observability dashboards",
    "posting list compaction", "contrastive encoder training",
    "cache hit ratio", "database row locks", "streaming ingestion",
    "citation extraction", "multi tenant isolation", "admin audit trail",
    "token cost ledger", "watchdog recovery",
]
TEMPLATES_Q = [
    "what changed about {t} this quarter",
    "summary of {t}", "how did {t} evolve", "status report on {t}",
]
TEMPLATES_D = [
    "the report covers {t} in detail with updated figures",
    "{t} improved significantly according to the latest review",
    "analysis: {t} trends, risks, and next steps",
    "notes about {t} from the engineering retrospective",
]

_WORDS = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.-]*")
_SENT = re.compile(r"(?<=[.!?])\s+")
_STOP = frozenset(
    "a an the is are was were be been being do does did to of in on at "
    "by for with from as and or but not no this that these those it its "
    "if then than there here can could should would may might will "
    "shall has have had".split())


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_pairs(rng: np.random.Generator, n: int) -> list[tuple[str, str]]:
    pairs = []
    for _ in range(n):
        t = TOPICS[rng.integers(len(TOPICS))]
        q = TEMPLATES_Q[rng.integers(len(TEMPLATES_Q))].format(t=t)
        d = TEMPLATES_D[rng.integers(len(TEMPLATES_D))].format(t=t)
        pairs.append((q, d))
    return pairs


def retrieval_acc(enc, pairs) -> float:
    """Top-1 accuracy matching each query to its paired doc."""
    q = enc.encode([p[0] for p in pairs])
    d = enc.encode([p[1] for p in pairs])
    pred = np.argmax(q @ d.T, axis=1)
    return float(np.mean(pred == np.arange(len(pairs))))


# -- ICT dataset (host numpy, bit for bit the script's) -----------------------

def load_chunks(path: str, *, max_words: int = 100,
                max_chunks: int = 150_000) -> list[str]:
    chunks: list[str] = []
    with open(path) as f:
        for line in f:
            text = json.loads(line)["text"]
            words = text.split()
            for i in range(0, len(words), max_words):
                part = " ".join(words[i: i + max_words])
                if len(part.split()) >= 25:
                    chunks.append(part)
                if len(chunks) >= max_chunks:
                    return chunks
    return chunks


def _substitute(rng: np.random.Generator, tokens: list[str],
                syn: dict | None, p: float) -> list[str]:
    """Swap content words for mined distributional neighbours with
    probability ``p``: the pseudo-query says one word, the chunk its
    neighbour, and InfoNCE pulls them together."""
    if not syn or p <= 0:
        return tokens
    out = []
    for w in tokens:
        nbrs = syn.get(w)
        if nbrs and rng.random() < p:
            out.append(nbrs[int(rng.integers(len(nbrs)))][0])
        else:
            out.append(w)
    return out


def keyword_query(rng: np.random.Generator, chunk: str,
                  syn: dict | None = None, sub_p: float = 0.0) -> str:
    content = [w for w in _WORDS.findall(chunk.lower())
               if w not in _STOP and len(w) > 2]
    if not content:
        return chunk[:40]
    k = int(rng.integers(3, 9))
    take = rng.choice(len(content), size=min(k, len(content)),
                      replace=False)
    return " ".join(_substitute(rng, [content[i] for i in take],
                                syn, sub_p))


def sentence_query(rng: np.random.Generator, chunk: str,
                   syn: dict | None = None, sub_p: float = 0.0) -> str:
    sents = [s for s in _SENT.split(chunk) if len(s.split()) >= 4]
    if not sents:
        return chunk[:80]
    s = sents[int(rng.integers(len(sents)))]
    if not syn or sub_p <= 0:
        return s
    return " ".join(_substitute(rng, s.lower().split(), syn, sub_p))


def build_ict_arrays(enc, chunks: list[str], *, q_len: int, d_len: int,
                     seed: int, syn: dict | None = None,
                     sub_p: float = 0.0, log=print):
    """Pre-tokenized (q_ids [2n, q_len], d_ids [2n, d_len]): row i and row
    n+i are the keyword / sentence views of chunk i. With mined ``syn``
    neighbours, query tokens substitute with probability ``sub_p``."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    d_ids = enc.tokenizer.encode_batch(chunks, d_len)
    kq = [keyword_query(rng, c, syn, sub_p) for c in chunks]
    sq = [sentence_query(rng, c, syn, sub_p) for c in chunks]
    q_ids = enc.tokenizer.encode_batch(kq + sq, q_len)
    d_ids = np.concatenate([d_ids, d_ids])
    log(f"tokenized {len(chunks)} chunks x2 views in "
        f"{time.perf_counter()-t0:.0f}s"
        + (f" (substitution p={sub_p}, {len(syn)} syn words)"
           if syn and sub_p > 0 else ""))
    return q_ids, d_ids


def eval_retrieval(encode_fn, enc_name: str, chunks: list[str],
                   queries: list[str], log=print) -> dict:
    """recall@1/@10 of queries against their source chunks."""
    d = encode_fn(chunks)
    q = encode_fn(queries)
    scores = q @ d.T
    order = np.argsort(-scores, axis=1)[:, :10]
    want = np.arange(len(queries))
    r1 = float(np.mean(order[:, 0] == want))
    r10 = float(np.mean([w in set(o) for w, o in zip(want, order)]))
    log(f"{enc_name}: recall@1 {r1:.3f} recall@10 {r10:.3f} "
        f"(n={len(queries)})")
    return {"recall@1": r1, "recall@10": r10}


# -- the two modes -------------------------------------------------------------

def train_ict(args, log=_log) -> dict:
    """ICT training. Returns ``{"summary": the result line's dict,
    "losses": f32 [steps] numpy, "train_s": unrounded seconds,
    "encoder": the trained MiniLMEncoder}``; the result line is printed
    by ``main``."""
    dev = resolve_device(args.device)
    chunks = load_chunks(args.corpus, max_chunks=args.max_chunks)
    log(f"{len(chunks)} chunks from {args.corpus} (backend: {dev.type})")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(chunks))
    eval_n = min(args.eval_n, len(chunks) // 10)
    eval_chunks = [chunks[i] for i in order[:eval_n]]
    train_chunks = [chunks[i] for i in order[eval_n:]]

    syn = None
    if args.synonyms:
        with open(args.synonyms) as f:
            syn = json.load(f)
        log(f"loaded {len(syn)} synonym entries from {args.synonyms}")

    enc = MiniLMEncoder(dim=args.dim, seed=args.seed, max_len=args.d_len,
                        device=dev)
    cfg = enc.cfg
    q_ids, d_ids = build_ict_arrays(enc, train_chunks, q_len=args.q_len,
                                    d_len=args.d_len, seed=args.seed,
                                    syn=syn, sub_p=args.sub_p, log=log)
    n_pairs = len(q_ids)
    q_dev = torch.as_tensor(q_ids, device=dev)
    d_dev = torch.as_tensor(d_ids, device=dev)

    warmup = min(200, args.steps // 10)
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup, args.steps, end_value=args.lr * 0.05)
    step = make_train_step(cfg, adamw(sched), max_grad_norm=1.0,
                           temperature=args.temperature, symmetric=True)
    n_chunks_t = n_pairs // 2  # rows [i] and [n_chunks+i] share a doc
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def batch_rows() -> torch.Tensor:
        # sample CHUNKS then a view per draw: sampling raw rows could put
        # both views of one chunk in a batch, making an exact copy of a
        # query's positive act as an in-batch negative
        if args.hard_neg:
            # adjacent chunks come from one source passage stream: pairing
            # i with i+1 fills the batch with near-duplicate topics
            half = args.batch // 2
            base = torch.randint(0, n_chunks_t - 1, (half,), generator=gen,
                                 device=dev)
            cidx = torch.cat([base, base + 1])
        else:
            cidx = torch.randint(0, n_chunks_t, (args.batch,),
                                 generator=gen, device=dev)
        view = torch.randint(0, 2, cidx.shape, generator=gen, device=dev)
        return cidx + view * n_chunks_t

    spc = min(args.steps_per_call, args.steps)
    losses = torch.empty(args.steps, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        count = min(spc, args.steps - done)  # exact: no overshoot
        for i in range(done, done + count):
            idx = batch_rows()
            losses[i] = step(enc.params, q_dev[idx], d_dev[idx])
        mloss = float(losses[done:done + count].mean())
        done += count
        log(f"step {done}/{args.steps}: loss {mloss:.4f} "
            f"({(time.perf_counter()-t0)/done*1000:.0f} ms/step)")
    dur = time.perf_counter() - t0
    log(f"trained {args.steps} steps in {dur:.0f}s")
    # checkpoint BEFORE eval: an eval crash must not discard the run
    save_params(enc.params, args.out, cfg=cfg)
    run = {"losses": losses.cpu().numpy(), "train_s": dur, "encoder": enc}

    # held-out eval: keyword queries against the held-out chunk pool, the
    # hash encoder on identical data as the baseline
    if not eval_chunks:
        log("corpus too small for a held-out eval; skipping")
        run["summary"] = {"mode": "ict", "steps": args.steps,
                          "chunks": len(chunks), "ckpt": args.out,
                          "train_s": round(dur, 1)}
        return run
    rng_e = np.random.default_rng(args.seed + 7)
    eval_queries = [keyword_query(rng_e, c) for c in eval_chunks]
    mini = eval_retrieval(enc.encode, "minilm(ICT)", eval_chunks,
                          eval_queries, log=log)
    hash_enc = HashingEncoder(dim=args.dim)
    hsh = eval_retrieval(
        lambda ts: hash_enc.encode(ts), "hash-fnv-v2", eval_chunks,
        eval_queries, log=log)
    run["summary"] = {
        "mode": "ict", "steps": args.steps, "batch": args.batch,
        "chunks": len(chunks), "eval_n": eval_n,
        "minilm": mini, "hash": hsh, "ckpt": args.out,
        "train_s": round(dur, 1),
    }
    return run


def train_synthetic(args, log=_log) -> str:
    """The synthetic-paraphrase loop; returns the ``RESULT`` line."""
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    enc = MiniLMEncoder(dim=args.dim, seed=args.seed, max_len=args.q_len,
                        device=dev)
    cfg = enc.cfg

    eval_pairs = [(TEMPLATES_Q[0].format(t=t), TEMPLATES_D[0].format(t=t))
                  for t in TOPICS]
    acc0 = retrieval_acc(enc, eval_pairs)
    log(f"retrieval top-1 before: {acc0:.3f}")

    step = make_train_step(cfg, adamw(args.lr))
    t0 = time.perf_counter()
    for i in range(args.steps):
        pairs = make_pairs(rng, args.batch)
        q_ids = torch.as_tensor(enc.tokenizer.encode_batch(
            [p[0] for p in pairs], args.q_len), device=dev)
        d_ids = torch.as_tensor(enc.tokenizer.encode_batch(
            [p[1] for p in pairs], args.q_len), device=dev)
        loss = step(enc.params, q_ids, d_ids)
        if i % 25 == 0 or i == args.steps - 1:
            log(f"step {i}: loss {float(loss):.4f}")
    dur = time.perf_counter() - t0
    acc1 = retrieval_acc(enc, eval_pairs)
    log(f"retrieval top-1 after: {acc1:.3f} "
        f"({args.steps} steps in {dur:.1f}s)")

    save_params(enc.params, args.out, cfg=cfg)
    return (f"RESULT acc_before={acc0:.3f} acc_after={acc1:.3f} "
            f"ckpt={args.out}")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--corpus", default=None,
                    help="corpus.jsonl from build_text_corpus.py -> ICT "
                         "mode; omit for the synthetic smoke loop")
    ap.add_argument("--max-chunks", type=int, default=150_000)
    ap.add_argument("--eval-n", type=int, default=2048)
    ap.add_argument("--q-len", type=int, default=32)
    ap.add_argument("--d-len", type=int, default=128)
    ap.add_argument("--steps-per-call", type=int, default=50,
                    help="steps between two log lines")
    ap.add_argument("--hard-neg", action="store_true",
                    help="batch adjacent same-source chunks as hard "
                         "in-batch negatives")
    ap.add_argument("--synonyms", default=None,
                    help="mined neighbour json (scripts/mine_synonyms.py)"
                         " for substitution-augmented ICT")
    ap.add_argument("--sub-p", type=float, default=0.3,
                    help="per-token substitution probability in "
                         "pseudo-queries (with --synonyms)")
    ap.add_argument("--max-len", type=int, dest="q_len_legacy",
                    default=None, help="(legacy alias of --q-len)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "minilm_finetuned.npz"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "attention)")
    args = ap.parse_args(argv)
    if args.q_len_legacy is not None:
        args.q_len = args.q_len_legacy
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    if args.corpus:
        print(json.dumps(train_ict(args)["summary"]), flush=True)
    else:
        print(train_synthetic(args), flush=True)


if __name__ == "__main__":
    main()
