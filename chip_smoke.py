#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rag_foundation_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py            # full size: two 10M x 768 stores,
                                     # then the exact scan of 1M x 768
    python3 chip_smoke.py --rows 200000 --pq-rows 200000 \
        --exact-rows 100000          # quick check

Phases (each one fails the run: non-zero exit, no result line):

1. Card and build: the card's name and power limit, torch/CUDA versions,
   the build of every kernel library from ``rag_foundation_tpu_torch/csrc``
   (nvcc, sm_90a, the compilers started together).
2. Each kernel against its plain PyTorch version on the card at a small
   size: the flat list scan (int8 exact, f32/bf16 within a stated
   tolerance), the ADC list scan (int8 LUT unpacked and packed exact,
   bf16 LUT within a stated tolerance, dead rows, a dead sub-block, a
   dispatch with empty tails) and the gather-and-rescore (exact, negative
   ids, a table whose row count is not a multiple of 8); then both list
   scans on edge cases: 0, 1, 8, 9, 16 and 17 live slots of qcap 32,
   sub-blocks of 0, 1 and 128 live rows, p from 1 to 8, packed codes and
   the bf16 LUT, f32 and bf16 flat lists; and the ADC scan on lists of 29
   sub-blocks at nlist 4, which it splits between blocks.
3. The main path through the entry points a user calls: the port's
   ``Engine`` (ivf_flat_int8, d=768, nlist=4096, nprobe=32, p=3) behind
   ``EngineRpcServer``, driven only through ``RemoteEngine``: ingest real
   documents (enough to build an int8 body), pad the store to ``--rows``
   on the device, single and concurrent searches, a Q=1024 batch,
   citations, recall against the exact scan and the recall audit, the
   engine's Prometheus text over RPC (``metrics_text``, parsed here: one
   batch-size observation a sequential search), and an in-process
   Q=1024 search of stored rows. Kernel launch counters are zeroed just
   before and read just after.
4. Restart: a fresh ``Engine`` on the same ``data_dir`` reloads the saved
   int8 body verbatim and gives the same hits.
5. The kernel against its plain version on the main path's Q=1024
   dispatch, with times: kernel, plain version, a library yardstick, and
   the bound; then that search split by stage on the card (coarse +
   dispatch, list scan, regather and top-k).
6. The ``ivf_pq`` main path, after the int8 store is released: a second
   ``Engine`` (ivf_pq, d=768, m=192 unpacked 4-bit codes, device refine,
   nlist=4096, nprobe=32) behind ``EngineRpcServer``: the same documents
   over RPC (enough to build a PQ body), then a bulk load
   (``StoreIndex.bulk_load_archive``) of those rows plus pads generated
   on the card up to ``--pq-rows``; single and concurrent searches, a
   Q=1024 batch, citations, recall against the exact scan, the recall
   audit, and a short run of the ``host`` and ``none`` refine tiers.
   The two kernels' launch counters are zeroed just before and read
   just after.
7. Restart of the ``ivf_pq`` store on its ``data_dir``: the saved body
   (codes, ids, codebooks, refine) and archive reload verbatim.
8. The two kernels against their plain versions on the PQ path's own
   Q=1024 dispatch, with times and bounds; then that search split by
   stage on the card (coarse + dispatch, LUT build and gather, list scan,
   regather and ADC top-C, re-rank).
9. After the PQ store is released: ``fused_topk`` and ``block_topk``
   against their plain versions at a small size (f32 and bf16, unaligned
   Q and N, a valid count below N as a device tensor, k above the live
   rows, integer-valued rows with duplicates bit-identical, two splits of
   the rows giving one output, ``block_topk(p=k)`` equal to
   ``fused_topk``).
10. The exact-scan path through ``tools.exact_scan.run_exact_1m`` at full
    width (``--exact-rows`` x 768 bf16, Q=1024, k=10): the two kernels'
    launch counters zeroed just before and read just after, recall@10 of
    ``block_topk(p=2)`` against ``fused_topk`` and ``exact_topk``, which
    must name the same rows; then each kernel against its plain version
    on those inputs with times (``block_topk``'s kernel and its stage 2
    also apart), a library yardstick and the bound.
11. ``exact_topk_hosted`` over a pinned host copy of ``--exact-rows`` x 768
    f32 rows against ``exact_topk`` on the device copy, with seconds and
    GB/s; then a 20,000-row ``build_ivf_flat_streaming`` body adopted by
    a ``StoreIndex`` with ``approx_routing=True`` and searched.
12. ``flash_attention`` against its plain version on the card, bf16 and
    f32, H=12, D=32, S in {16, 32, 100, 128, 512} (B*H = 288 at S=512),
    with pads, an all-pad row and a row of one token, within a stated
    tolerance.
13. The MiniLM encoder path at full width (hidden 384, 6 layers, 12
    heads): an ``EngineRpcServer`` with ``encoder="minilm"`` and the
    repository's trained ``checkpoints/minilm_ict.npz`` (max_len 128)
    ingests the fact documents and serves single and 64 concurrent
    searches over RPC (the kernel's launch counter must rise on ingest
    and on a single search; recall@10 >= 0.95 against the exact scan; the
    stored embeddings against the plain attention on the card, cosine
    >= 0.999); the same documents under ``encoder="hybrid"`` (768 = 384
    hash + 384 MiniLM, w=0.35); then a random MiniLM-L6 with
    ``max_len=512`` made by ``init_params`` from ``--seed``, saved with
    ``save_params`` and loaded by an ``Engine`` through
    ``encoder_ckpt``, which ingests long documents at the default 200
    words a chunk: batches of 256 chunks at S=512, the kernel's main
    shape, with chunks/s, and the kernel's time there beside its bound
    (bytes, tensor operations and one exponential a same-segment pair; the
    exponentials the kernel issues printed beside them), its plain version
    and ``scaled_dot_product_attention`` (timed only); the kernel's
    launches on these serve phases are printed by (B, S).

14. The attention backward kernels (``flash_attention_bwd_dkv``,
    ``flash_attention_bwd_dq``) against their plain versions on the card,
    bf16 and f32, H=12, S in {1, 8, 16, 32, 33, 64, 65, 100, 128, 256,
    512, 200}, D 16, 32 and 64, with pads, an all-pad row and a row of one
    token; the forward kernel's ``lse`` against a masked logsumexp;
    ``FlashAttention``'s gradients against autograd of the plain forward;
    then the backward kernels again on other segment layouts: three packed
    segments a row, ids 0-4 in no order, a row whose keys' ids differ from
    its queries', and a row whose queries see no key.
15. Encoder training at full width: a corpus from the recipe's own
    ``scripts/build_text_corpus.py`` (``--corpus-passages``), then the
    port's trainer (``tools.train_encoder.train_ict``, ICT mode: batch 256,
    q_len 32, d_len 128, symmetric InfoNCE at temperature 0.05, adamw lr
    3e-4 with warmup and cosine decay, clip 1.0) for ``--train-steps``
    steps, the three attention launch counters zeroed just before and read
    just after (the forward's also by (B, S)), a finite and falling loss, ms/step, pairs/s and held-out
    recall beside the hash encoder; the saved checkpoint served by an
    ``Engine`` through ``encoder_ckpt``; one step's gradients with the
    kernels against the plain attention (worst cosine a leaf); a few steps
    at d_len 512 with peak device memory; the two backward kernels timed on
    the steps' own layer-0 inputs (q side S=32, d side S=128, and S=512)
    beside their plain versions, ``scaled_dot_product_attention``'s
    backward, their bounds, the exponential floor and the share of 16x16
    blocks with no same-segment pair. ``--lengths-out`` writes those rows'
    lengths for ``time_kernels --lengths``.

16. The generative chat path at full width: an ``Engine`` with phase 13's
    MiniLM store and the repository's ``checkpoints/decoder_distill.npz``
    (vocab 8192, hidden 384, 6 layers, 6 heads, ffn 1536, max_len 512,
    ``gen_block`` 16) behind ``EngineRpcServer``, driven only through
    ``RemoteEngine``: ``prewarm_generator``, the fact documents ingested,
    then for each of 16 fact questions a search (k=8) and
    ``generate_stream`` over its hits' texts. The flash-attention forward's
    launch counter is zeroed just before and read just after, and must
    rise in the searches; every stream ends with its done frame; every
    answer equals the in-process loop's, whose ids all lie in its prompt,
    the function words and EOS; for two questions the card's bf16
    prefill logits against the port's CPU path in f32 within
    ``DECODER_LOGIT_TOL``, and the card's argmax equal to the CPU's
    (teacher-forced on the card's ids) on every step whose f32 top-1/top-2
    margin exceeds twice it; four concurrent streams give the sequential
    texts. Printed: prefill and ``decode_block`` times, device launches a
    token and the device's busy share (``torch.profiler``, one block), the
    decode bytes bound a token (``utils/roofline.decode_bound``) and the
    ratio to it, time to first delta and answer latency over RPC (p50,
    p99), answer tokens/s and peak device memory.

17. The sharded engine, run after phase 5 on phase 3's store: an
    ``Engine`` with ``mesh_shards=4`` and ``mesh=make_mesh(4,
    devices=[card] * 4)`` (four logical shards on the one card) on phase
    3's ``data_dir``, whose saved body reloads as four views; it adopts
    phase 3's 10M int8 body as four views (its pads are not persisted),
    and behind ``EngineRpcServer`` serves single and 64 concurrent
    searches and a Q=1024 batch through ``RemoteEngine``, with recall@10
    of the fact questions against phase 3's exact scan (>= 0.95), the
    recall audit through the shards, and ``ivf_list_scan``'s launch
    counter (zeroed just before, read just after) at 4 a body search. In
    process: Q=1024 stored rows against the one-device search at the same
    global nprobe 32 (overlap, each row found first, >= 0.95, and the
    probes each shard's qcap drops), that search split by stage (per-shard
    routing, the four scans, per-shard regather + top-k, the merge), one
    shard's kernel against its plain version on its own dispatch with its
    time and bound; then fact documents into the sharded tail over RPC and
    a flush of 1,088 rows through ``sharded_ivf_append``, which must land
    in phase 3's own body tensors and be found.
18. The sharded IVF-PQ engine, run after phase 8: an ``Engine`` with
    ``mesh_shards=4``, ``pq_refine="host"`` and ``[card] * 4`` restarted
    on phase 6's ``data_dir`` (its saved body, which keeps a device
    refine table, is restored whole), adopting phase 6's 10M body without
    its refine table as four views and its host archive. Behind
    ``EngineRpcServer`` it serves the fact questions and a Q=1024 batch
    through ``RemoteEngine`` (bf16 query transport, the ADC top-C over
    the shards, the host archive's re-rank on the native shim; the
    in-process Q=1024 search also timed with the numpy re-rank, and the
    re-rank of one such search's own candidates A/B'd native against
    numpy, ten pairs, scores within ``F32_TOL``): recall@10 of the fact
    questions against phase 6's exact scan as ``Engine.search`` asks the
    index (a chunk tying the 10th score counts; >= 0.95), and
    ``pq_list_scan``'s launch counter (zeroed just before, read just
    after) at 4 a body search with no device re-rank. In process: the ADC
    top-10 overlap of ``sharded_ivfpq_search`` with the one-device
    ``ivfpq_search`` at nprobe 32 (>= 0.9 on the fact questions), and one
    shard's kernel against its plain version with its time and bound.
19. The JAX app's engine calls, run after phase 5 on phase 3's store
    (its 10M int8 body adopted by an ``Engine`` restarted on phase 3's
    ``data_dir``, phase 3's settings) behind ``EngineRpcServer``, driven
    only through ``RemoteEngine`` in the order ``EngineRag`` makes them:
    ``create_store`` of an app-shaped key (``stores/{user}-{slug}-{hex8}``),
    ``ingest_document`` of ``APP_TENANT_DOCS`` new fact documents and
    ``store_stats``; searches over [the 10M store, the tenant's store] at
    the app's k=12 and k=128, one at a time (right document first, in
    the right store, >= 0.95) and from 64 concurrent clients (QPS, p50,
    p99, right document first and the probes each batch's qcap drops;
    ``ivf_list_scan``'s launch counter, zeroed just before and read just
    after, must move); a ``doc_filter`` and a ``meta_filter`` search;
    ``has_store``, ``delete_document`` (gone from the next search),
    ``delete_store``. The engine's hash encoder must have loaded the
    native shim; ingest chunks/s (with the store's save in it timed
    apart) and the encode alone are printed for it and for the Python
    hasher on the same documents.

20. The generative decoder's trainer at full width, after phase 16, on
    phase 15's corpus: ``tools.train_decoder.train`` with the recipe of
    ``checkpoints/decoder_distill.npz`` (vocab 8192, hidden 384, 6 layers,
    6 heads, ffn 1536, max_len 512, ans_len 96, batch 64, lr 4e-4, bf16)
    cut to ``--decoder-steps`` of 4,000 steps, ``--decoder-triples`` of
    60,000 triples and ``--decoder-eval`` of 128 eval questions (each cut
    printed beside the recipe's value). It fails unless the vocabulary has
    8192 pieces, the parameters stayed on the card, the loss is finite and
    its last tenth's mean below its first tenth's, the saved checkpoint has
    ``decoder_distill.npz``'s keys and shapes, reloads through
    ``load_decoder`` equal to the trained parameters and streams through
    ``TextGenerator``, and one step's gradients on the card (bf16) reach
    cosine ``GRAD_COS_MIN`` a leaf against the port's CPU path in f32 on
    the same parameters and batch. Printed: the host's seconds (vocabulary,
    triples, tokens), ms a step beside ``utils/roofline.decoder_train_bound``,
    positions, real and answer tokens/s, peak device memory, the device's
    busy share over three steps with device time by kernel family
    (``torch.profiler``), and the eval's ``answerable_f1``, ``cloze_f1``,
    ``refusal_acc`` and ``grounded_rate``.
21. Processes joined into one mesh, after phase 17 on phase 3's body: two
    processes (``torch.multiprocessing`` spawn) on the one card, each
    joined by ``init_distributed(..., backend="gloo")`` to a mesh of two
    shards, one a process, under one timeout (a process that fails, or
    the pod past it, kills both and fails with their stderr). Each keeps
    its half: of 1M x 768 f32 rows for ``sharded_topk`` (Q=1024, k=10),
    bit-identical to this process's ``exact_topk``; of phase 3's 10M int8
    body's lists (2,048 of 4,096) for ``sharded_ivf_search`` on the fact
    questions (Q=1024, nprobe_local 16, p 3); of a 1M-row IVF-PQ body
    built in the phase (phase 6's comes later in the run) for
    ``sharded_ivfpq_search``; each equal, ids and values, to the two-shard
    search in this process on ``[card] * 2``, and the two processes'
    results equal. The body and rows reach the processes as CUDA IPC
    handles of this process's tensors (the saved ``body.npz`` holds only
    the real documents: pads are not persisted). Printed: each process's
    ``ivf_list_scan`` and ``pq_list_scan`` launches (counters zeroed just
    before), the Q=1024 times beside the single-process ones, the
    candidates' all-gather share, the backend.
22. The sharded training step at full width, after phase 15 on its
    corpus: ``make_sharded_train_step`` at the flagship ``EncoderConfig()``
    (bf16), batch ``TRAIN_BATCH`` (q_len 32, d_len 128), the recipe's
    loss and optimizer, on ``[card] * 4`` at data 2 x shard 2, with
    ``sharded_topk`` over 1M x 384 f32 rows and ``assign_clusters`` to
    4,096 centroids. It fails unless the loss is finite and within
    ``DP_LOSS_RTOL`` of the ``data=1`` step's on the same batch and
    parameters, every leaf's gradient reaches ``GRAD_COS_MIN`` against
    it, the ids and values equal ``exact_topk`` of the step's query
    embeddings and the assignment ``assign_clusters`` (but near-ties
    within ``F32_TOL``), the parameters stayed on the card and the three
    attention counters (zeroed just before the step) moved. Printed: ms a
    step beside the ``data=1`` step and phase 15's step on the same batch,
    the attention launches a step, the device's busy share over three
    steps; then ``tools.dryrun_multichip --devices 8`` on the card.

23. The port's app, after phase 19 on phase 3's store. (a) ``python -m
    rag_foundation_tpu_torch.app.main`` with its ``Engine`` in process on
    the card (``exact``, the settings of ``tests/app_helpers.make_settings``,
    dev login, the in-process worker), driven over HTTP by the port's
    ``benchmark.runner``: register and log in, create a store, upload the
    ten documents of ``benchmarks/quality/docs`` through ``/api/upload``,
    poll ``op-status`` to DONE, then the 120 quality questions over SSE
    (``run_benchmark``, 4 clients); then the same with
    ``RAGTPU_ENGINE_PLATFORM=cpu``. It fails unless every stream keeps
    the SSE contract (start, text-start, text-delta*,
    text-end, source-document*, finish, [DONE]), each app logged its
    device, and the card's answers and citations equal the CPU's on
    every question (a pair that differs is searched again in this
    process on both devices: both hit lists printed, and only a swap of
    hits whose scores tie within 1e-5 passes). Printed: EM, F1, citation
    hit, refusal accuracy, latency avg/p95, chats/s. (b)
    ``APP_API_PROCESSES`` API processes of the app (``--workers``,
    ``RAGTPU_ENGINE_RPC_MODE=connect``) in front of an
    ``EngineRpcServer`` here that serves phase 3's 10M int8 body at
    phase 3's settings: two stores made through the API, the first's
    ``engine_key`` read from the app's sqlite and given the 10M body,
    ``APP_FACT_DOCS`` fact documents uploaded into the second; chats
    over both stores one at a time (right document cited first >=
    ``RECALL_MIN``), then ``APP_CONCURRENCY`` concurrent SSE chats from
    ``run_benchmark`` in ``APP_CLIENT_PROCESSES`` processes that start
    together (this process's interpreter lock is the engine's): first as
    a closed loop (printed, nothing asserted on its batches, which the
    host keeps under the Q*nprobe*8 > nlist crossover), then in
    ``APP_WAVES`` waves of ``APP_CONCURRENCY`` chats sent together:
    ``ivf_list_scan``'s counter (zeroed just before each, read just
    after) must move in the waves (where the host's pace kept every batch
    of the measured waves at or under the crossover, up to
    ``APP_MORE_WAVES`` more are sent, ``APP_WAVES_STEP`` at a time, until
    one crosses; their number is printed), and the largest dispatch the chats
    gave it is held to the plain version bit for bit and timed beside its
    bound. Printed: time to first text-delta and answer latency p50/p99,
    chats/s, the engine's batch sizes, each process's CPU seconds, the
    app's and the engine's stages.
24. The split topology production runs, after phase 23 (b) behind the
    same ``EngineRpcServer`` (phase 3's 10M int8 body): a new deployment
    whose first admin ``python -m
    rag_foundation_tpu_torch.tools.create_first_admin`` makes,
    ``APP_API_PROCESSES`` API processes in connect mode with
    ``WORKER_IN_PROCESS=0`` and ``APP_SPLIT_WORKERS`` ``python -m
    rag_foundation_tpu_torch.app.worker_main`` processes in connect mode
    (their ``recall_audit`` cron every ``APP_AUDIT_S`` s). It fails unless
    ``APP_FACT_DOCS`` fact documents uploaded together reach DONE through
    the workers (each job leased once; both logged ``worker_started``),
    a chat on each fact cites its document first, a deleted document is
    no longer cited and is listed by ``/api/admin/deletions``, its admin
    restore is re-ingested by a worker and cited first again,
    ``/api/admin/engine/recall-probe`` on a store holding the 10M body (k
    10, sample 32) launches ``ivf_list_scan`` (counter zeroed just before,
    read just after; the probe's own dispatch bit-identical to the plain
    version and timed beside its bound) and gives the recall the
    workers' ``recall_audit`` line gives for that store,
    ``/api/admin/system`` equals the sqlite rows, ``/api/costs/summary``
    counts the user's chats, ``/api/settings`` round-trips, ``/`` and
    ``/static/app.js`` serve their files, ``python -m
    rag_foundation_tpu_torch.benchmark.loadgen`` (``LOADGEN_*``: the
    reference's profile) reports no errors, and SIGTERM stops both
    workers with ``worker_stopped``. Printed: upload to DONE p50 and max,
    delete to unserved ms, restore to cited s, the probe's HTTP ms,
    recall and kernel ms beside its bound, loadgen's rps, ok rps and p95
    a task.
25. The app at the quality benchmark's production configurations, after
    phase 20. (a) ``PROD_APP`` (``benchmarks/README.md``: the hybrid
    encoder at 768, MiniLM 384 from ``checkpoints/minilm_ict.npz`` and
    the native hash channel 384, coverage 0.35, chunks 120/24, ``exact``,
    ``top_k`` 5): the app in connect mode in front of an
    ``EngineRpcServer`` in this process on the card, then the app with
    its engine in process and ``RAGTPU_ENGINE_PLATFORM=cpu``; the ten
    quality documents uploaded, then ``python -m
    rag_foundation_tpu_torch.benchmark.runner --config
    benchmarks/quality/benchmarks.yml`` for ``--bench quality`` (120)
    and ``quality_multiturn`` (24 follow-ups, their prior turns as the
    AssistantUI ``messages`` array). It fails unless every stream keeps
    the SSE contract, ``flash_attention``'s counter (zeroed just before,
    read just after) moved on the ingest and on the questions, the card's
    answers and citations equal the CPU's (where they differ, the two
    engines' top-128 for the question as the app searches it must first
    part at a rank whose scores lie within ``HYBRID_TIE``), and the
    kernel on the app's own layer-0 inputs of every (B, S) it launched
    at agrees with the plain version. Printed: EM, F1, contains,
    citation hit, refusal accuracy, upload to DONE seconds, time to first
    delta and answer p50/p99 beside ``summary_hybrid.json`` (a JAX CPU
    run, for reference), each bucket's kernel time beside its bound, the
    plain version and ``scaled_dot_product_attention``. (b) ``GEN_APP``
    (``ENGINE_GENERATOR=generative`` over
    ``checkpoints/decoder_distill.npz``, hash, ``exact``, coverage 0.35,
    chunks 120/24, ``top_k`` 5) with the engine in the app's process:
    the 120 questions through ``benchmark.runner`` on the card, then on
    the CPU as many as ``GEN_CPU_BUDGET_S`` allows. It fails on any
    ``*_engine_error`` outcome of the app's
    ``engine_calls_total{op="generate"}`` (``/metrics``), and where a
    covered answer differs unless the app's pipeline, replayed here on
    both deployments, handed the decoder other evidences through a
    near-tie of the hits (``SCORE_TIE``) or the two greedy decodes part
    at a step whose top-2 margin is at most ``GEN_MARGIN``. Printed: the
    questions the CPU covered, time to first delta and answer p50/p99,
    answer tokens/s, the gate outcomes beside ``ab_summary.json``'s.

``--long-docs`` sets the number of long documents of phase 13;
``--decoder-steps``, ``--decoder-triples`` and ``--decoder-eval`` phase
20's cuts. Two JSON
lines end the output before the last: the host shim's and the app
calls' numbers (phase 18's host re-rank A/B, phase 19's ingest and
encode rates, right-first shares, latencies and qcap drops, phase 23's,
phase 24's and phase 25's app numbers), then the
kernels' JSON (eight entries; the flash-attention forward's also holds
its launches on phase 16's chat path and on phase 25's hybrid app path
with each bucket's check and times, the two list scans their
launches and one shard's numbers on the sharded paths of phases 17-18,
``ivf_list_scan`` its launches on phase 19's app calls, on phase
23's concurrent chats and on phase 24's admin recall probe, with those
paths' dispatches checked and timed, the
forward its times at phase 15's training shapes, the two list
scans their launches in each process of phase 21, the three attention
kernels theirs in one step of phase 22); the last line
is ``{"ok": true, "device": {...}}``.
The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# f32/bf16 scores of unit vectors: summation-order error is at most
# d * 2**-24 * sum|q_i r_i| <= 768 * 6e-8 = 4.6e-5 (bf16 products are exact
# in f32), so kernel and plain version agree within this
F32_TOL = 5e-5
RECALL_MIN = 0.95     # recall@10 of the served store vs the exact scan
# ADC sums with a bf16 LUT: m = 192 entries of magnitude <= 1 summed in
# f32 in another order than the plain version: error <= m * 2**-24 * m
BF16_LUT_TOL = 3e-3
# flash attention: both outputs are convex combinations of v. The plain
# version computes in f32 and rounds its output to the input dtype once;
# the bf16 kernel also rounds each softmax weight to bf16 before P.V
# (2^-9 relative): at most three bf16 roundings of max|v| apart. f32: sums
# in another order, 1e-5 of max|v|
ATTN_TOL = {"bf16": 3 * 2 ** -9, "f32": 1e-5}
EMBED_COS_MIN = 0.999  # stored embeddings vs the plain attention path
LONG_BATCH = 256       # chunks an encode: the ingest pipeline's batch
# the attention backward kernels against their plain versions on the same
# lse and di: each output is a sum of products a.b (p.dO for dV, ds.q for
# dK, ds.k for dQ). The bf16 kernels round each p and ds to bf16 before
# the product and their output to bf16; the plain version rounds only its
# output. A rounding to bf16 (8 significant bits) is off by up to 2^-8 of
# its value. ds = p (dO.v - di) * scale cancels, so its error is relative
# to |a| = p (sum|dO||v| + |di|) * scale, not to |ds|: an element differs
# by at most 2^-8 * sum|a||b| plus the two outputs' roundings, 2^-8 *
# 2 |plain| (an ideal kernel with these roundings alone reaches past one:
# tests/test_torch_flash_attention_bwd.py). f32: exp2 against exp, sums in
# another order, 1e-5 of sum|a||b| + |plain|. (relative, |plain| count)
ATTN_BWD_TOL = {"bf16": (2 ** -8, 2), "f32": (1e-5, 1)}
# FlashAttention's gradients against autograd of the plain forward, which
# keeps o and the weights in f32: in bf16 three roundings of 2^-9 a term
# (P for P.V in the forward, which moves o and so di; P and dS in the
# backward); relative norm error of each gradient. f32: 1e-5
APPLY_TOL = {"bf16": 2 ** -6, "f32": 1e-5}
# the forward kernel's lse against a masked logsumexp: scores from the same
# exact bf16 products summed in another order, exp2/log2 in f32
LSE_TOL = 1e-4
TRAIN_BATCH = 256      # the production recipe's batch
# one training step's gradients, kernel path vs plain attention, each leaf:
# the two paths round bf16 activations at other places (the kernels round
# the attention weights, P and dS, to bf16; the plain path keeps them in
# f32), a relative 2^-9 a rounding through 6 layers and the loss's
# 1/temperature = 20; a kernel fault (a tile, a mask) turns whole gradients
GRAD_COS_MIN = 0.99
# the generative decoder's logits, card bf16 against the port's CPU path in
# f32 on the same checkpoint: the card rounds every activation to bf16 (8
# significant bits, 2^-8 relative) where the f32 path keeps 24; through 6
# layers and the tied head that moves logits of magnitude up to ~17 by a
# few hundredths (the port's own bf16 against f32 on the CPU: at most 0.055
# over 6 fact prompts). A wrong layer, mask or cache slot moves them by
# whole units. The argmax is compared on steps whose f32 top-1/top-2 margin
# exceeds twice this
DECODER_LOGIT_TOL = 2.0 ** -3
CHAT_QUESTIONS = 16    # fact questions of phase 16, each searched + answered
APP_TENANT_DOCS = 256  # fact documents of phase 19's tenant store

_SYL = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "zu", "pe", "shi", "dra",
        "gon", "bel", "tor", "qua", "xen", "fli", "mur", "sol", "yat")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def project_name(i: int) -> str:
    c = (i * 7919 + 13) % 8000
    return "".join(_SYL[(c // 20 ** j) % 20] for j in range(3)).capitalize()


def fact_doc(i: int) -> str:
    return (f"Project {project_name(i)} report. The codename for project "
            f"{project_name(i)} is ZEBRA{i * 7}. Its budget is "
            f"{i * 13 % 997} thousand credits and its lead office is in "
            f"sector {i % 23} of campus {'north' if i % 2 else 'south'}.")


def fact_query(i: int) -> str:
    return f"What is the codename for project {project_name(i)}?"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host CPU (``lscpu``: its model name, family and model number)
    and its core count: host-side numbers (the native shim's hasher and
    re-rank) carry it. A virtualised host may report its name as
    "unknown"; the family and model number still tell the part."""
    import os
    import re
    try:
        text = subprocess.run(["lscpu"], capture_output=True, text=True,
                              timeout=60).stdout
    except OSError:
        text = ""

    def field(name):
        found = re.search(rf"^\s*{name}:\s*(.+)$", text, re.M)
        return found.group(1).strip() if found else "unknown"

    return (f"host {field('Model name')} (family {field('CPU family')}, "
            f"model {field('Model')}), {os.cpu_count()} cores")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # the calls queue behind a spin of the card (100 us a call), so that a
    # short kernel is timed on the card and not its host launch overhead
    torch.cuda._sleep(reps * 200_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_scan(kv, ki, rv, ri, exact, q, lists, what):
    """Kernel (kv, ki) against plain version (rv, ri)."""
    import torch
    both = torch.isfinite(rv)
    if not torch.equal(torch.isfinite(kv), both):
        fail(f"{what}: -inf pattern differs")
    err = float((kv[both] - rv[both]).abs().max()) if both.any() else 0.0
    if exact:
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            bad = int((kv != rv).sum() + (ki != ri).sum())
            fail(f"{what}: kernel != plain version ({bad} elements)")
        return err
    if err > F32_TOL:
        fail(f"{what}: max |kernel - plain| {err} > {F32_TOL}")
    diff = (ki != ri).nonzero()
    if len(diff):
        # allowed only where both rows score within the tolerance
        cap_len = lists.shape[1]
        for l, s, j in diff.tolist():
            a, b = int(ki[l, s, j]), int(ri[l, s, j])
            qa = q[l, s].float()
            sa = float(qa @ lists[a // cap_len, a % cap_len].float())
            sb = float(qa @ lists[b // cap_len, b % cap_len].float())
            if abs(sa - sb) > F32_TOL:
                fail(f"{what}: idx differs beyond a near-tie at "
                     f"{(l, s, j)}: {a} ({sa}) vs {b} ({sb})")
    return err


def phase_small_kernels(ivf_scan, torch):
    """Kernel vs plain version on the card, all three types, small size."""
    g = torch.Generator(device="cuda").manual_seed(1)
    nlist, qcap, cap_len, d, p = 64, 16, 1024, 768, 3
    rows = torch.randn((nlist, cap_len, d), generator=g, device="cuda")
    rows /= rows.norm(dim=-1, keepdim=True)
    qs = torch.randn((nlist, qcap, d), generator=g, device="cuda")
    qs /= qs.norm(dim=-1, keepdim=True)
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    ids = torch.where(torch.rand(ids.shape, generator=g, device="cuda")
                      < 0.25, torch.full_like(ids, -1), ids)
    ids[3, 128:256] = -1      # a sub-block of dead rows
    s = 1.0 / 127.0
    cases = {
        "int8": (torch.clamp(torch.round(qs / s), -127, 127).to(torch.int8),
                 torch.clamp(torch.round(rows / s), -127, 127).to(
                     torch.int8), s * s),
        "f32": (qs.contiguous(), rows.contiguous(), 1.0),
        "bf16": (qs.bfloat16(), rows.bfloat16(), 1.0),
    }
    for kind, (q, lists, scale) in cases.items():
        kv, ki = ivf_scan.ivf_list_scan(q, lists, ids, p=p, scale=scale)
        torch.cuda.synchronize()
        rv, ri = ivf_scan.ivf_list_scan_reference(q, lists, ids, p=p,
                                                  scale=scale)
        err = check_scan(kv, ki, rv, ri, kind == "int8", q, lists,
                         f"ivf_list_scan {kind}")
        log(f"kernel check ivf_list_scan {kind} nlist={nlist} qcap={qcap} "
            f"cap_len={cap_len} d={d} p={p}: "
            + ("bit-identical" if kind == "int8" else
               f"max_abs_err={err:.3g} (tol {F32_TOL})"))


def phase_small_pq_kernels(pq_scan, gather, torch):
    """ADC list scan and gather-and-rescore vs their plain versions on the
    card, small size."""
    g = torch.Generator(device="cuda").manual_seed(2)
    nlist, qcap, cap_len, m, p = 48, 16, 1024, 192, 4
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    ids = torch.where(torch.rand(ids.shape, generator=g, device="cuda")
                      < 0.25, torch.full_like(ids, -1), ids)
    ids[3, 128:256] = -1      # a sub-block of dead rows
    lut8 = torch.randint(-127, 128, (nlist, qcap, 16 * m), generator=g,
                         device="cuda", dtype=torch.int8)
    lutbf = (torch.randn((nlist, qcap, 16 * m), generator=g, device="cuda")
             .clamp(-1, 1).bfloat16())
    disp = torch.full((nlist, qcap), -1, dtype=torch.int32, device="cuda")
    disp[::3, :] = 0          # full lists
    disp[1::3, :5] = 1        # five live slots, then an empty tail
    disp[2, [0, 9]] = 2       # a hole: slots up to 9 are computed
    # the other lists of 2::3 have no query at all
    for lut_name, lut in (("int8", lut8), ("bf16", lutbf)):
        for packed in (False, True):
            c = pq_scan.pack_codes(codes).contiguous() if packed else codes
            err = 0.0
            for dispatch in (None, disp):
                kv, ki = pq_scan.pq_list_scan(lut, c, ids, dispatch, p=p)
                torch.cuda.synchronize()
                rv, ri = pq_scan.pq_list_scan_reference(lut, c, ids,
                                                        dispatch, p=p)
                what = (f"pq_list_scan {lut_name} LUT "
                        f"{'packed' if packed else 'unpacked'} "
                        f"{'with' if dispatch is not None else 'no'} "
                        f"dispatch")
                err = max(err, check_pq_scan(kv, ki, rv, ri,
                                             lut_name == "int8", what))
            log(f"kernel check pq_list_scan {lut_name} LUT "
                f"{'packed' if packed else 'unpacked'} nlist={nlist} "
                f"qcap={qcap} cap_len={cap_len} m={m} p={p}, dead rows, a "
                f"dead sub-block, with and without a dispatch: "
                + ("bit-identical" if lut_name == "int8" else
                   f"max_abs_err={err:.3g} (tol {BF16_LUT_TOL})"))
    for n, d, q_n, c in ((100_003, 768, 64, 64), (1001, 64, 7, 5)):
        table = torch.randint(-127, 128, (n, d), generator=g, device="cuda",
                              dtype=torch.int8)
        rows = torch.randint(0, n, (q_n, c), generator=g, device="cuda",
                             dtype=torch.int32)
        rows[0, :3] = torch.tensor([-1, -5, n - 1], dtype=torch.int32)
        qq = torch.randint(-127, 128, (q_n, d), generator=g, device="cuda",
                           dtype=torch.int8)
        out = gather.gather_rescore_int8(table, rows, qq)
        torch.cuda.synchronize()
        if not torch.equal(out, gather.gather_rescore_int8_reference(
                table, rows, qq)):
            fail(f"gather_rescore_int8 N={n} d={d}: kernel != plain version")
        log(f"kernel check gather_rescore_int8 N={n} (N % 8 = {n % 8}) "
            f"d={d} Q={q_n} C={c}, negative ids: bit-identical")


# live slots of the edge-case lists (qcap 32): none, one, a full n-tile of
# 8, one past it, a full pass of 16, one past it
EDGE_LIVE = (0, 1, 8, 9, 16, 17)
# lists of 29 sub-blocks at nlist 4: the ADC scan gives each list several
# blocks (the walk of a list split between blocks)
SPLIT_LIVE = (0, 8, 9, 17)


def edge_rows(torch, g, cap_len=512, live=EDGE_LIVE):
    """Row ids and a dispatch of one list per ``live`` entry: a sub-block
    of no live row, one of a single live row, one of 128 and the rest
    about 30% dead; list l has its first live[l] slots live."""
    nlist = len(live)
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    lone = torch.arange(nlist, device="cuda")
    one = ids[lone, 128 + 37 + lone].clone()
    ids[:, :256] = -1
    ids[lone, 128 + 37 + lone] = one
    tail = ids[:, 384:]
    tail[torch.rand(tail.shape, generator=g, device="cuda") < 0.3] = -1
    disp = torch.full((nlist, 32), -1, dtype=torch.int32, device="cuda")
    for l, n in enumerate(live):
        disp[l, :n] = l
    return ids, disp


def phase_edge_kernels(ivf_scan, pq_scan, torch):
    """Both list scans against their plain versions on the edge cases
    (``edge_rows``), p from 1 to 8, with and without the dispatch."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ids, disp = edge_rows(torch, g)
    nlist, cap_len = ids.shape
    for kind, d in (("int8", 768), ("int8", 48), ("f32", 768),
                    ("bf16", 768)):
        q = torch.randn((nlist, 32, d), generator=g, device="cuda")
        rows = torch.randn((nlist, cap_len, d), generator=g, device="cuda")
        q /= q.norm(dim=-1, keepdim=True)
        rows /= rows.norm(dim=-1, keepdim=True)
        s = 1.0 / 127.0
        if kind == "int8":
            q = torch.clamp(torch.round(q / s), -127, 127).to(torch.int8)
            rows = torch.clamp(torch.round(rows / s), -127, 127).to(
                torch.int8)
        elif kind == "bf16":
            q, rows = q.bfloat16(), rows.bfloat16()
        scale = s * s if kind == "int8" else 1.0
        err = 0.0
        for p in range(1, 9):
            for dispatch in (disp, None):
                kv, ki = ivf_scan.ivf_list_scan(q, rows, ids, dispatch, p=p,
                                                scale=scale)
                torch.cuda.synchronize()
                rv, ri = ivf_scan.ivf_list_scan_reference(
                    q, rows, ids, dispatch, p=p, scale=scale)
                err = max(err, check_scan(
                    kv, ki, rv, ri, kind == "int8", q, rows,
                    f"ivf_list_scan {kind} d={d} edge p={p}"))
        log(f"kernel check ivf_list_scan {kind} d={d} edge cases (live "
            f"slots {EDGE_LIVE} of qcap 32; sub-blocks of 0, 1, 128 live "
            f"rows; p 1-8): "
            + ("bit-identical" if kind == "int8" else
               f"max_abs_err={err:.3g} (tol {F32_TOL})"))
    m = 192
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    lut8 = torch.randint(-127, 128, (nlist, 32, 16 * m), generator=g,
                         device="cuda", dtype=torch.int8)
    lutbf = (torch.randn((nlist, 32, 16 * m), generator=g, device="cuda")
             .clamp(-1, 1).bfloat16())
    for name, lut, packed in (("int8", lut8, False), ("int8", lut8, True),
                              ("bf16", lutbf, False)):
        c = pq_scan.pack_codes(codes).contiguous() if packed else codes
        err = 0.0
        for p in range(1, 9):
            for dispatch in (disp, None):
                kv, ki = pq_scan.pq_list_scan(lut, c, ids, dispatch, p=p)
                torch.cuda.synchronize()
                rv, ri = pq_scan.pq_list_scan_reference(lut, c, ids,
                                                        dispatch, p=p)
                err = max(err, check_pq_scan(
                    kv, ki, rv, ri, name == "int8",
                    f"pq_list_scan {name} LUT "
                    f"{'packed' if packed else 'unpacked'} edge p={p}"))
        log(f"kernel check pq_list_scan {name} LUT "
            f"{'packed' if packed else 'unpacked'} m={m} edge cases (live "
            f"slots {EDGE_LIVE} of qcap 32; sub-blocks of 0, 1, 128 live "
            f"rows; p 1-8): "
            + ("bit-identical" if name == "int8" else
               f"max_abs_err={err:.3g} (tol {BF16_LUT_TOL})"))
    cap_len = 3712
    ids, disp = edge_rows(torch, g, cap_len, SPLIT_LIVE)
    codes = torch.randint(0, 16, (len(SPLIT_LIVE), cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    lut8 = torch.randint(-127, 128, (len(SPLIT_LIVE), 32, 16 * m),
                         generator=g, device="cuda", dtype=torch.int8)
    for packed in (False, True):
        c = pq_scan.pack_codes(codes).contiguous() if packed else codes
        for p in range(1, 9):
            for dispatch in (disp, None):
                kv, ki = pq_scan.pq_list_scan(lut8, c, ids, dispatch, p=p)
                torch.cuda.synchronize()
                rv, ri = pq_scan.pq_list_scan_reference(lut8, c, ids,
                                                        dispatch, p=p)
                check_pq_scan(kv, ki, rv, ri, True,
                              f"pq_list_scan int8 LUT split lists p={p}")
        log(f"kernel check pq_list_scan int8 LUT "
            f"{'packed' if packed else 'unpacked'} m={m}, lists split "
            f"between blocks (nlist {len(SPLIT_LIVE)}, cap_len {cap_len}, "
            f"live slots {SPLIT_LIVE} of qcap 32; p 1-8): bit-identical")


def prom_samples(text: str) -> dict:
    """``{"name{labels}": value}`` of Prometheus text, parsed by hand (the
    card machine has no prometheus_client)."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def stage_split(torch, fn, marks, names, card, what, reps=5) -> None:
    """One line of a search's device time by stage, from CUDA events
    recorded in one call of ``fn``: ``marks`` are (module, function name,
    "before" | "after") triples of the functions ``fn`` calls, in this
    order, each once; for the call each is wrapped to record an event as
    it is entered or as it returns. The stages are the spans between the
    call's start, the marks and its end (``names``, one more than the
    marks). Of ``reps`` calls after a warm one, the call of the median
    total is shown."""
    events = []

    def record():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    def wrap(f, when):
        def marked(*a, **kw):
            if when == "before":
                record()
            out = f(*a, **kw)
            if when == "after":
                record()
            return out
        return marked

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in marks]
    runs = []
    try:
        for mod, name, when in marks:
            setattr(mod, name, wrap(getattr(mod, name), when))
        for _ in range(reps + 1):
            events.clear()
            record()
            fn()
            record()
            torch.cuda.synchronize()
            if len(events) != len(marks) + 2:
                fail(f"{what}: {len(events) - 2} stage marks, expected "
                     f"{len(marks)}")
            runs.append([a.elapsed_time(b)
                         for a, b in zip(events, events[1:])])
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    parts = sorted(runs[1:], key=sum)[reps // 2]
    total = sum(parts)
    text = "; ".join(f"{name} {t:.3f} ms ({t / total:.1%})"
                     for name, t in zip(names, parts))
    log(f"{what}: {total:.3f} ms on the card = {text} | {card}")


def check_pq_scan(kv, ki, rv, ri, exact, what) -> float:
    """ADC kernel (kv, ki) against plain version (rv, ri)."""
    import torch
    both = torch.isfinite(rv)
    if not torch.equal(torch.isfinite(kv), both):
        fail(f"{what}: -inf pattern differs")
    err = float((kv[both] - rv[both]).abs().max()) if both.any() else 0.0
    if exact:
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            bad = int((kv != rv).sum() + (ki != ri).sum())
            fail(f"{what}: kernel != plain version ({bad} elements)")
        return err
    if err > BF16_LUT_TOL:
        fail(f"{what}: max |kernel - plain| {err} > {BF16_LUT_TOL}")
    off = ki != ri      # allowed only between rows scoring within the tol
    if off.any() and float((kv[off] - rv[off]).abs().max()) > BF16_LUT_TOL:
        fail(f"{what}: idx differs beyond a near-tie")
    return err


def library_ms_of(qdisp, lists, p):
    """Time of ``torch.bmm`` (f32) + ``torch.topk`` for the same scores
    and per-sub-block top-p, every slot computed. The f32 copy of the
    lists is made outside the timed region, in as few list chunks as the
    free memory holds (one when it all fits); chunk times add up.
    Returns (ms, chunks)."""
    import torch
    nlist, qcap, d = qdisp.shape
    cap_len = lists.shape[1]
    free, _ = torch.cuda.mem_get_info()
    per_list = (cap_len * d + qcap * d + 3 * qcap * cap_len) * 4
    step = max(1, min(nlist, int(free * 0.6) // per_list))
    total, chunks = 0.0, 0
    for lo in range(0, nlist, step):
        qf = qdisp[lo:lo + step].float()
        lf = lists[lo:lo + step].float()
        n = qf.shape[0]

        def library():
            sc = torch.bmm(qf, lf.transpose(1, 2))
            return torch.topk(sc.view(n, qcap, cap_len // 128, 128), p,
                              dim=-1)

        total += cuda_ms(library, reps=3, warmup=1)
        chunks += 1
        del qf, lf
    return total, chunks


def run_concurrent(remote, key, queries, threads, k=5, lat=None):
    """Each thread sends its share of ``queries`` one at a time to the
    store ``key`` (or the list of stores ``key``); returns (hits per
    query, wall seconds). Each request's ms is appended to ``lat`` when
    it is a list."""
    keys = key if isinstance(key, list) else [key]
    out = [None] * len(queries)
    errors = []

    def worker(t):
        try:
            for i in range(t, len(queries), threads):
                t0 = time.perf_counter()
                out[i] = remote.search(keys, queries[i], k=k)
                if lat is not None:
                    lat.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        fail(f"concurrent searches failed: {errors[:3]}")
    return out, wall


def recall_at(served, exact, k=10) -> float:
    import numpy as np
    return float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / k
                          for a, b in zip(served, exact)]))


def pq_recall_with_ties(seg, gather, qv, served, exact, k=10) -> float:
    """recall@k where a served chunk counts if it scores at least the
    k-th best exact score. The re-ranked scores are INTEGER int8 dots, so
    near-duplicate documents tie, and which of two tied chunks comes back
    is a matter of position, not of quality. Both id sets are scored here
    the way the refine stage scores them (the query quantized at its own
    absmax, exact int32 dots against the refine table's rows)."""
    import numpy as np
    import torch
    body, table = seg.body, seg.body_chunk_ids
    order = np.argsort(table, kind="stable")

    def rows_of(ids):
        pos = np.clip(np.searchsorted(table[order], ids), 0, len(table) - 1)
        rows = order[pos]
        return np.where((table[rows] == ids) & (ids >= 0), rows, -1)

    scale = np.abs(qv).max(axis=1, keepdims=True) / 127.0
    qq = torch.as_tensor(np.clip(np.round(qv / scale), -127, 127)
                         .astype(np.int8), device=body.refine.device)

    def scores(ids):
        rows = rows_of(ids)
        sc = gather.gather_rescore_int8_reference(
            body.refine, torch.as_tensor(rows.astype(np.int32),
                                         device=body.refine.device), qq)
        return np.where(rows >= 0, sc.cpu().numpy(), -np.inf)

    s_served, s_exact = scores(np.asarray(served)), scores(np.asarray(exact))
    if not np.isfinite(s_exact).all():
        # an exact neighbour outside the body (the tail): ids decide
        return recall_at(served, exact, k)
    return float(np.mean((s_served >= s_exact.min(axis=1, keepdims=True))
                         .sum(axis=1) / k))


def card_mesh(torch, make_mesh, n: int = 4):
    """``n`` logical shards on the one card (a mesh may repeat a device)."""
    card = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(n, devices=[card] * n)


def shards_share_storage(torch, shards, field, base) -> bool:
    """Every shard's ``field`` is a view of ``base``'s storage."""
    ptr = base.untyped_storage().data_ptr()
    return all(getattr(s, field).untyped_storage().data_ptr() == ptr
               for s in shards)


def shard_kernel_line(torch, kernel, reference, args, kw, bound, what,
                      card) -> dict:
    """One shard's list-scan kernel against its plain version on that
    shard's own dispatch (exact for int8), with its time, the plain
    version's (one run) and its bound."""
    kv, ki = kernel(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rv, ri = reference(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_scan(kv, ki, rv, ri, True, None, None, what)
    del kv, ki, rv, ri
    ms = cuda_ms(lambda: kernel(*args, **kw), reps=10)
    bound_ms, bound_by, c = bound
    log(f"{what}: {c['lists_read']} lists with queries, {c['live_slots']} "
        f"live slots, {c['rows_needed']} live rows of "
        f"{c['rows_in_lists_read']}: bit-identical; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (one run), bound {bound_ms:.3f} ms "
        f"({bound_by}) | {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": c}


def app_calls_phase(args, card, ctx, mods) -> dict:
    """Phase 19: the engine calls the JAX app's ``EngineRag`` makes for a
    tenant's chats, replayed through ``RemoteEngine`` against an
    ``Engine`` restarted on phase 3's data_dir that serves phase 3's 10M
    int8 body (adopted: its pads are not persisted) at phase 3's
    settings: ``create_store`` of an app-shaped key, ``ingest_document``
    and ``store_stats``, searches over [the 10M store, the tenant's
    store] at the app's k=12 and k=128 (one at a time, then from 64
    concurrent clients, which the batcher coalesces into batches that
    reach ``ivf_list_scan``), a ``doc_filter`` and a ``meta_filter``
    search, ``has_store``, ``delete_document`` and ``delete_store``. The
    hash encoder must run on the native shim; its ingest rate (and the
    store's save inside it) is printed beside the Python path's on the
    same documents. Returns (the ``ivf_list_scan`` entry's keys for this
    path, this phase's host and search numbers)."""
    import numpy as np
    from rag_foundation_tpu_torch import native
    from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder
    (Engine, EngineConfig, EngineRpcServer, RemoteEngine, tivf,
     ivf_scan) = mods
    (cfg, key, sock, body, body_cids, sampled, rng) = ctx
    t_phase = time.perf_counter()
    engine = Engine(EngineConfig(**cfg))
    # the store's save, which each ingest_document makes, timed apart
    save_s = [0.0]
    save_store = engine._save_store

    def timed_save(st):
        t0 = time.perf_counter()
        save_store(st)
        save_s[0] += time.perf_counter() - t0
    engine._save_store = timed_save
    if engine.encoder._lib is None or not native.loaded():
        fail("phase 19: the engine's hash encoder did not load the native "
             "shim")
    store = engine._store(key)
    store.segment.adopt_body(body, body_cids)
    # the pads are not persisted: do not rewrite body.npz for them, and
    # over-fetch past them as the padding engine did
    store.saved_body_version = store.segment.body_version
    engine._pad_counts[key] = args.rows - args.docs
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    tenant_docs = range(args.docs + 1000, args.docs + 1000 + APP_TENANT_DOCS)
    try:
        # EngineRag.create_store: stores/{user}-{slug}-{hex8}, made once
        tenant = f"stores/7-fact-sheets-{int(rng.integers(1 << 32)):08x}"
        python_store = f"stores/7-python-path-{int(rng.integers(1 << 32)):08x}"
        remote.create_store(tenant)
        save_s[0] = 0.0
        t0 = time.perf_counter()
        for i in tenant_docs:
            remote.ingest_document(tenant, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        native_s = time.perf_counter() - t0
        native_save_s = save_s[0]
        stats = remote.store_stats(tenant)
        if stats["documents"] != APP_TENANT_DOCS:
            fail(f"phase 19: tenant store_stats {stats}")
        # the same documents through the Python hasher, in another store
        engine.encoder = HashingEncoder(dim=cfg["dim"], use_native=False)
        remote.create_store(python_store)
        save_s[0] = 0.0
        t0 = time.perf_counter()
        for i in tenant_docs:
            remote.ingest_document(python_store, f"doc-{i}",
                                   f"project-{i}.txt", fact_doc(i))
        python_s = time.perf_counter() - t0
        python_save_s = save_s[0]
        engine.encoder = HashingEncoder(dim=cfg["dim"])
        nv = engine._store(tenant).segment.live_rows()[0]
        pv = engine._store(python_store).segment.live_rows()[0]
        if not np.allclose(nv, pv, rtol=1e-6, atol=0):
            fail("phase 19: the native and Python hashers disagree")
        remote.delete_store(python_store)
        texts = [m.text for m in engine._store(tenant).chunks.values()]
        enc_rates = {}
        for name, enc in (("native", engine.encoder),
                          ("python", HashingEncoder(dim=cfg["dim"],
                                                    use_native=False))):
            t0 = time.perf_counter()
            for _ in range(5):
                enc.encode(texts)
            enc_rates[name] = 5 * len(texts) / (time.perf_counter() - t0)
        n_chunks = stats["chunks"]
        log(f"app calls: create_store {tenant}, {APP_TENANT_DOCS} fact "
            f"documents ({n_chunks} chunks) over RPC: native hasher "
            f"{n_chunks / native_s:,.1f} chunks/s, Python hasher "
            f"{n_chunks / python_s:,.1f} chunks/s (ingest, save included; "
            f"the store's save took {native_save_s:.3f} s of "
            f"{native_s:.3f} s native, {python_save_s:.3f} s of "
            f"{python_s:.3f} s Python); encode alone "
            f"{enc_rates['native']:,.0f} vs "
            f"{enc_rates['python']:,.0f} chunks/s; native shim loaded "
            f"{native.loaded()} | {host_line()} | {card}")

        stores = [key, tenant]
        asked = [(i, key) for i in sampled] + [(i, tenant) for i in
                                               list(tenant_docs)[:64]]
        lat, right = [], 0
        for k in (12, 128):
            for i, where in asked:
                t0 = time.perf_counter()
                hits = remote.search(stores, fact_query(i), k=k)
                lat.append((time.perf_counter() - t0) * 1e3)
                right += bool(hits) and hits[0].doc_id == f"doc-{i}" \
                    and hits[0].store_key == where
        first = right / (2 * len(asked))
        log(f"app calls, one search at a time over [10M store, tenant], "
            f"k=12 and k=128: right document first "
            f"{first:.4f} of {2 * len(asked)}; p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms (each waits out the "
            f"{cfg['batch_window_s'] * 1e3:.0f} ms window) | {card}")
        if first < RECALL_MIN:
            fail(f"phase 19: right document first {first} < {RECALL_MIN}")

        # like the JAX engine, a batch drops the probes past a list's
        # default qcap, and the fact questions share most of their words,
        # so they crowd the same lists: the probes build_dispatch drops
        # are counted (on the device until the searches end) and printed
        # beside the right-first share. A batch is filled to a power of
        # two with zero rows (all-zero coarse scores), whose probes come
        # last in each list and are not counted
        threads = 64
        conc = {}
        drops = []
        build_dispatch = tivf.build_dispatch

        def counted_dispatch(coarse, nprobe, qcap, *a, **kw):
            out = build_dispatch(coarse, nprobe, qcap, *a, **kw)
            real = coarse.ne(0).any(dim=1, keepdim=True)
            lost = (out[2] < 0) & real
            drops.append((real.sum() * nprobe, lost.sum(), lost.any(dim=1)
                          .sum()))
            return out

        tivf.build_dispatch = counted_dispatch
        ivf_scan.LAUNCHES.reset()                 # counts: this path only
        try:
            for k in (12, 128):
                pick = rng.integers(0, len(asked), size=threads * 16)
                qs = [asked[j] for j in pick]
                clat = []
                drops.clear()
                hits, wall = run_concurrent(remote, stores,
                                            [fact_query(i) for i, _ in qs],
                                            threads, k=k, lat=clat)
                ok = sum(1 for (i, _), h in zip(qs, hits)
                         if h and h[0].doc_id == f"doc-{i}")
                conc[k] = {
                    "qps": len(qs) / wall,
                    "p50_ms": float(np.percentile(clat, 50)),
                    "p99_ms": float(np.percentile(clat, 99)),
                    "right_first": ok / len(qs),
                    "batches": len(drops),
                    "probes": sum(int(n) for n, _, _ in drops),
                    "probes_dropped": sum(int(d) for _, d, _ in drops),
                    "queries_with_a_probe_dropped": sum(
                        int(q) for _, _, q in drops)}
        finally:
            tivf.build_dispatch = build_dispatch
        launches = ivf_scan.LAUNCHES.count           # read just after
        for k, c in conc.items():
            log(f"app calls, {threads} concurrent clients over [10M store, "
                f"tenant], k={k}: {c['qps']:,.1f} QPS, p50 "
                f"{c['p50_ms']:.3f} ms p99 {c['p99_ms']:.3f} ms over RPC; "
                f"right document first {c['right_first']:.4f} (batched, "
                f"the list-scan path); {c['batches']} batches through "
                f"build_dispatch, probes of the questions dropped by qcap "
                f"{c['probes_dropped']} of {c['probes']} (in "
                f"{c['queries_with_a_probe_dropped']} of "
                f"{c['probes'] // cfg['nprobe']} questions) "
                f"| {card}")
        log(f"app calls: ivf_list_scan launches in the concurrent searches "
            f"{launches} | {card}")
        if launches == 0:
            fail("phase 19: the concurrent searches never launched "
                 "ivf_list_scan")

        # filtered searches run alone (Q=1, no kernel): only the allowed
        # documents come back, the asked one first
        i_big, i_ten = sampled[0], tenant_docs[3]
        allowed = {f"doc-{i_big}", f"doc-{sampled[1]}"}
        hits = remote.search(stores, fact_query(i_big), k=12,
                             doc_filter=allowed)
        if not hits or hits[0].doc_id != f"doc-{i_big}" \
                or {h.doc_id for h in hits} - allowed:
            fail(f"phase 19: doc_filter search returned "
                 f"{[h.doc_id for h in hits]}")
        names = [f"project-{i_ten}.txt", f"project-{i_big}.txt"]
        hits = remote.search(stores, fact_query(i_ten), k=12,
                             meta_filter={"doc_name": names})
        if not hits or (hits[0].doc_id, hits[0].store_key) != (
                f"doc-{i_ten}", tenant) or {h.doc_name for h in hits} \
                - set(names):
            fail(f"phase 19: meta_filter search returned "
                 f"{[(h.doc_id, h.store_key) for h in hits]}")
        if not remote.has_store(tenant):
            fail("phase 19: has_store lost the tenant's store")
        remote.delete_document(tenant, f"doc-{i_ten}")
        hits = remote.search(stores, fact_query(i_ten), k=12)
        if any(h.doc_id == f"doc-{i_ten}" for h in hits):
            fail("phase 19: a deleted document was found")
        remote.delete_store(tenant)
        if remote.has_store(tenant):
            fail("phase 19: delete_store left the tenant's store")
    finally:
        remote.close()
        server.shutdown()
    log(f"app calls: doc_filter and meta_filter searches, has_store, "
        f"delete_document (gone from the next search) and delete_store "
        f"checked; phase 19: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_app_calls": launches}, {
        "right_first_one_at_a_time": first,
        "search_one_at_a_time_p50_ms": float(np.percentile(lat, 50)),
        "search_one_at_a_time_p99_ms": float(np.percentile(lat, 99)),
        "concurrent": {f"k{k}": c for k, c in conc.items()},
        "ingest_chunks_s": {"native": n_chunks / native_s,
                            "python": n_chunks / python_s},
        "ingest_save_s": {"native": native_save_s, "python": python_save_s},
        "encode_chunks_s": enc_rates}


def mesh_flat_phase(args, card, ctx, mods) -> dict:
    """Phase 17: the sharded engine at 10M x 768 through the entry points:
    an ``Engine`` with ``mesh_shards=4`` on four logical shards of the
    one card, on phase 3's data_dir, serving phase 3's 10M int8 body
    (adopted as four views: its pads are not persisted) behind
    ``EngineRpcServer``. Returns the ``ivf_list_scan`` entry's sharded
    keys."""
    import numpy as np
    import torch
    (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
     make_mesh, sivf, tivf, ivf_scan, roofline) = mods
    (cfg, key, sock, body, body_cids, qv1, exact, probe_rows, probe_ids,
     sampled, rng) = ctx
    t_phase = time.perf_counter()
    mesh = card_mesh(torch, make_mesh)
    engine = Engine(EngineConfig(**cfg, mesh_shards=4), mesh=mesh)
    store = engine._store(key)
    seg = store.segment
    small = seg.body
    if not isinstance(small, sivf.ShardedBody) or len(small.shards) != 4:
        fail(f"mesh restart: the saved body came back as "
             f"{type(small).__name__}")
    if not shards_share_storage(torch, small.shards, "lists",
                                small.shards[0].lists):
        fail("mesh restart: the shards are not views of one body")
    log(f"mesh engine on phase 3's data_dir: the saved int8 body ({small.n} "
        f"rows, nlist {small.nlist}) reloaded as 4 shards of "
        f"{small.nlist_local} lists, views of one tensor; tail "
        f"{type(seg.tail).__name__} of {seg.tail.count} rows")
    mem0 = torch.cuda.memory_allocated()
    seg.adopt_body(body, body_cids)
    sbody = seg.body
    grown = torch.cuda.memory_allocated() - mem0
    if not (shards_share_storage(torch, sbody.shards, "lists", body.lists)
            and shards_share_storage(torch, sbody.shards, "row_ids",
                                     body.row_ids)):
        fail("mesh: the adopted 10M body was copied, not viewed")
    # the pads are not persisted: do not rewrite body.npz for them, and
    # over-fetch past them as the padding engine did
    store.saved_body_version = seg.body_version
    engine._pad_counts[key] = args.rows - args.docs
    log(f"mesh: phase 3's 10M body adopted as 4 shards of "
        f"{sbody.nlist_local} lists (views; device memory +"
        f"{grown / 2**20:.1f} MiB) | {card}")

    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    ivf_scan.LAUNCHES.reset()                 # counts: this path only
    search_profile.reset()
    try:
        lat = []
        for i in sampled:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"mesh: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        log(f"mesh single search over RPC: p50 {np.percentile(lat, 50):.3f}"
            f" ms p99 {np.percentile(lat, 99):.3f} ms ({len(lat)} searches, "
            f"right top hit each) | {card}")
        lat1, served = [], []
        for i in range(len(sampled)):
            t0 = time.perf_counter()
            served.append(seg.search(qv1[i:i + 1], 10)[1][0])
            lat1.append((time.perf_counter() - t0) * 1e3)
        fact_recall = recall_at(served, exact)
        log(f"mesh StoreIndex.search Q=1 in process: p50 "
            f"{np.percentile(lat1, 50):.3f} ms p99 "
            f"{np.percentile(lat1, 99):.3f} ms; recall@10 of fact questions "
            f"vs phase 3's exact scan {fact_recall:.4f} ({len(sampled)} "
            f"questions) | {card}")
        if fact_recall < RECALL_MIN:
            fail(f"mesh fact-question recall@10 {fact_recall} < "
                 f"{RECALL_MIN}")

        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 24)]
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        right = sum(1 for i, h in zip(qids, hits)
                    if h and h[0].doc_id == f"doc-{i}")
        log(f"mesh concurrent search over RPC: {threads} threads, "
            f"{len(qids)} queries in {wall:.3f} s = {len(qids) / wall:,.1f} "
            f"QPS; right top hit {right}/{len(qids)} | {card}")
        bq = [fact_query(int(i)) for i in rng.integers(0, args.docs, 1024)]
        t0 = time.perf_counter()
        scores, _ = remote.search_batch(key, bq, k=10)
        bwall = time.perf_counter() - t0
        if scores.shape != (1024, 10):
            fail(f"mesh search_batch returned {scores.shape}")
        seg.search(probe_rows, 10)
        t0 = time.perf_counter()
        for _ in range(5):
            seg.search(probe_rows, 10)
        swall = (time.perf_counter() - t0) / 5
        log(f"mesh search_batch Q=1024 over RPC (encode included): "
            f"{bwall * 1e3:.1f} ms; StoreIndex.search Q=1024 stored rows in "
            f"process (host clock, f32 transport, tail merge): "
            f"{swall * 1e3:.2f} ms = {1024 / swall:,.0f} QPS | {card}")
        probe = remote.recall_probe(key, k=10, sample=64)
        if probe["recall"] is None:
            fail(f"mesh recall_probe {probe}")
        dispatches = search_profile.snapshot().get("body_dispatch",
                                                   {"n": 0})["n"]
        launches = ivf_scan.LAUNCHES.count           # read just after
        log(f"mesh recall_probe@10 (sampled through the shards, exact scan "
            f"a shard) {probe['recall']:.4f}; ivf_list_scan launches "
            f"{launches} for {dispatches} body searches | {card}")
        if dispatches == 0 or launches != 4 * dispatches:
            fail(f"mesh: {launches} ivf_list_scan launches for "
                 f"{dispatches} body searches (4 each expected)")

        # the sharded search of Q=1024 stored rows against the one-device
        # search of the same body at the same global nprobe
        q = torch.as_tensor(probe_rows, device="cuda")
        qcap = tivf.default_qcap(1024, 8, sbody.nlist_local)
        routed = sivf.route_shards(sbody, q, 8, qcap, mesh)
        drops = [int(r[3]) for r in routed]
        _, one_rows, one_drop = tivf.ivf_search(body, q, 16, nprobe=32, p=3)
        _, sh_rows = sivf.sharded_ivf_search(sbody, q, 16, mesh=mesh,
                                             nprobe_local=8, p=3)
        one_rows = one_rows[:, :10].cpu().numpy()
        sh_rows = sh_rows[:, :10].cpu().numpy()
        overlap = recall_at(sh_rows, one_rows)
        # each query is a stored row: it must come back first
        self_first = [float(np.mean(body_cids[r[:, 0]] == probe_ids))
                      for r in (sh_rows, one_rows)]
        log(f"mesh vs one device, Q=1024 stored rows, ivf_search nprobe 32 "
            f"vs 4 x nprobe_local 8: overlap@10 {overlap:.4f}; the query's "
            f"own row first {self_first[0]:.4f} sharded, {self_first[1]:.4f}"
            f" one device; probes dropped by qcap {qcap}: a shard {drops} "
            f"(sum {sum(drops)} of {1024 * 32}), one device "
            f"{int(one_drop)} | {card}")
        if min(self_first) < RECALL_MIN:
            fail(f"mesh: a stored row came back first for {self_first} of "
                 f"the queries (< {RECALL_MIN})")
        stage_split(
            torch, lambda: sivf.sharded_ivf_search(sbody, q, 16, mesh=mesh,
                                                   nprobe_local=8, p=3),
            [(sivf, "route_shards", "after"), (sivf, "scan_shards", "after"),
             (sivf, "select_shards", "after")],
            ["per-shard routing", "list scans (4 launches)",
             "per-shard regather + top-k", "merge"], card,
            "mesh ivf_flat_int8 search of Q=1024 stored rows "
            "(sharded_ivf_search, 4 shards on one card, split by CUDA "
            "events between its stages in one call)")
        scans_ms = cuda_ms(lambda: sivf.scan_shards(sbody, routed, 3, mesh),
                           reps=10)
        probe_lists, dispatch, _, _, qdisp, scale = routed[0]
        shard0 = sbody.shards[0]
        entry = shard_kernel_line(
            torch, ivf_scan.ivf_list_scan, ivf_scan.ivf_list_scan_reference,
            (qdisp, shard0.lists, shard0.row_ids, dispatch),
            dict(p=3, scale=scale),
            roofline.scan_bound(shard0.row_ids, ivf_scan.live_slots(dispatch),
                                qcap, 3, 1, 768, "int8"),
            f"ivf_list_scan int8, shard 0 of 4 ({shard0.nlist} lists, "
            f"qcap {qcap}), Q=1024 stored rows; the 4 shards' launches "
            f"together {scans_ms:.3f} ms", card)
        entry["library_ms"], lib_chunks = library_ms_of(qdisp, shard0.lists,
                                                        3)
        log(f"shard 0's library yardstick: torch.bmm+topk (f32, every slot, "
            f"{lib_chunks} list chunks) {entry['library_ms']:.3f} ms | "
            f"{card}")
        del routed, probe_lists, dispatch, qdisp

        # a few fact documents into the sharded tail over RPC
        new_docs = range(args.docs, args.docs + 8)
        for i in new_docs:
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        tail_n = seg.tail.count
        for i in new_docs:
            hits = remote.search([key], fact_query(i), k=3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"mesh tail: top hit for new project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        # a flush through sharded_ivf_append: rows that fit their lists
        # (a capacity overflow would re-route them through a 10M rebuild)
        n_app = 1024 + 64
        g = np.random.default_rng(args.seed + 17)
        rows = g.standard_normal((n_app, 768)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        cents = torch.cat([s.centroids for s in sbody.shards])
        flushed = np.concatenate([seg.tail.state()["vectors"], rows])
        assign = tivf.assign_clusters(torch.as_tensor(flushed,
                                                      device="cuda"),
                                      cents)[0].cpu().numpy()
        free = sbody.cap_len - (body.row_ids >= 0).sum(dim=1).cpu().numpy()
        if (np.bincount(assign, minlength=sbody.nlist) > free).any():
            fail("mesh append: a list has no room for its new rows")
        row_base = len(seg.body_chunk_ids)
        version = seg.body_version
        ids = np.arange(1 << 30, (1 << 30) + n_app, dtype=np.int64)
        t0 = time.perf_counter()
        seg.add(rows, ids)
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
        landed = int((body.row_ids >= row_base).sum())
        got = seg.search(rows[:64], 1)[1][:, 0]
        log(f"mesh append: {tail_n} tail rows (8 new fact documents, found "
            f"first over RPC) + {n_app} rows flushed through "
            f"sharded_ivf_append in {flush_s:.3f} s (body version "
            f"{version} -> {seg.body_version}, tail {seg.tail.count}); "
            f"{landed} rows landed in phase 3's own body tensors; an "
            f"appended row found first for {np.mean(got == ids[:64]):.4f} "
            f"of 64 | {card}")
        if seg.body_version == version or landed != tail_n + n_app \
                or np.mean(got == ids[:64]) < RECALL_MIN:
            fail("mesh append: the flushed rows were not found in place")
        for i in new_docs:
            hits = remote.search([key], fact_query(i), k=3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"mesh append: new project {i} lost in the flush")
    finally:
        remote.close()
        server.shutdown()
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_sharded": launches, "sharded_shard": entry,
            "sharded_overlap_at_10": overlap,
            "sharded_fact_recall_at_10": fact_recall}


def host_rerank_ab(arch, q, rows, card) -> dict:
    """The ``ivf_pq`` host tier's re-rank on one search's own candidates
    (``q [Q, d]`` f32, ``rows [Q, C]``): the native shim against the
    numpy path, outputs compared within ``F32_TOL`` (the same dots of
    unit vectors summed in another order), then numpy/native/native/numpy
    five times: ten pairs, times on the host clock."""
    import numpy as np
    from rag_foundation_tpu_torch import native
    lib = native.load_hasher()
    if lib is None:
        fail("the native shim did not load: no g++ on this machine")
    nat = arch._rescore_native(lib, q, rows)
    ref = arch._rescore_numpy(q, rows)
    live = rows >= 0
    if not (np.array_equal(np.isneginf(nat), ~live)
            and np.array_equal(np.isneginf(ref), ~live)):
        fail("host re-rank: pads and scores disagree between the paths")
    err = float(np.abs(nat[live] - ref[live]).max()) if live.any() else 0.0
    if err > F32_TOL:
        fail(f"host re-rank: native vs numpy {err} > {F32_TOL}")

    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def run_native():
        arch._rescore_native(lib, q, rows)

    def run_numpy():
        arch._rescore_numpy(q, rows)

    won, t_nat, t_np = 0, [], []
    for _ in range(5):
        t = [ms(run_numpy), ms(run_native), ms(run_native), ms(run_numpy)]
        won += (t[1] < t[0]) + (t[2] < t[3])
        t_np += [t[0], t[3]]
        t_nat += [t[1], t[2]]
    log(f"host re-rank A/B, one Q=1024 search's candidates (Q={rows.shape[0]}"
        f", C={rows.shape[1]}, d={arch.dim}, {int(live.sum())} live, archive"
        f" of {arch.n} int8 rows): max |native - numpy| {err:.3g} (tolerance"
        f" {F32_TOL}); native median {np.median(t_nat):.2f} ms (min "
        f"{min(t_nat):.2f}, max {max(t_nat):.2f}), numpy median "
        f"{np.median(t_np):.2f} ms (min {min(t_np):.2f}, max {max(t_np):.2f})"
        f"; native faster in {won} of 10 pairs | {host_line()} | {card}")
    return {"q": int(rows.shape[0]), "c": int(rows.shape[1]),
            "max_abs_err": err, "native_ms": float(np.median(t_nat)),
            "numpy_ms": float(np.median(t_np)), "native_won": won}


def mesh_pq_phase(args, card, ctx, mods) -> dict:
    """Phase 18: the sharded ``ivf_pq`` engine at 10M x 768 through the
    entry points: an ``Engine`` with ``mesh_shards=4`` and
    ``pq_refine="host"`` on four logical shards of the one card, restarted
    on phase 6's data_dir, adopting phase 6's 10M body without its refine
    table (as four views) and its host archive, behind
    ``EngineRpcServer``. Returns the ``pq_list_scan`` entry's sharded
    keys."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    from rag_foundation_tpu_torch.engine.ivf import default_qcap
    from rag_foundation_tpu_torch.parallel import sharded_ivf as sivf
    from rag_foundation_tpu_torch.parallel.mesh import make_mesh
    from rag_foundation_tpu_torch.utils import roofline
    (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
     tpq, pq_scan, gather) = mods
    (cfg, key, sock, body, cids, arch, n_pad, qv1, exact, probe_rows,
     probe_ids, sampled, rng, p) = ctx
    t_phase = time.perf_counter()
    mesh = card_mesh(torch, make_mesh)
    engine = Engine(EngineConfig(**{**cfg, "pq_refine": "host"},
                                 mesh_shards=4), mesh=mesh)
    store = engine._store(key)
    seg = store.segment
    saved = seg.body
    # the saved body keeps its device refine table, which does not split
    # by lists: the mesh store serves it whole until it is replaced
    log(f"mesh ivf_pq engine on phase 6's data_dir: the saved body "
        f"({type(saved).__name__}, {saved.n} rows, refine "
        f"{tuple(saved.refine.shape)}) restored whole")
    free = body._replace(refine=body.refine[:0, :0])
    mem0 = torch.cuda.memory_allocated()
    seg.adopt_body(free, cids)
    with seg._body_lock:
        seg._pq_archive = arch         # archive row i is body row i
    sbody = seg.body
    grown = torch.cuda.memory_allocated() - mem0
    if not isinstance(sbody, sivf.ShardedBody) or not (
            shards_share_storage(torch, sbody.shards, "codes", body.codes)
            and shards_share_storage(torch, sbody.shards, "row_ids",
                                     body.row_ids)):
        fail("mesh ivf_pq: the adopted 10M body is not four views of it")
    # the pads are not persisted: do not rewrite body.npz for them, and
    # over-fetch past them as the padding engine did
    store.saved_body_version = seg.body_version
    engine._pad_counts[key] = n_pad
    log(f"mesh ivf_pq: phase 6's 10M body without its refine table adopted "
        f"as 4 shards of {sbody.nlist_local} lists (views; device memory "
        f"+{grown / 2**20:.1f} MiB), re-ranked against the host archive of "
        f"{arch.n} rows | {card}")

    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    pq_scan.LAUNCHES.reset()                  # counts: this path only
    gather.LAUNCHES.reset()
    search_profile.reset()
    try:
        lat = []
        for i in sampled:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"mesh ivf_pq: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        log(f"mesh ivf_pq single search over RPC: p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms ({len(lat)} searches, right "
            f"top hit each) | {card}")
        # the fact questions as Engine.search asks the index of a padded
        # store (40 rows: the ADC top 256 re-ranked on the host)
        served = np.stack([seg.search(qv1[i:i + 1], 40)[1][0, :10]
                           for i in range(len(qv1))])
        ns = SimpleNamespace(body=body, body_chunk_ids=cids)
        recall_ties = pq_recall_with_ties(ns, gather, qv1, served, exact)
        bq = [fact_query(int(i)) for i in rng.integers(0, args.docs, 1024)]
        t0 = time.perf_counter()
        scores, _ = remote.search_batch(key, bq, k=10)
        bwall = time.perf_counter() - t0
        if scores.shape != (1024, 10):
            fail(f"mesh ivf_pq search_batch returned {scores.shape}")
        # the fact documents share a few lists, so a batch of fact
        # questions overflows their qcap and drops probes, as on one
        # device (phase 6 prints the same count)
        finite = int(np.isfinite(scores[:, 0]).sum())
        # the host re-rank's own inputs of one Q=1024 search
        taken = []

        def take(q, r):
            taken.append((np.array(q, np.float32), np.array(r)))
            return type(arch).rescore(arch, q, r)

        arch.rescore = take
        seg.search(probe_rows, 10)
        del arch.rescore
        t0 = time.perf_counter()
        for _ in range(3):
            top = seg.search(probe_rows, 10)[1]
        swall = (time.perf_counter() - t0) / 3
        # the same searches with the numpy re-rank, in this call
        arch.rescore = lambda q, r: arch._rescore_numpy(
            np.ascontiguousarray(q, np.float32), np.asarray(r))
        seg.search(probe_rows, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            np_top = seg.search(probe_rows, 10)[1]
        swall_np = (time.perf_counter() - t0) / 3
        del arch.rescore
        dispatches = search_profile.snapshot().get("body_dispatch",
                                                   {"n": 0})["n"]
        launches = pq_scan.LAUNCHES.count          # read just after
        rescores = gather.LAUNCHES.count
    finally:
        remote.close()
        server.shutdown()
    log(f"mesh ivf_pq (4 x nprobe_local 8, p={p}): recall@10 of the fact "
        f"questions vs phase 6's exact scan {recall_ties:.4f} counting a "
        f"chunk that ties the 10th exact score, "
        f"{recall_at(served, exact):.4f} by ids alone; search_batch Q=1024 "
        f"over RPC (encode included) {bwall * 1e3:.1f} ms, top score finite "
        f"for {finite}/1024; StoreIndex.search"
        f" Q=1024 stored rows in process (host clock, bf16 transport, host "
        f"re-rank) {swall * 1e3:.2f} ms = {1024 / swall:,.0f} QPS with the "
        f"native re-rank, {swall_np * 1e3:.2f} ms with the numpy re-rank, "
        f"the same top hit for "
        f"{np.mean(np_top[:, 0] == top[:, 0]):.4f}, a stored "
        f"row first {np.mean(top[:, 0] == probe_ids):.4f} (printed); "
        f"pq_list_scan launches {launches} for {dispatches} body searches, "
        f"gather_rescore_int8 {rescores} | {card}")
    if recall_ties < RECALL_MIN:
        fail(f"mesh ivf_pq fact recall@10 {recall_ties} < {RECALL_MIN}")
    rerank = host_rerank_ab(arch, *taken[0], card)
    if dispatches == 0 or launches != 4 * dispatches or rescores:
        fail(f"mesh ivf_pq: {launches} pq_list_scan launches for "
             f"{dispatches} body searches (4 each expected), {rescores} "
             f"device re-ranks (none expected)")

    # the ADC candidates against one device at the same global nprobe
    def adc_overlap(q):
        _, s10 = sivf.sharded_ivfpq_search(sbody, q, 10, mesh=mesh,
                                           nprobe_local=8, p=p)
        _, o10, dropped = tpq.ivfpq_search(free, q, 10, nprobe=32, p=p)
        return recall_at(s10.cpu().numpy(), o10.cpu().numpy()), dropped

    adc_fact = float(np.mean([adc_overlap(torch.as_tensor(
        qv1[i:i + 1], device="cuda").to(torch.bfloat16))[0]
        for i in range(len(qv1))]))
    qb = torch.as_tensor(probe_rows, device="cuda").to(torch.bfloat16)
    adc_rows, one_drop = adc_overlap(qb)
    log(f"mesh ivf_pq ADC top-10 overlap with one device at nprobe 32: "
        f"fact questions {adc_fact:.4f}, Q=1024 stored rows "
        f"{adc_rows:.4f} | {card}")
    if adc_fact < 0.9:
        fail(f"mesh ivf_pq ADC overlap {adc_fact} < 0.9")

    # one shard's kernel on its own dispatch of the Q=1024 batch
    shard0 = sbody.shards[0]
    q32, _, _, dispatch, _, dropped = tpq.route(
        shard0, qb, 8, default_qcap(1024, 8, shard0.nlist))
    lut_disp, _ = tpq.scan_inputs(shard0, q32, dispatch, torch.int8)
    qcap = dispatch.shape[1]
    entry = shard_kernel_line(
        torch, pq_scan.pq_list_scan, pq_scan.pq_list_scan_reference,
        (lut_disp, shard0.codes, shard0.row_ids, dispatch), dict(p=p),
        roofline.pq_scan_bound(shard0.row_ids, pq_scan.live_slots(dispatch),
                               qcap, p, shard0.m, shard0.codes.shape[2], 1),
        f"pq_list_scan int8 LUT, shard 0 of 4 ({shard0.nlist} lists, qcap "
        f"{qcap}, dropped {int(dropped)}; one device dropped "
        f"{int(one_drop)}), Q=1024 stored rows", card)
    del engine, store, seg, sbody, shard0, lut_disp, dispatch
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_sharded": launches, "sharded_shard": entry,
            "sharded_fact_recall_at_10": recall_ties,
            "sharded_adc_overlap_at_10": adc_fact,
            "host_rerank": {**rerank, "search_ms_native": swall * 1e3,
                            "search_ms_numpy": swall_np * 1e3}}


def check_topk(kv, ki, rv, ri, q, c, tol, what) -> tuple[float, int]:
    """Kernel top-k (kv, ki) against the plain version's (rv, ri):
    (max |value difference|, ids that differ). ``tol == 0`` asks for
    bit-identical outputs; otherwise an id may differ only between two
    rows whose scores (recomputed in f64) lie within ``tol``."""
    import torch
    both = torch.isfinite(rv)
    if not torch.equal(torch.isfinite(kv), both) \
            or not torch.equal(ki < 0, ri < 0):
        fail(f"{what}: pad pattern differs")
    err = float((kv[both] - rv[both]).abs().max()) if both.any() else 0.0
    if tol == 0:
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            bad = int((kv != rv).sum() + (ki != ri).sum())
            fail(f"{what}: kernel != plain version ({bad} elements)")
        return err, 0
    if err > tol:
        fail(f"{what}: max |kernel - plain| {err} > {tol}")
    diff = (ki != ri).nonzero().tolist()
    for qi, j in diff:
        a, b = int(ki[qi, j]), int(ri[qi, j])
        qv = q[qi].double()
        sa, sb = float(qv @ c[a].double()), float(qv @ c[b].double())
        if abs(sa - sb) > tol:
            fail(f"{what}: idx differs beyond a near-tie at {(qi, j)}: "
                 f"{a} ({sa}) vs {b} ({sb})")
    return err, len(diff)


def phase_small_exact_kernels(bt, ft, torch):
    """Phase 9: fused_topk and block_topk vs their plain versions on the
    card, small size."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q_n, n, d, k = 77, 10_007, 768, 10        # neither a tile multiple
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        c = torch.randn((n, d), generator=g, device="cuda")
        c = (c / c.norm(dim=1, keepdim=True)).to(dtype)
        q = torch.randn((q_n, d), generator=g, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        worst, near = 0.0, 0
        for vc in (None, torch.tensor(n - 500, device="cuda"), 3):
            what = f"{name} valid_count={'N' if vc is None else int(vc)}"
            fv, fi = ft.fused_topk(q, c, k, valid_count=vc)
            torch.cuda.synchronize()
            err, nd = check_topk(fv, fi, *ft.fused_topk_reference(
                q, c, k, valid_count=vc), q, c, F32_TOL, f"fused_topk {what}")
            worst, near = max(worst, err), near + nd
            for splits in (1, 7):       # the split is no part of the result
                sv, si = ft.fused_topk(q, c, k, valid_count=vc,
                                       n_splits=splits)
                if not (torch.equal(sv, fv) and torch.equal(si, fi)):
                    fail(f"fused_topk {what}: n_splits={splits} changes the "
                         f"result")
            ev, ei = bt.block_topk(q, c, k, p=k, valid_count=vc, block_n=512)
            if not (torch.equal(ev, fv) and torch.equal(ei, fi)):
                fail(f"block_topk(p=k) {what} != fused_topk")
            kw = dict(p=2, valid_count=vc, block_n=256)
            bv, bi = bt.block_topk(q, c, k, **kw)
            torch.cuda.synchronize()
            err, nd = check_topk(bv, bi, *bt.block_topk_reference(
                q, c, k, **kw), q, c, F32_TOL, f"block_topk p=2 {what}")
            worst, near = max(worst, err), near + nd
            if vc is not None and int(vc) < k and not (
                    bool((fi[:, int(vc):] == -1).all())
                    and bool(torch.isneginf(fv[:, int(vc):]).all())):
                fail(f"fused_topk {what}: slots past the live rows are not "
                     f"(-inf, -1)")
        # the tie rule: small-integer rows (every partial sum exact in
        # f32), each row two or three times, across blocks and splits
        base = torch.randint(-3, 4, (1500, 64), generator=g,
                             device="cuda").to(dtype)
        ci = torch.cat([base, base, base[:700]])
        qi = base[:50] * 2
        rv, ri = ft.fused_topk_reference(qi, ci, 12)
        check_topk(*ft.fused_topk(qi, ci, 12, n_splits=5), rv, ri, qi, ci, 0,
                   f"fused_topk {name} integer rows")
        check_topk(*bt.block_topk(qi, ci, 12, p=12, block_n=128), rv, ri, qi,
                   ci, 0, f"block_topk(p=k) {name} integer rows")
        check_topk(*bt.block_topk(qi, ci, 12, p=3, block_n=128),
                   *bt.block_topk_reference(qi, ci, 12, p=3, block_n=128),
                   qi, ci, 0, f"block_topk(p=3) {name} integer rows")
        log(f"kernel check fused_topk + block_topk {name} Q={q_n} N={n} "
            f"d={d} k={k}, valid_count N / N-500 (device tensor) / 3, "
            f"n_splits 1 / 7 / default equal, block_topk(p=k) == fused_topk: "
            f"max_abs_err={worst:.3g} (tol {F32_TOL}), {near} ids differ "
            f"within it; integer rows with duplicates: bit-identical")


def library_topk(torch, q, c, k, block=65_536):
    """The yardstick the port never calls: ``torch.matmul`` in the corpus
    dtype over row blocks, ``torch.topk`` of each, ``torch.topk`` of the
    blocks' winners."""
    vals, idx = [], []
    for lo in range(0, c.shape[0], block):
        v, i = torch.topk(torch.matmul(q, c[lo:lo + block].T),
                          min(k, c.shape[0] - lo), dim=1)
        vals.append(v)
        idx.append(i + lo)
    v, pos = torch.topk(torch.cat(vals, dim=1), k, dim=1)
    return v, torch.gather(torch.cat(idx, dim=1), 1, pos)


def exact_phases(args, card) -> list[dict]:
    """Phases 9-11: the exact flat scan. Returns the two kernels' entries
    of the ``kernels`` line."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.utils import roofline
    from rag_foundation_tpu_torch.engine import ivf as tivf
    from rag_foundation_tpu_torch.engine.index import StoreIndex
    from rag_foundation_tpu_torch.ops import block_topk as bt
    from rag_foundation_tpu_torch.ops import fused_topk as ft
    from rag_foundation_tpu_torch.ops import ivf_scan
    from rag_foundation_tpu_torch.ops.hosted_topk import exact_topk_hosted
    from rag_foundation_tpu_torch.ops.topk import exact_topk
    from rag_foundation_tpu_torch.tools import exact_scan

    phase_small_exact_kernels(bt, ft, torch)

    # -- phase 10: the exact-scan path at full width -------------------------
    n, d, q_n, k = args.exact_rows, 768, 1024, 10
    bt.LAUNCHES.reset()                          # counts: this path only
    ft.LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    res = exact_scan.run_exact_1m("cuda", n=n, d=d, q_n=q_n, k=k,
                                  seed=args.seed)
    launches = (bt.LAUNCHES.count, ft.LAUNCHES.count)   # read just after
    log(f"exact scan {n}x{d} bf16 Q={q_n} k={k} block_topk(p=2, "
        f"block_n=1024): {res['ms_per_batch']:.3f} ms a batch = "
        f"{res['qps']:,.0f} QPS; recall@{k} of {res['recall_queries']} "
        f"queries {res['recall_vs_exact']:.4f} vs exact_topk, "
        f"{res['recall_vs_fused']:.4f} vs fused_topk; fused_topk vs "
        f"exact_topk: {res['fused_vs_exact_near_ties']} ids differ, all "
        f"between scores within {res['score_tolerance']:.3g}; launches "
        f"block_topk {launches[0]} fused_topk {launches[1]}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    if res["card"] != card:
        fail(f"run_exact_1m names the card {res['card']!r}, not {card!r}")
    if min(launches) == 0:
        fail(f"the exact-scan path launched {launches}")
    if min(res["recall_vs_exact"], res["recall_vs_fused"]) < RECALL_MIN:
        fail(f"block_topk(p=2) recall@{k} {res['recall_vs_exact']} < "
             f"{RECALL_MIN}")

    # each kernel against its plain version on the path's own inputs
    corpus, queries = exact_scan.make_corpus(n, d, q_n, args.seed,
                                             torch.device("cuda"))
    tol = exact_scan.score_tolerance(queries, corpus)
    bound_ms, bound_by = roofline.topk_bound(q_n, n, d, k, 2, "bf16")
    library_ms = cuda_ms(lambda: library_topk(torch, queries, corpus, k),
                         reps=5)
    entries = []
    for name, mod, fn, ref, line, count in (
            ("block_topk", bt, lambda: bt.block_topk(queries, corpus, k, p=2),
             lambda: bt.block_topk_reference(queries, corpus, k, p=2),
             "pallas_block_topk.py:68", launches[0]),
            ("fused_topk", ft, lambda: ft.fused_topk(queries, corpus, k),
             lambda: ft.fused_topk_reference(queries, corpus, k),
             "pallas_topk.py:91", launches[1])):
        kv, ki = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rv, ri = ref()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, near = check_topk(kv, ki, rv, ri, queries, corpus, tol,
                               f"{name} main")
        del kv, ki, rv, ri
        ms = cuda_ms(fn, reps=10)
        split = {}
        if mod is bt:       # the kernel (stage 1) and stage 2 apart
            split["kernel_ms"] = cuda_ms(lambda: bt.block_candidates(
                queries, corpus, 2, n, 1024), reps=10)
            cands = bt.block_candidates(queries, corpus, 2, n, 1024)
            split["stage2_ms"] = cuda_ms(lambda: bt._finish(*cands, k),
                                         reps=10)
            del cands
        log(f"{name} bf16 main path, Q={q_n} N={n} d={d} k={k}"
            f"{' p=2 block_n=1024 (stage-2 merge included)' if mod is bt else ''}"
            f": max_abs_err={err:.3g} (tol {tol:.3g}), {near} ids differ "
            f"within it; kernel {ms:.3f} ms"
            + (f" (stage 1 alone {split['kernel_ms']:.3f} ms, stage 2 alone "
               f"{split['stage2_ms']:.3f} ms)" if split else "")
            + f", plain {plain_ms:.3f} ms (one "
            f"run), torch.matmul+topk (bf16, 65,536-row blocks) "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) | "
            f"{card}")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"rag_foundation_tpu_torch/csrc/{name}.cu",
            "replaces": f"rag_foundation_tpu/ops/{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "dtype": "bf16", **split,
            "shape": {"Q": q_n, "N": n, "d": d, "k": k,
                      **({"p": 2, "block_n": 1024} if mod is bt else {})},
        })
    del corpus, queries
    torch.cuda.empty_cache()

    # -- phase 11: the host-streamed scan, then a streamed IVF body ---------
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    host = torch.empty((n, d), dtype=torch.float32, pin_memory=True)
    dev_rows = torch.empty((n, d), dtype=torch.float32, device="cuda")
    for lo in range(0, n, 131_072):
        hi = min(n, lo + 131_072)
        dev_rows[lo:hi] = torch.randn((hi - lo, d), generator=g,
                                      device="cuda")
        host[lo:hi].copy_(dev_rows[lo:hi])
    hq = dev_rows[:64] + 0.1 * torch.randn((64, d), generator=g,
                                           device="cuda")
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):      # the first run also allocates the pinned buffers
        t0 = time.perf_counter()
        hv, hi_ = exact_topk_hosted(hq, host.numpy(), k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dv, di = exact_topk(hq, dev_rows, k)
    if not torch.equal(hi_, di):
        fail(f"exact_topk_hosted: {int((hi_ != di).sum())} ids differ from "
             f"exact_topk on the device copy")
    gb = n * d * 4 / 1e9
    log(f"exact_topk_hosted {n}x{d} f32 ({gb:.2f} GB in host memory) Q=64 "
        f"k={k} block_rows=262144: ids bit-identical to exact_topk on the "
        f"device copy, max |value difference| "
        f"{float((hv - dv).abs().max()):.3g}; {walls[1]:.3f} s = "
        f"{gb / walls[1]:.2f} GB/s (first run {walls[0]:.3f} s) | {card}")
    del host, dev_rows, hq, hv, hi_, dv, di
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed + 3)
    sn, nlist = 20_000, 64
    centres = rng.standard_normal((256, d)).astype(np.float32)
    rows = centres[rng.integers(0, 256, sn)] \
        + 0.5 * rng.standard_normal((sn, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    t0 = time.perf_counter()
    body, overflow = tivf.build_ivf_flat_streaming(
        lambda lo, hi: rows[lo:hi], sn, d, nlist,
        generator=torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda", chunk=4096)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if overflow.any() or body.n != sn or body.lists.dtype != torch.int8:
        fail(f"build_ivf_flat_streaming: n={body.n} overflow="
             f"{int(overflow.sum())} dtype={body.lists.dtype}")
    seg = StoreIndex(d, mode="ivf_flat_int8", nlist=nlist, nprobe=8, ivf_p=3,
                     approx_routing=True, device="cuda")
    seg.adopt_body(body, np.arange(sn, dtype=np.int64) + 1000)
    picks = rng.choice(sn, 256, replace=False)
    qs = rows[picks] + 0.01 * rng.standard_normal((256, d)).astype(np.float32)
    scan0 = ivf_scan.LAUNCHES.count
    _, ids_batch = seg.search(qs, 5)             # Q*nprobe*8 > nlist
    batch_launches = ivf_scan.LAUNCHES.count - scan0
    ids_single = np.stack([seg.search(qs[i:i + 1], 5)[1][0]
                           for i in range(16)])   # the small-batch path
    if batch_launches == 0:
        fail("the batched search of the streamed body launched no list scan")
    # a batch drops the probes past a list's default qcap, as the JAX
    # engine does, so the batch is held to the recall floor and the single
    # searches (no qcap on the small-batch path) to every hit
    right = int((ids_batch[:, 0] == picks + 1000).sum())
    right1 = int((ids_single[:, 0] == picks[:16] + 1000).sum())
    if right < RECALL_MIN * 256 or right1 != 16:
        fail(f"streamed body: right top hit for {right}/256 batched and "
             f"{right1}/16 single searches")
    log(f"build_ivf_flat_streaming {sn}x{d} f32 source, nlist={nlist}, "
        f"chunk 4096: {build_s:.2f} s, cap_len={body.cap_len}, no overflow; "
        f"adopted with adopt_body, approx_routing=True: right top hit "
        f"{right}/256 in one batch ({batch_launches} list-scan launch) and "
        f"16/16 single searches | {card}")
    return entries


def pq_phases(args, card, rng, sampled, mods) -> tuple[list[dict], dict]:
    """Phases 6-8: the ``ivf_pq`` store. Returns the two kernels' entries
    of the ``kernels`` line."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.utils import roofline
    (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
     HostArchive, tpq, pq_scan, gather, quantize) = mods
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-pq-")
    sock = str(Path(data_dir) / "engine.sock")
    # ivf_p=8: the 400 documents are near-duplicates of one template and
    # land in one posting list, a dozen to a sub-block; a capture of 4 rows
    # a sub-block (the JAX engine's fixed width) loses some of a
    # question's ten nearest there
    cfg = dict(dim=768, index_mode="ivf_pq", pq_m=192, pq_packed=False,
               pq_refine="device", nlist=4096, nprobe=32, ivf_p=8,
               batch_window_s=0.02, build_threshold=256, data_dir=data_dir,
               device="cuda")
    key = "stores/chip-smoke-pq"
    pq_scan.LAUNCHES.reset()                     # counts: this path only
    gather.LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(EngineConfig(**cfg))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    try:
        remote.create_store(key)
        t0 = time.perf_counter()
        for i in range(args.docs):
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        seg = engine._store(key).segment
        saved = seg.body
        if saved is None or type(saved).__name__ != "IVFPQIndex":
            fail("the real documents built no IVF-PQ body")
        saved = {"codes": saved.codes.clone(),
                 "row_ids": saved.row_ids.clone(),
                 "centroids": saved.centroids.clone(),
                 "codebook_centroids": saved.codebook_centroids.clone(),
                 "refine": saved.refine.clone(),
                 "archive": seg._pq_archive.chunk_i8(
                     0, seg._pq_archive.n).copy()}
        log(f"ivf_pq: ingested {args.docs} documents in "
            f"{time.perf_counter() - t0:.2f} s; PQ body of "
            f"{int((saved['row_ids'] >= 0).sum())} rows, nlist "
            f"{saved['row_ids'].shape[0]}, m {saved['codes'].shape[2]}, "
            f"refine {tuple(saved['refine'].shape)}, archive "
            f"{saved['archive'].shape[0]} rows, tail {seg.tail.count}")
        before_pad = {i: remote.search([key], fact_query(i), k=5)
                      for i in sampled}
        for i, hits in before_pad.items():
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"ivf_pq before padding: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")

        # mass import: the store's live rows, then pads generated on the
        # card with the pad_store distribution, into a host archive; the
        # body is built from it by the streaming build
        t0 = time.perf_counter()
        base_v, base_i = seg.live_rows()
        n_pad = max(0, args.pq_rows - len(base_i))
        total = len(base_i) + n_pad
        arch = HostArchive(768)
        arch.reserve(total)
        arch.append(base_v)
        chunk = 1 << 18
        gen = engine.pad_generator(engine.pad_centers(args.seed),
                                   Engine.PAD_NOISE, args.seed, chunk,
                                   seg.device)
        for ci in range(-(-n_pad // chunk)):
            take = min(chunk, n_pad - ci * chunk)
            arch.append(quantize.quantize_with_scale(
                gen(ci)[:take], arch.scale).cpu().numpy())
        fill_s = time.perf_counter() - t0
        pad_ids = np.arange(Engine.PAD_ID_BASE, Engine.PAD_ID_BASE + n_pad,
                            dtype=np.int64)
        t0 = time.perf_counter()
        seg.bulk_load_archive(arch, np.concatenate([base_i, pad_ids]))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        engine._pad_counts[key] = n_pad   # searches over-fetch past pads
        body = seg.body
        code_bytes = body.codes.numel() + body.row_ids.numel() * 4
        mean_list = body.n / body.nlist
        log(f"ivf_pq store rows {total} (pad {n_pad}) d=768: archive fill "
            f"(pads generated on the card, int8 to the host) {fill_s:.2f} "
            f"s; streaming build {build_s:.2f} s = {total / build_s:,.0f} "
            f"vec/s; body nlist={body.nlist} cap_len={body.cap_len} "
            f"m={body.m} live={body.n} (mean list {mean_list:.1f}, "
            f"cap_len/mean {body.cap_len / mean_list:.3f}), in tail "
            f"{seg.tail.count}; codes+ids {code_bytes / 2**30:.2f} GiB, "
            f"refine {body.refine.numel() / 2**30:.2f} GiB | {card}")

        lat = []
        for i in sampled:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"ivf_pq padded store: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        log(f"ivf_pq single search over RPC: p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms ({len(lat)} searches, right "
            f"top hit each; a lone request waits out the "
            f"{cfg['batch_window_s'] * 1e3:.0f} ms admission window) | "
            f"{card}")
        qv1 = engine.encoder.encode([fact_query(i) for i in sampled])
        lat1, served = [], []
        for i in range(len(sampled)):
            t0 = time.perf_counter()
            served.append(seg.search(qv1[i:i + 1], 10)[1][0])
            lat1.append((time.perf_counter() - t0) * 1e3)
        log(f"ivf_pq StoreIndex.search Q=1 in process (every batch size "
            f"goes through the list-scan kernel): p50 "
            f"{np.percentile(lat1, 50):.3f} ms p99 "
            f"{np.percentile(lat1, 99):.3f} ms | {card}")
        exact = seg.exact_reference_search(qv1, 10)
        # Engine.search asks a padded store's index for max(4k, 32) rows
        # (pads carry no metadata and are dropped from the hits), so for
        # k=10 the index re-ranks the ADC top 256: the served top 10 are
        # the first 10 of that. The bare index call with k=10 re-ranks 64
        served40 = np.stack([seg.search(qv1[i:i + 1], 40)[1][0, :10]
                             for i in range(len(sampled))])
        fact_recall = pq_recall_with_ties(seg, gather, qv1, served40, exact)
        log(f"ivf_pq recall@10 of fact questions (Q=1) vs "
            f"exact_reference_search: {fact_recall:.4f} counting a chunk "
            f"that ties the 10th exact score (integer int8 dots), "
            f"{recall_at(served40, exact):.4f} by ids alone, as "
            f"Engine.search asks the index (40 rows, ADC top 256 "
            f"re-ranked); StoreIndex.search(k=10) (ADC top 64 re-ranked) "
            f"{pq_recall_with_ties(seg, gather, qv1, served, exact):.4f} "
            f"and {recall_at(served, exact):.4f}; {len(sampled)} questions "
            f"| {card}")
        if fact_recall < RECALL_MIN:
            fail(f"ivf_pq fact-question recall@10 {fact_recall} < "
                 f"{RECALL_MIN}")

        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 24)]
        scan0, gather0 = pq_scan.LAUNCHES.count, gather.LAUNCHES.count
        search_profile.reset()
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        batches = search_profile.snapshot().get("body_dispatch",
                                                {"n": 0})["n"]
        right = sum(1 for i, h in zip(qids, hits)
                    if h and h[0].doc_id == f"doc-{i}")
        conc = (pq_scan.LAUNCHES.count - scan0,
                gather.LAUNCHES.count - gather0)
        log(f"ivf_pq concurrent search over RPC: {threads} threads, "
            f"{len(qids)} queries in {wall:.3f} s = "
            f"{len(qids) / wall:,.1f} QPS; {batches} batches (mean "
            f"{len(qids) / max(1, batches):.1f} queries), launches "
            f"pq_list_scan {conc[0]} gather_rescore_int8 {conc[1]}; right "
            f"top hit {right}/{len(qids)} ({right / len(qids):.4f}) | {card}")
        if min(conc) == 0:
            fail(f"ivf_pq concurrent batches launched {conc}")

        bq = [fact_query(int(i)) for i in rng.integers(0, args.docs, 1024)]
        remote.search_batch(key, bq[:64], k=10)
        t0 = time.perf_counter()
        scores, ids = remote.search_batch(key, bq, k=10)
        bwall = time.perf_counter() - t0
        if scores.shape != (1024, 10):
            fail(f"ivf_pq search_batch returned {scores.shape}")
        log(f"ivf_pq search_batch Q=1024 over RPC (encode included): "
            f"{bwall * 1e3:.1f} ms = {1024 / bwall:,.0f} QPS; top score "
            f"finite for {int(np.isfinite(scores[:, 0]).sum())}/1024 | "
            f"{card}")
        probe = remote.recall_probe(key, k=10, sample=64)
        if probe["recall"] is None:
            fail(f"ivf_pq recall_probe {probe}")
        log(f"ivf_pq recall_probe@10 (stored rows, nearly all pads) vs "
            f"exact_reference_search: {probe['recall']:.4f} (sample "
            f"{probe['sample']}) | {card}")

        # the other refine tiers on the same body, a short run each
        seg.pq_refine = "host"
        for i in sampled[:16]:
            hits = remote.search([key], fact_query(i), k=5)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"ivf_pq host refine: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        log(f"ivf_pq pq_refine=host (ADC on the card, rescore against the "
            f"host archive): right top hit 16/16 | {card}")
        with seg._body_lock:
            seg.pq_refine = "none"
            seg.body = body._replace(refine=body.refine[:0, :0])
        right = 0
        for i in sampled[:16]:
            hits = remote.search([key], fact_query(i), k=5)
            right += bool(hits and hits[0].doc_id == f"doc-{i}")
        log(f"ivf_pq pq_refine=none (raw ADC ranking): right top hit "
            f"{right}/16 | {card}")
        with seg._body_lock:
            seg.pq_refine = "device"
            seg.body = body
        launches = (pq_scan.LAUNCHES.count, gather.LAUNCHES.count)
        log(f"ivf_pq main path kernel launches: pq_list_scan {launches[0]}, "
            f"gather_rescore_int8 {launches[1]}; device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        if min(launches) == 0:
            fail(f"the ivf_pq main path launched {launches}")

        qv = engine.encoder.encode(bq)
        seg.search(qv, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            seg.search(qv, 10)
        dwall = (time.perf_counter() - t0) / 3
        log(f"ivf_pq StoreIndex.search Q=1024 in process: "
            f"{dwall * 1e3:.2f} ms = {1024 / dwall:,.0f} QPS | {card}")
        probe_rows, probe_ids = seg.sample_live_rows(1024,
                                                     seed=args.seed + 1)
        pq_arch, pq_cids = seg._pq_archive, seg.body_chunk_ids  # phase 18
        seg.search(probe_rows, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            seg.search(probe_rows, 10)
        swall = (time.perf_counter() - t0) / 3
        log(f"ivf_pq StoreIndex.search Q=1024 stored rows in process (host "
            f"clock, int8 transport, device refine, tail merge): "
            f"{swall * 1e3:.2f} ms = {1024 / swall:,.0f} QPS | {card}")
    finally:
        remote.close()
        server.shutdown()

    # -- phase 7: restart on the same data_dir ------------------------------
    del engine, seg, remote, server, arch
    gc.collect()
    engine2 = Engine(EngineConfig(**cfg))
    server2 = EngineRpcServer(engine2, sock, allow_pad=True).start()
    remote2 = RemoteEngine(sock)
    try:
        seg2 = engine2._store(key).segment
        back = seg2.body
        if back is None or type(back).__name__ != "IVFPQIndex":
            fail("ivf_pq restart: no PQ body reloaded")
        for name in ("codes", "row_ids", "centroids", "codebook_centroids",
                     "refine"):
            if not torch.equal(getattr(back, name), saved[name]):
                fail(f"ivf_pq restart: reloaded {name} differs")
        if seg2._pq_archive is None or not np.array_equal(
                seg2._pq_archive.chunk_i8(0, seg2._pq_archive.n),
                saved["archive"]):
            fail("ivf_pq restart: reloaded archive differs")
        for i in sampled:
            again = remote2.search([key], fact_query(i), k=5)
            if again != before_pad[i]:
                fail(f"ivf_pq restart: hits for project {i} differ")
        log(f"ivf_pq restart: body.npz reloaded verbatim on the card "
            f"(codes, ids, codebooks, refine) with its archive; "
            f"{len(sampled)} queries give the same hits (the store as "
            f"saved; pads are not persisted)")
    finally:
        remote2.close()
        server2.shutdown()
    del engine2, remote2, server2, back, saved, seg2
    gc.collect()

    # -- phase 8: the two kernels on the PQ path's own dispatch -------------
    # a Q=1024 batch of stored rows through the engine's own transport
    # (int8, batch-absmax scale), routing and inversion
    fetch = 16                # what StoreIndex passes for k=10
    p = min(cfg["ivf_p"], fetch)
    q_scale = float(np.abs(probe_rows).max()) / 127.0
    q8 = torch.as_tensor(np.clip(np.round(probe_rows / q_scale), -127, 127)
                         .astype(np.int8), device="cuda")
    q32, _, _, dispatch, _, dropped = tpq.route(body, q8, 32,
                                                q_scale=q_scale)
    lut_disp, _ = tpq.scan_inputs(body, q32, dispatch, torch.int8)
    nlist, qcap, km = lut_disp.shape
    cap_len, m_bytes = body.codes.shape[1], body.codes.shape[2]
    live_n = pq_scan.live_slots(dispatch)
    kv, ki = pq_scan.pq_list_scan(lut_disp, body.codes, body.row_ids,
                                  dispatch, p=p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rv, ri = pq_scan.pq_list_scan_reference(lut_disp, body.codes,
                                            body.row_ids, dispatch, p=p)
    torch.cuda.synchronize()
    scan_plain_ms = (time.perf_counter() - t0) * 1e3
    scan_err = check_pq_scan(kv, ki, rv, ri, True, "pq_list_scan int8 main")
    del kv, ki, rv, ri
    scan_ms = cuda_ms(lambda: pq_scan.pq_list_scan(
        lut_disp, body.codes, body.row_ids, dispatch, p=p), reps=5,
        warmup=1)
    scan_bound_ms, scan_by, c = roofline.pq_scan_bound(body.row_ids, live_n, qcap, p,
                                              body.m, m_bytes, 1)
    log(f"pq_list_scan int8 LUT main path, Q=1024 stored rows: "
        f"nlist={nlist} qcap={qcap} (dropped {int(dropped)}) "
        f"cap_len={cap_len} m={body.m} p={p}, {c['lists_read']} lists with "
        f"queries, {c['live_slots']} live slots, {c['rows_needed']} live "
        f"rows of {c['rows_in_lists_read']}, {c['lookups']:.3e} lookups: "
        f"bit-identical; kernel {scan_ms:.3f} ms, plain "
        f"{scan_plain_ms:.3f} ms (one run), no single library call, bound "
        f"{scan_bound_ms:.3f} ms ({scan_by}) | {card}")
    del lut_disp
    # the same Q=1024 search split by stage, as StoreIndex runs it
    stage_split(
        torch, lambda: tpq.ivfpq_search(body, q8, fetch, nprobe=32, p=p,
                                        q_scale=q_scale),
        [(tpq, "route", "after"), (tpq, "scan_inputs", "after"),
         (tpq, "pq_list_scan", "after"), (tpq, "_refine_rerank", "before")],
        ["coarse + dispatch", "LUT build and gather", "list scan",
         "regather and ADC top-C", "re-rank"], card,
        "ivf_pq search of Q=1024 stored rows (ivfpq_search, split by CUDA "
        "events between its stages in one call)")

    q32, _, rows, _ = tpq.adc_top_rows(body, q8, fetch, nprobe=32, p=p,
                                       q_scale=q_scale)
    qq, _ = quantize.quantize_int8(q32)
    rows = rows.contiguous()
    q_n, cands = rows.shape
    out = gather.gather_rescore_int8(body.refine, rows, qq)
    torch.cuda.synchronize()
    ref = gather.gather_rescore_int8_reference(body.refine, rows, qq)
    if not torch.equal(out, ref):
        fail("gather_rescore_int8 main: kernel != plain version")
    del out, ref
    gather_ms = cuda_ms(lambda: gather.gather_rescore_int8(
        body.refine, rows, qq), reps=20)
    gather_plain_ms = cuda_ms(lambda: gather.gather_rescore_int8_reference(
        body.refine, rows, qq), reps=3, warmup=1)
    gather_bound_ms, gather_by = roofline.gather_bound(q_n, cands, 768)
    log(f"gather_rescore_int8 main path, Q={q_n} C={cands} d=768 over a "
        f"refine table of {body.refine.shape[0]} rows: bit-identical; "
        f"kernel {gather_ms:.4f} ms, plain {gather_plain_ms:.3f} ms, no "
        f"single library call, bound {gather_bound_ms:.4f} ms "
        f"({gather_by}) | {card}")

    # -- phase 18: the sharded engine over the same body ---------------------
    sharded = mesh_pq_phase(
        args, card, (cfg, key, sock, body, pq_cids, pq_arch, n_pad, qv1, exact,
               probe_rows, probe_ids, sampled, rng, p),
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
         tpq, pq_scan, gather))
    shutil.rmtree(data_dir, ignore_errors=True)
    host_rerank = sharded.pop("host_rerank")
    return [{
        "name": "pq_list_scan", "route": "cuda",
        "source": "rag_foundation_tpu_torch/csrc/pq_list_scan.cu",
        "replaces": "rag_foundation_tpu/ops/pallas_pq.py:135",
        "launches": launches[0], "max_abs_err": scan_err, "ms": scan_ms,
        "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
        "bound_by": scan_by, "library_ms": None, "dtype": "int8 LUT",
        **sharded,
        "shape": {"nlist": nlist, "qcap": qcap, "cap_len": cap_len,
                  "m": body.m, "m_bytes": m_bytes, "p": p, **c},
    }, {
        "name": "gather_rescore_int8", "route": "cuda",
        "source": "rag_foundation_tpu_torch/csrc/gather_rescore_int8.cu",
        "replaces": "rag_foundation_tpu/ops/pallas_gather.py:66",
        "launches": launches[1], "max_abs_err": 0.0, "ms": gather_ms,
        "plain_ms": gather_plain_ms, "bound_ms": gather_bound_ms,
        "bound_by": gather_by, "library_ms": None, "dtype": "int8",
        "shape": {"N": int(body.refine.shape[0]), "Q": q_n, "C": cands,
                  "d": 768},
    }], host_rerank


_NOUNS = ("report", "budget", "engineer", "station", "survey", "network",
          "harbor", "archive", "signal", "garden", "council", "reactor",
          "library", "market", "tunnel", "orchard")
_VERBS = ("measured", "reported", "tested", "moved", "checked", "updated",
          "ranked", "opened")


def long_doc(rng, words: int) -> str:
    """``words`` whitespace words of report prose from ``rng``: plurals,
    past tenses, adverbs and numbers with separators, which the tokenizer
    splits, so a 200-word chunk tokenizes past 256 ids."""
    out, n = [], 0
    while n < words:
        a, b = rng.integers(0, len(_NOUNS), 2)
        sent = (f"The {_NOUNS[a]}s of project "
                f"{project_name(int(rng.integers(8000)))} "
                f"{_VERBS[int(rng.integers(len(_VERBS)))]} "
                f"{int(rng.integers(1, 999))},{int(rng.integers(1000)):03d} "
                f"credits quickly, and the {_NOUNS[b]} teams were "
                f"{_VERBS[int(rng.integers(len(_VERBS)))]} steadily.")
        out.append(sent)
        n += len(sent.split())
    return " ".join(out)


def attention_inputs(torch, g, b, h, s, d, dtype):
    """q, k, v normal; segment 1 for a token, 0 for a pad; random lengths,
    row 1 all pads, row 2 one token."""
    q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lengths[1], lengths[2] = 0, 1
    seg = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])
    return q, k, v, seg.int().contiguous()


class ShapeTally:
    """The forward kernel's launches by shape while started: wraps
    ``flash_attention_forward``, which ``flash_attention`` and
    ``FlashAttention`` look up at call time, and counts its calls on card
    tensors by (B, S). Printed beside the wrapper's own counter, which
    stays the check."""

    def __init__(self, fa):
        self.fa, self.orig, self.counts = fa, fa.flash_attention_forward, {}

    def start(self) -> "ShapeTally":
        def counted(q, *a, **kw):
            if q.device.type == "cuda" and q.numel() > 0:
                key = (q.shape[0], q.shape[2])
                self.counts[key] = self.counts.get(key, 0) + 1
            return self.orig(q, *a, **kw)

        self.fa.flash_attention_forward = counted
        return self

    def stop(self) -> dict:
        self.fa.flash_attention_forward = self.orig
        return self.counts

    def text(self) -> str:
        """"S=... : n launches (B ...)" by S, the largest S first."""
        by_s = {}
        for (b, s), n in self.counts.items():
            by_s.setdefault(s, []).append((b, n))
        return "; ".join(
            f"S={s}: {sum(n for _, n in bs)} (" + ", ".join(
                f"B={b} x{n}" for b, n in sorted(bs, reverse=True)[:4])
            + (", ..." if len(bs) > 4 else "") + ")"
            for s, bs in sorted(by_s.items(), reverse=True))


def check_attention(torch, out, ref, v, kind, what) -> tuple[float, float]:
    """(max |kernel - plain|, tolerance); fails beyond the tolerance."""
    tol = ATTN_TOL[kind] * float(v.float().abs().max())
    if not bool(torch.isfinite(out).all()):
        fail(f"{what}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    if err > tol:
        fail(f"{what}: max |kernel - plain| {err} > {tol}")
    return err, tol


def phase_small_attention(fa, torch):
    """Phase 12: flash_attention vs its plain version on the card."""
    g = torch.Generator(device="cuda").manual_seed(4)
    h, d = 12, 32
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        report = []
        for b, s in ((8, 16), (8, 32), (8, 100), (8, 128), (24, 512)):
            q, k, v, seg = attention_inputs(torch, g, b, h, s, d, dtype)
            out = fa.flash_attention(q, k, v, seg, seg, d ** -0.5)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v, seg, seg, d ** -0.5)
            err, tol = check_attention(torch, out, ref, v, kind,
                                       f"flash_attention {kind} S={s}")
            report.append(f"S={s} B={b} {err:.3g} (tol {tol:.3g})")
            del q, k, v, seg, out, ref
        log(f"kernel check flash_attention {kind} H={h} D={d}, random "
            f"lengths, an all-pad row, a one-token row: max_abs_err "
            + ", ".join(report))


def encoder_phases(args, card, rng, sampled, mods) -> dict:
    """Phase 13: the MiniLM encoder path. Returns the flash_attention
    entry of the ``kernels`` line."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.utils import roofline
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    Engine, EngineConfig, EngineRpcServer, RemoteEngine = mods
    ckpt = ROOT / "checkpoints" / "minilm_ict.npz"
    if not ckpt.exists():
        fail(f"{ckpt} not found")
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-minilm-")
    sock = str(Path(data_dir) / "engine.sock")
    key = "stores/chip-smoke-minilm"
    # 76 words a chunk stays inside the checkpoint's 128-token window (no
    # warning). An IVF-Flat body of 16 lists, all probed, capturing 10
    # rows a sub-block: under MiniLM the near-duplicate fact documents
    # crowd a few lists, and 12 probes with the default capture of 4
    # served recall@10 0.9359 (a throwaway run on the H100)
    base = dict(chunk_tokens=76, chunk_overlap=16, index_mode="ivf_flat",
                nlist=16, nprobe=16, ivf_p=10, build_threshold=256,
                batch_window_s=0.02, device="cuda")
    fa.LAUNCHES.reset()                          # counts: this path only
    tally = ShapeTally(fa).start()
    engine = Engine(EngineConfig(dim=384, encoder="minilm",
                                 encoder_ckpt=str(ckpt), data_dir=data_dir,
                                 **base))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    queries = [fact_query(i) for i in sampled]
    try:
        remote.create_store(key)
        t0 = time.perf_counter()
        for i in range(args.docs):
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        ingest_s = time.perf_counter() - t0
        ingest_launches = fa.LAUNCHES.count
        n0 = fa.LAUNCHES.count
        remote.search([key], queries[0], k=10)
        single_launches = fa.LAUNCHES.count - n0
        seg = engine._store(key).segment
        log(f"minilm (minilm_ict.npz: hidden 384, 6 layers, 12 heads, "
            f"max_len 128): ingested {args.docs} documents over RPC in "
            f"{ingest_s:.2f} s ({remote.store_stats(key)['chunks']} chunks, "
            f"IVF-Flat body {'built' if seg.body is not None else 'NOT built'}"
            f"); flash_attention launches: ingest {ingest_launches}, one "
            f"single search {single_launches} | {card}")
        if ingest_launches == 0 or single_launches == 0:
            fail(f"the MiniLM path launched flash_attention {ingest_launches}"
                 f" times on ingest and {single_launches} on a search")
        lat, served, right = [], [], 0
        for i, q in zip(sampled, queries):
            t0 = time.perf_counter()
            hits = remote.search([key], q, k=10)
            lat.append((time.perf_counter() - t0) * 1e3)
            served.append([h.chunk_id for h in hits]
                          + [-1] * (10 - len(hits)))
            right += bool(hits and hits[0].doc_id == f"doc-{i}")
        # one question an encode, as served: another batch shape rounds
        # the bf16 forward differently, which can swap near-tied chunks
        qv = np.concatenate([engine.encoder.encode([q]) for q in queries])
        recall = recall_at(np.asarray(served), seg.exact_reference_search(
            qv, 10))
        log(f"minilm single search over RPC (encode on the card included): "
            f"p50 {np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms ({len(lat)} searches, a lone "
            f"request waits out the {base['batch_window_s'] * 1e3:.0f} ms "
            f"window); recall@10 vs exact_reference_search {recall:.4f}; "
            f"right top hit {right}/{len(sampled)} | {card}")
        if recall < RECALL_MIN:
            fail(f"minilm recall@10 {recall} < {RECALL_MIN}")
        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 8)]
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        right_c = sum(1 for i, h in zip(qids, hits)
                      if h and h[0].doc_id == f"doc-{i}")
        log(f"minilm concurrent search over RPC: {threads} threads, "
            f"{len(qids)} queries in {wall:.3f} s = {len(qids) / wall:,.1f} "
            f"QPS; right top hit {right_c}/{len(qids)} | {card}")
        # the stored embeddings against the plain attention on the card
        vecs, cids = seg.live_rows()
        store = engine._store(key)
        enc = engine.encoder
        ids = enc.tokenizer.encode_batch(
            [store.chunks[int(c)].text for c in cids], enc.cfg.max_len)
        with torch.inference_mode():
            plain = tenc.encode_tokens(
                enc.params, torch.as_tensor(ids, device="cuda"), enc.cfg,
                attention=fa.flash_attention_reference).cpu().numpy()
        cos = float((vecs * plain).sum(axis=1).min())
        log(f"minilm stored embeddings ({len(cids)}, kernel path, batches "
            f"of one chunk) vs encode_tokens with flash_attention_reference "
            f"on the card (one batch at S={enc.cfg.max_len}): min cosine "
            f"{cos:.6f} (floor {EMBED_COS_MIN}) | {card}")
        if cos < EMBED_COS_MIN:
            fail(f"minilm embeddings: min cosine {cos} < {EMBED_COS_MIN}")
    finally:
        remote.close()
        server.shutdown()
    shutil.rmtree(data_dir, ignore_errors=True)
    del engine, server, remote, seg, store, enc

    # -- the same documents under the hybrid encoder -------------------------
    hyb = Engine(EngineConfig(dim=768, encoder="hybrid",
                              encoder_ckpt=str(ckpt), hybrid_w=0.35,
                              **base))
    hyb.create_store(key)
    n0 = fa.LAUNCHES.count
    t0 = time.perf_counter()
    for i in range(args.docs):
        hyb.ingest_document(key, f"doc-{i}", f"project-{i}.txt", fact_doc(i))
    hyb_s = time.perf_counter() - t0
    right_h = sum(1 for i, q in zip(sampled, queries)
                  if hyb.search([key], q, k=5)[0].doc_id == f"doc-{i}")
    log(f"hybrid (384 hash + 384 MiniLM, w=0.35, dim 768): ingested "
        f"{args.docs} documents in process in {hyb_s:.2f} s "
        f"({fa.LAUNCHES.count - n0} flash_attention launches); right top "
        f"hit {right_h}/{len(sampled)} (MiniLM alone {right}/"
        f"{len(sampled)}) | {card}")
    del hyb

    # -- the long-chunk configuration: MiniLM-L6 at max_len 512 --------------
    cfg512 = tenc.EncoderConfig(max_len=512)
    tmp = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-minilm512-")
    path = str(Path(tmp) / "minilm_l6_len512.npz")
    tenc.save_params(tenc.init_params(
        torch.Generator().manual_seed(args.seed), cfg512), path, cfg512)
    long_e = Engine(EngineConfig(dim=384, encoder="minilm",
                                 encoder_ckpt=path, device="cuda"))
    enc = long_e.encoder
    drng = np.random.default_rng(args.seed + 5)
    # LONG_BATCH + 1 chunks a document at 200 words a chunk, 40
    # overlapping: the ingest pipeline encodes a batch of LONG_BATCH, then 1
    docs = [long_doc(drng, 160 * LONG_BATCH + 200)
            for _ in range(args.long_docs)]
    long_e.create_store(key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j, text in enumerate(docs):
        long_e.ingest_document(key, f"long-{j}", f"long-{j}.txt", text)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    flash_launches = fa.LAUNCHES.count           # read just after the path
    by_shape = tally.stop()
    log(f"flash_attention launches on the serve phases by shape: "
        f"{tally.text()} | {card}")
    store = long_e._store(key)
    texts = [store.chunks[c].text for c in sorted(store.chunks)]
    lens = (enc.tokenizer.encode_batch(texts[:LONG_BATCH], 512) != 0).sum(
        axis=1)
    log(f"minilm max_len 512 (init_params seed {args.seed}, save_params -> "
        f"encoder_ckpt, chunk_tokens 200): ingested {len(docs)} documents "
        f"of {len(docs[0].split())} words = {len(texts)} chunks in "
        f"{long_s:.2f} s = {len(texts) / long_s:,.1f} chunks/s (chunking, "
        f"tokenizing, encoding, insert); a chunk tokenizes to "
        f"{int(lens.min())}-{int(lens.max())} ids, so every batch encodes "
        f"at S={512 if lens.max() > 256 else 256} | {card}")
    # the encoder alone: host tokenizer + device forward, then the forward
    n_enc = min(len(texts), 8 * LONG_BATCH) // LONG_BATCH * LONG_BATCH
    enc.encode(texts[:LONG_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_enc, LONG_BATCH):
        enc.encode(texts[lo:lo + LONG_BATCH])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    ids = torch.as_tensor(enc.tokenizer.encode_batch(texts[:LONG_BATCH],
                                                     512), device="cuda")
    captured = []

    def capture(*a):
        captured.append([t.clone() if torch.is_tensor(t) else t for t in a])
        return fa.flash_attention_reference(*a)

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: tenc.encode_tokens(enc.params, ids, cfg512),
                         reps=5)
        tenc.encode_tokens(enc.params, ids, cfg512, attention=capture)
    log(f"minilm max_len 512 encode of {n_enc} chunks in batches of "
        f"{LONG_BATCH}: {enc_s:.2f} s = {n_enc / enc_s:,.1f} chunks/s with "
        f"the host tokenizer; the device forward alone (6 layers, "
        f"B={LONG_BATCH}, S=512) {fwd_ms:.2f} ms = "
        f"{LONG_BATCH / fwd_ms * 1e3:,.1f} chunks/s | {card}")

    # -- the kernel on the path's own layer-0 inputs, with times -------------
    q, k, v, sq, skv, scale = captured[0]
    del captured
    out = fa.flash_attention(q, k, v, sq, skv, scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, sq, skv, scale)
    err, tol = check_attention(torch, out, ref, v, "bf16",
                               "flash_attention main")
    del out, ref
    b, h, s, d = q.shape
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, sq, skv, scale),
                 reps=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, sq, skv, scale), reps=3, warmup=1)
    mask = (sq[:, :, None] == skv[:, None, :])[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), reps=20)
    bound_ms, bound_by, c = roofline.attention_bound(sq, skv, h, d, 2)
    log(f"flash_attention bf16 main path (layer 0 of a batch of long "
        f"chunks), B={b} H={h} S={s} D={d}, {c['pairs']} of "
        f"{c['dense_pairs']} (query, key) pairs share a segment: "
        f"max_abs_err={err:.3g} (tol {tol:.3g}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention (bool mask) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: bytes "
        f"{c['bytes'] / roofline.HBM_BYTES_S * 1e3:.4f} ms, tensor "
        f"operations {c['operations'] / roofline.PEAK_OPS_S['bf16'] * 1e3:.4f}"
        f" ms, exponential floor {c['exp_floor_ms']:.4f} ms for the "
        f"{c['exponentials']} same-segment pairs x heads; the kernel issues "
        f"{c['exponentials_issued']}, "
        f"{roofline.exp_floor_ms(c['exponentials_issued'], 1):.4f} ms; dense "
        f"S^2 operations {4.0 * b * h * s * s * d / roofline.PEAK_OPS_S['bf16'] * 1e3:.4f}"
        f" ms) | {card}")
    del long_e, enc, q, k, v, sq, skv, mask
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "rag_foundation_tpu_torch/csrc/flash_attention.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        ":758 (called at rag_foundation_tpu/models/"
                        "encoder.py:116)",
            "launches": flash_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "dtype": "bf16",
            "launches_by_b_s": {f"{bb},{ss}": n
                                for (bb, ss), n in by_shape.items()},
            "shape": {"B": b, "H": h, "S": s, "D": d, **c}}


def bwd_check(torch, got, want, bound, kind, what) -> float:
    """Max |kernel - plain| of a backward output; fails beyond
    ``rel * (bound + n * |plain|)`` in any element, (rel, n) =
    ``ATTN_BWD_TOL[kind]`` (``bound`` is sum |a||b| of the output's
    products)."""
    if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        fail(f"{what}: dtype {got.dtype} or non-finite output")
    rel, n = ATTN_BWD_TOL[kind]
    diff = (got.float() - want.float()).abs()
    excess = diff - rel * (bound + n * want.float().abs())
    if float(excess.max()) > 0.0:
        fail(f"{what}: |kernel - plain| beyond the tolerance by "
             f"{float(excess.max())}")
    return float(diff.max())


def check_bwd_kernels(torch, fa, q, k, v, sq, skv, lse, do, di, scale, kind,
                      what) -> tuple[float, float]:
    """Both backward kernels against their plain versions on the same
    inputs: (max_abs_err of dK/dV, of dQ)."""
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, sq, skv, lse, do, di, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, sq, skv, lse, do, di, scale)
    torch.cuda.synchronize()
    rk, rv = fa.flash_attention_bwd_dkv_reference(q, k, v, sq, skv, lse, do,
                                                  di, scale)
    rq = fa.flash_attention_bwd_dq_reference(q, k, v, sq, skv, lse, do, di,
                                             scale)
    bq, bk, bv = fa.backward_error_bounds(q, k, v, sq, skv, lse, do, di,
                                          scale)
    err_kv = max(bwd_check(torch, dk, rk, bk, kind, f"{what} dK"),
                 bwd_check(torch, dv, rv, bv, kind, f"{what} dV"))
    err_q = bwd_check(torch, dq, rq, bq, kind, f"{what} dQ")
    return err_kv, err_q


def phase_small_attention_bwd(fa, torch):
    """Phase 14: the backward kernels against their plain versions, the
    forward's lse against a masked logsumexp, and FlashAttention's
    gradients against autograd of the plain forward, on the card."""
    g = torch.Generator(device="cuda").manual_seed(14)
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        report = []
        for b, h, s, d in BWD_SHAPES:
            q, k, v, seg = attention_inputs(torch, g, b, h, s, d, dtype)
            do = torch.randn((b, h, s, d), generator=g,
                             device="cuda").to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention_forward(q, k, v, seg, seg, scale,
                                                  with_lse=True)
            torch.cuda.synchronize()
            logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                  k.float()) * scale
            same = (seg[:, :, None] == seg[:, None, :])[:, None]
            want = torch.logsumexp(logits.masked_fill(~same, -float("inf")),
                                   dim=-1)
            lse_err = float((lse - want).abs().max())
            if not bool(torch.isfinite(lse).all()) or lse_err > LSE_TOL:
                fail(f"flash_attention lse {kind} S={s}: max error "
                     f"{lse_err} > {LSE_TOL}")
            del logits, same, want
            # the backward kernels on the plain forward's lse and di
            ref_out, ref_lse = fa.flash_attention_reference(
                q, k, v, seg, seg, scale, with_lse=True)
            di = (ref_out.float() * do.float()).sum(dim=-1)
            err_kv, err_q = check_bwd_kernels(
                torch, fa, q, k, v, seg, seg, ref_lse, do, di, scale, kind,
                f"flash_attention_bwd {kind} S={s} D={d}")
            # FlashAttention (all three kernels) against autograd of the
            # plain forward
            grads = []
            for fn in (fa.flash_attention, fa.flash_attention_reference):
                t = [x.clone().requires_grad_(True) for x in (q, k, v)]
                fn(*t, seg, seg, scale).backward(do)
                grads.append([x.grad.float() for x in t])
            # a gradient that is exactly 0 (dQ and dK at S=1, where the one
            # weight is constant) is held to the largest one's norm
            norms = [float(r.norm()) for r in grads[1]]
            rel = max(float((a - r).norm()) / (n if n > 0 else max(norms))
                      for a, r, n in zip(*grads, norms))
            if rel > APPLY_TOL[kind]:
                fail(f"FlashAttention {kind} S={s}: gradient relative norm "
                     f"error {rel} > {APPLY_TOL[kind]}")
            report.append(f"S={s} B={b} H={h} D={d}: lse {lse_err:.3g}, "
                          f"dK/dV {err_kv:.3g}, dQ {err_q:.3g}, autograd "
                          f"rel {rel:.3g}")
            del q, k, v, seg, do, out, lse, ref_out, ref_lse, di, grads
        log(f"kernel check flash_attention_bwd_dkv/_dq {kind} (random "
            f"lengths, an all-pad row, a one-token row; max_abs_err, "
            f"within {ATTN_BWD_TOL[kind][0]:.3g} x (sum|a||b| + "
            f"{ATTN_BWD_TOL[kind][1]} |plain|)), "
            f"lse vs logsumexp (tol {LSE_TOL}), FlashAttention vs autograd "
            f"of the plain forward (tol {APPLY_TOL[kind]:.3g}): "
            + "; ".join(report))
        # other segment layouts: the kernels on the plain forward's lse
        report = []
        for pattern in SEG_PATTERNS:
            errs = [0.0, 0.0]
            for b, h, s, d in BWD_SHAPES:
                q, k, v, seg = attention_inputs(torch, g, b, h, s, d, dtype)
                sq, skv = segment_pattern(torch, g, seg, pattern)
                do = torch.randn((b, h, s, d), generator=g,
                                 device="cuda").to(dtype)
                ref_out, ref_lse = fa.flash_attention_reference(
                    q, k, v, sq, skv, d ** -0.5, with_lse=True)
                di = (ref_out.float() * do.float()).sum(dim=-1)
                errs = [max(a, e) for a, e in zip(errs, check_bwd_kernels(
                    torch, fa, q, k, v, sq, skv, ref_lse, do, di, d ** -0.5,
                    kind, f"flash_attention_bwd {kind} {pattern} S={s} "
                          f"D={d}"))]
                del q, k, v, seg, sq, skv, do, ref_out, ref_lse, di
            report.append(f"{pattern}: dK/dV {errs[0]:.3g}, dQ {errs[1]:.3g}")
        log(f"kernel check flash_attention_bwd_dkv/_dq {kind}, other segment "
            f"layouts (S {', '.join(str(x[2]) for x in BWD_SHAPES)}; "
            f"max_abs_err within the same tolerance): " + "; ".join(report))
    torch.cuda.empty_cache()


# phase 14's shapes (B, H, S, D): the trainer's buckets, the ragged edges
# of the kernels' 16-, 32- and 64-row tiles, and each head dim
BWD_SHAPES = ((8, 12, 1, 32), (8, 12, 8, 16), (8, 12, 16, 32),
              (8, 12, 32, 32), (8, 12, 33, 32), (8, 12, 64, 64),
              (8, 12, 65, 32), (8, 12, 100, 32), (8, 12, 128, 32),
              (8, 12, 256, 32), (24, 12, 512, 32), (4, 4, 200, 64))
SEG_PATTERNS = ("packed", "random", "kv_differs", "no_key")


def segment_pattern(torch, g, seg, pattern):
    """(seg_q, seg_kv) [B, S] int32 from the real-then-pad ``seg``:
    "packed" three segments a row end to end (ids 1, 2, 3) before the
    pads; "random" ids 0-4 a token in no order; "kv_differs" random ids,
    row 0's keys drawn apart from its queries; "no_key" random ids, row
    0's keys in a segment none of its queries has (lse -inf, every p 0)."""
    b, s = seg.shape
    if pattern == "packed":
        cuts = torch.randint(0, s + 1, (b, 2), generator=g,
                             device="cuda").sort(dim=1).values
        pos = torch.arange(s, device="cuda")[None, :]
        ids = (1 + (pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int())
        out = (ids * seg).int().contiguous()
        return out, out
    sq = torch.randint(0, 5, (b, s), generator=g, device="cuda",
                       dtype=torch.int32)
    skv = sq.clone()
    if pattern == "kv_differs":
        skv[0] = torch.randint(0, 5, (s,), generator=g, device="cuda",
                               dtype=torch.int32)
    elif pattern == "no_key":
        skv[0] = 7
    return sq, skv


def time_attention_bwd(torch, F, fa, cap, card, what) -> dict:
    """Both backward kernels on captured layer-0 inputs ``cap`` = (q, k, v,
    seg_q, seg_kv, scale, dO): checked against their plain versions, timed
    beside them, beside scaled_dot_product_attention's backward with the
    boolean mask (timed only), their bounds and the exponential floor;
    then the forward kernel on the same inputs, likewise beside its plain
    version, the library's forward and its bound."""
    from rag_foundation_tpu_torch.utils import roofline
    q, k, v, sq, skv, scale, do = cap
    b, h, s, d = q.shape
    out, lse = fa.flash_attention_forward(q, k, v, sq, skv, scale,
                                          with_lse=True)
    di = (out.float() * do.float()).sum(dim=-1)
    err_kv, err_q = check_bwd_kernels(torch, fa, q, k, v, sq, skv, lse, do,
                                      di, scale, "bf16", what)
    args = (q, k, v, sq, skv, lse, do, di, scale)
    res = {}
    mask = (sq[:, :, None] == skv[:, None, :])[:, None]
    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                          scale=scale)
    empty = roofline.empty_block_share(sq, skv)
    for name, kern, plain, wrt, outputs, ops, err in (
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_reference, (kl, vl), 2, 8, err_kv),
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dq_reference, (ql,), 1, 6, err_q)):
        ms = cuda_ms(lambda: kern(*args), reps=20)
        plain_ms = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            sdpa, wrt, do, retain_graph=True), reps=20)
        bound_ms, bound_by, c = roofline.attention_bwd_bound(
            sq, skv, h, d, 2, outputs, ops)
        exp_ms = roofline.exp_floor_ms(c["pairs"], h)
        log(f"{name} bf16 {what}, B={b} H={h} S={s} D={d}, {c['pairs']} of "
            f"{c['dense_pairs']} pairs share a segment, {empty:.1%} of the "
            f"16x16 blocks hold none: max_abs_err={err:.3g}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention backward (bool mask, grad of "
            f"{'k, v' if outputs == 2 else 'q'}) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; dense S^2 operations "
            f"{ops * b * h * s * s * d / roofline.PEAK_OPS_S['bf16'] * 1e3:.4f}"
            f" ms), exponential floor {exp_ms:.4f} ms | {card}")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms, "exp_floor_ms": exp_ms,
                     "shape": {"B": b, "H": h, "S": s, "D": d, **c,
                               "empty_16x16_blocks": empty}}
    # the forward kernel on the same inputs, beside its plain version and
    # scaled_dot_product_attention's forward with the boolean mask
    with torch.no_grad():
        fout = fa.flash_attention(q, k, v, sq, skv, scale)
        fref = fa.flash_attention_reference(q, k, v, sq, skv, scale)
        ferr, ftol = check_attention(torch, fout, fref, v, "bf16",
                                     f"flash_attention {what}")
        del fout, fref
        fms = cuda_ms(lambda: fa.flash_attention(q, k, v, sq, skv, scale),
                      reps=20)
        fplain = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, sq, skv, scale), reps=2, warmup=1)
        flib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), reps=20)
    fbound, fby, fc = roofline.attention_bound(sq, skv, h, d, 2)
    log(f"flash_attention (forward) bf16 {what}, B={b} H={h} S={s} D={d}: "
        f"max_abs_err={ferr:.3g} (tol {ftol:.3g}); kernel {fms:.4f} ms, "
        f"plain {fplain:.3f} ms, scaled_dot_product_attention (bool mask) "
        f"{flib:.4f} ms, bound {fbound:.4f} ms ({fby}) | {card}")
    res["flash_attention"] = {"max_abs_err": ferr, "ms": fms,
                              "plain_ms": fplain, "bound_ms": fbound,
                              "bound_by": fby, "library_ms": flib}
    del out, lse, di, args, mask, ql, kl, vl, sdpa
    return res


def capture_calls(fa, torch, calls: tuple[int, ...]):
    """An attention function that runs flash_attention and keeps the
    inputs and the output's gradient of its listed calls (0-based):
    ``.captured[call]`` = (q, k, v, seg_q, seg_kv, scale, dO)."""
    seen = [0]

    def attention(q, k, v, sq, skv, scale):
        out = fa.flash_attention(q, k, v, sq, skv, scale)
        if seen[0] in calls:
            keep = [x.detach().clone() for x in (q, k, v, sq, skv)]
            call = seen[0]

            def grab(grad):
                attention.captured[call] = (*keep, scale,
                                            grad.contiguous().clone())

            out.register_hook(grab)
        seen[0] += 1
        return out

    attention.captured = {}
    return attention


# kernel-name fragments of the training step's device time, in the order
# they are matched (the rest is elementwise passes and reductions)
STEP_PARTS = (("attention kernels", ("flash_fwd", "flash_bwd")),
              ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass")),
              ("layernorm", ("layer_norm", "gammabeta")),
              ("embedding", ("embedding", "index")),
              ("optimizer (foreach AdamW)", ("multi_tensor", "adam")))
# the decoder's step: the f32 backward products (cuBLAS's f32 GEMMs name
# their types, "sgemm" or "f32f32_f32f32") before the other products
DECODER_STEP_PARTS = (
    ("f32 products (backward)", ("sgemm", "f32f32_f32f32", "gemm_f32")),
    ("other products (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "gemv")),
    ("softmax", ("softmax",)),
    ("layernorm", ("layer_norm", "gammabeta")),
    ("embedding", ("embedding", "index")),
    ("optimizer (foreach AdamW)", ("multi_tensor", "adam")))


def profile_train_steps(torch, step, params, inputs, steps, card, what,
                        parts=STEP_PARTS) -> float | None:
    """Device time of ``steps`` training steps by kernel, from
    torch.profiler: the ``parts`` (name, kernel-name fragments), the top
    kernels and the device's busy share of the window (kernel time over
    wall time; the profiler's own cost is in the wall time). Returns the
    device time a step in ms, None where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    step(params, *inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(params, *inputs)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation ("Optimizer.step#AdamW.step") also
    # has device time, that of the kernels under it
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total == 0:
        log(f"{what} profile: the profiler saw no device time (not "
            f"measured) | {card}")
        return None
    by_part = {name: 0.0 for name, _ in parts}
    by_part["other (elementwise, reductions)"] = 0.0
    for e in kernels:
        key = e.key.lower()
        name = next((n for n, frags in parts
                     if any(f in key for f in frags)),
                    "other (elementwise, reductions)")
        by_part[name] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"{what} profile ({steps} steps under torch.profiler): device "
        f"time {total / steps:.2f} ms a step, wall {wall_ms / steps:.2f} ms "
        f"a step, device busy {total / wall_ms:.1%}; "
        + ", ".join(f"{n} {t / steps:.2f} ms ({t / total:.1%})"
                    for n, t in by_part.items())
        + "; top kernels: "
        + "; ".join(f"{e.key[:60]} x{e.count // steps} "
                    f"{e.self_device_time_total / 1e3 / steps:.3f} ms"
                    for e in top) + f" | {card}")
    return total / steps


def build_corpus(args, out_dir: str) -> str:
    """The training corpus of phases 15 and 20: the recipe's own
    ``scripts/build_text_corpus.py`` over the card machine's installed
    packages, ``--corpus-passages`` passages. Returns its path."""
    corpus = str(Path(out_dir) / "corpus.jsonl")
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "build_text_corpus.py"),
         "--out", corpus, "--max-passages", str(args.corpus_passages)],
        capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        fail(f"build_text_corpus.py failed: {built.stderr[-2000:]}")
    log(f"corpus: scripts/build_text_corpus.py --max-passages "
        f"{args.corpus_passages} in {time.perf_counter() - t0:.1f} s: "
        f"{built.stderr.strip().splitlines()[-1]}")
    return corpus


def train_phases(args, card, rng, sampled, corpus, mods
                 ) -> tuple[list[dict], dict]:
    """Phase 15: MiniLM-L6 training at full width through the port's
    trainer (ICT on a corpus built by the recipe's own tool), serving from
    the checkpoint it saved, a few steps at d_len 512, the kernel path's
    gradients against the plain attention's, and the two backward kernels
    and the forward timed on the step's own layer-0 inputs at S 32, 128
    and 512. Returns the backward kernels' two entries of the ``kernels``
    line and the forward's numbers at those shapes (``at_train_s{S}``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.models import optim
    from rag_foundation_tpu_torch.models.tokenizer import Tokenizer
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    from rag_foundation_tpu_torch.tools import train_encoder
    Engine, EngineConfig = mods
    tmp = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-train-")
    chunks = train_encoder.load_chunks(corpus)
    log(f"the corpus holds {len(chunks)} chunks of 25-100 words")

    # -- the trainer, ICT mode, the recipe's shapes --------------------------
    ckpt = str(Path(tmp) / "minilm_ict_port.npz")
    targs = train_encoder.parse_args([
        "--corpus", corpus, "--steps", str(args.train_steps), "--batch",
        str(TRAIN_BATCH), "--q-len", "32", "--d-len", "128", "--lr", "3e-4",
        "--temperature", "0.05", "--seed", str(args.seed), "--out", ckpt,
        "--device", "cuda"])
    counters = (fa.LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES)
    for c in counters:
        c.reset()                                 # counts: this path only
    tally = ShapeTally(fa).start()
    torch.cuda.synchronize()
    run = train_encoder.train_ict(targs, log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = [c.count for c in counters]        # read just after the path
    tally.stop()
    log(f"flash_attention launches on the training path by shape: "
        f"{tally.text()} | {card}")
    losses, summary = run["losses"], run["summary"]
    steps, secs = targs.steps, run["train_s"]
    tenth = max(1, steps // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    log(f"train_encoder ICT (MiniLM-L6: hidden 384, 6 layers, 12 heads, "
        f"ffn 1536, bf16; batch {TRAIN_BATCH}, q_len 32, d_len 128, "
        f"symmetric InfoNCE t=0.05, adamw lr 3e-4 warmup-cosine, clip 1.0, "
        f"seed {args.seed}): {steps} steps in {secs:.2f} s = "
        f"{secs / steps * 1e3:.2f} ms/step = {steps * TRAIN_BATCH / secs:,.0f}"
        f" pairs/s (batch draws, host loop and logging included); loss "
        f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, mean of the "
        f"first tenth {first:.4f}, of the last {last:.4f}; launches on the "
        f"training path: flash_attention {launches[0]}, "
        f"flash_attention_bwd_dkv {launches[1]}, flash_attention_bwd_dq "
        f"{launches[2]} | {card}")
    if not np.isfinite(losses).all():
        fail(f"non-finite loss at step {int(np.argmin(np.isfinite(losses)))}")
    if not last < first:
        fail(f"the loss did not fall: first tenth {first}, last {last}")
    if min(launches) == 0:
        fail(f"the training path launched an attention kernel no time: "
             f"{launches}")
    log(f"held-out recall (eval_n {summary['eval_n']} chunks, keyword "
        f"queries; printed, no floor): minilm(ICT) recall@1 "
        f"{summary['minilm']['recall@1']:.4f} recall@10 "
        f"{summary['minilm']['recall@10']:.4f}; hash-fnv-v2 recall@1 "
        f"{summary['hash']['recall@1']:.4f} recall@10 "
        f"{summary['hash']['recall@10']:.4f} | {card}")
    trained, cfg = run["encoder"].params, run["encoder"].cfg
    del run

    # -- train -> checkpoint -> serve ------------------------------------------
    engine = Engine(EngineConfig(dim=384, encoder="minilm",
                                 encoder_ckpt=ckpt, chunk_tokens=76,
                                 chunk_overlap=16, device="cuda"))
    loaded = tenc._leaves(engine.encoder.params)
    for key, t in tenc._leaves(trained).items():
        if not torch.equal(loaded[key], t.detach()):
            fail(f"the served encoder's {key} differs from the trained one")
    key = "stores/chip-smoke-trained"
    engine.create_store(key)
    n0 = fa.LAUNCHES.count
    t0 = time.perf_counter()
    for i in range(args.docs):
        engine.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                               fact_doc(i))
    ingest_s = time.perf_counter() - t0
    right = 0
    for i in sampled:
        hits = engine.search([key], fact_query(i), k=10)
        if len(hits) != 10 or not all(np.isfinite(h.score) for h in hits):
            fail(f"trained encoder: search for project {i} gave {hits}")
        right += hits[0].doc_id == f"doc-{i}"
    log(f"served from the trained checkpoint (Engine encoder_ckpt, every "
        f"parameter equal to the trained one): ingested {args.docs} fact "
        f"documents in {ingest_s:.2f} s, {len(sampled)} searches of 10 hits;"
        f" right top hit {right}/{len(sampled)} (printed: the corpus never "
        f"saw these names); flash_attention launches "
        f"{fa.LAUNCHES.count - n0} | {card}")
    del engine, loaded

    # -- one step's gradients: kernel path vs plain attention -----------------
    tok = Tokenizer(vocab_size=cfg.vocab_size)
    qrng = np.random.default_rng(args.seed + 3)
    batch = chunks[:TRAIN_BATCH]
    qb = torch.as_tensor(tok.encode_batch(
        [train_encoder.keyword_query(qrng, c) for c in batch], 32),
        device="cuda")
    db = torch.as_tensor(tok.encode_batch(batch, 128), device="cuda")
    leaves = list(tenc._leaves(trained).values())
    grads = {}
    # layer 0 of the q side (the first call) and of the d side
    cap = capture_calls(fa, torch, (0, cfg.layers))
    for name, attn in (("kernel", cap), ("plain",
                                          fa.flash_attention_reference)):
        loss = tenc.contrastive_loss(trained, qb, db, cfg, 0.05, True,
                                     attention=attn)
        grads[name] = torch.autograd.grad(loss, leaves)
    worst_cos, worst_rel = 1.0, 0.0
    for a, r in zip(grads["kernel"], grads["plain"]):
        a, r = a.double().ravel(), r.double().ravel()
        if not bool(torch.isfinite(a).all()):
            fail("kernel-path gradient not finite")
        if float(r.norm()) == 0.0:
            continue
        worst_cos = min(worst_cos, float(a @ r / (a.norm() * r.norm())))
        worst_rel = max(worst_rel, float((a - r).norm() / r.norm()))
    log(f"one step's gradients (batch {TRAIN_BATCH}, q_len 32, d_len 128), "
        f"attention=flash_attention vs flash_attention_reference, "
        f"{len(leaves)} leaves: worst cosine {worst_cos:.6f} (floor "
        f"{GRAD_COS_MIN}), worst relative norm error {worst_rel:.4g} | "
        f"{card}")
    if worst_cos < GRAD_COS_MIN:
        fail(f"gradient cosine {worst_cos} < {GRAD_COS_MIN}")
    del grads
    profile_train_steps(
        torch, tenc.make_train_step(cfg, optim.adamw(3e-4), max_grad_norm=1.0,
                                    temperature=0.05, symmetric=True),
        trained, (qb, db), 3, card,
        f"training step (batch {qb.shape[0]}, q_len {qb.shape[1]}, d_len "
        f"{db.shape[1]})")

    # -- d_len 512: the shape at which JAX's TPU path takes the kernels -------
    cfg512 = tenc.EncoderConfig(max_len=512)
    params512 = tenc.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg512)
    drng = np.random.default_rng(args.seed + 15)
    docs = [long_doc(drng, 380) for _ in range(TRAIN_BATCH)]
    d512 = torch.as_tensor(tok.encode_batch(docs, 512), device="cuda")
    q512 = torch.as_tensor(tok.encode_batch(
        [train_encoder.keyword_query(drng, t) for t in docs], 32),
        device="cuda")
    lens = (d512 != 0).sum(dim=1)
    step = tenc.make_train_step(cfg512, optim.adamw(3e-4), max_grad_norm=1.0,
                                temperature=0.05, symmetric=True)
    step(params512, q512, d512)                  # warm-up: allocator, build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n512 = 4
    t0 = time.perf_counter()
    l512 = [step(params512, q512, d512) for _ in range(n512)]
    torch.cuda.synchronize()
    ms512 = (time.perf_counter() - t0) / n512 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(bool(torch.isfinite(x)) for x in l512):
        fail("non-finite loss at d_len 512")
    log(f"train step at d_len 512 (seeded MiniLM-L6 max_len 512, batch "
        f"{TRAIN_BATCH} long documents of {int(lens.min())}-"
        f"{int(lens.max())} ids, q_len 32): {ms512:.2f} ms/step = "
        f"{TRAIN_BATCH / ms512 * 1e3:,.0f} pairs/s; loss "
        f"{float(l512[0]):.4f} -> {float(l512[-1]):.4f}; peak device memory "
        f"{peak:.2f} GiB | {card}")

    # -- the backward kernels on the step's own layer-0 inputs ----------------
    cap512 = capture_calls(fa, torch, (cfg512.layers,))
    loss = tenc.contrastive_loss(params512, q512, d512, cfg512, 0.05, True,
                                 attention=cap512)
    torch.autograd.grad(loss, list(tenc._leaves(params512).values()))
    del loss, params512, step
    layer0 = {32: cap.captured[0], 128: cap.captured[cfg.layers],
              512: cap512.captured[cfg512.layers]}
    lengths = {s: [int(n) for n in (c[3] != 0).sum(dim=1).tolist()]
               for s, c in layer0.items()}
    for s, ns in lengths.items():
        log(f"layer-0 rows at S={s}: real tokens {min(ns)}-{max(ns)}, "
            f"median {sorted(ns)[len(ns) // 2]}, {ns.count(s)} of "
            f"{len(ns)} rows full")
    if args.lengths_out:
        Path(args.lengths_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.lengths_out).write_text(json.dumps(lengths))
    at = {s: time_attention_bwd(torch, F, fa, c, card, f"{step_name}, layer "
                                f"0 of the {'q' if s == 32 else 'd'} side")
          for (s, c), step_name in zip(layer0.items(), (
              "training step", "training step", "d_len 512 step"))}
    del cap, cap512, layer0
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    entries = []
    for name, line, launched in (
            ("flash_attention_bwd_dkv", 1121, launches[1]),
            ("flash_attention_bwd_dq", 1456, launches[2])):
        main = at[128][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "rag_foundation_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py"
                        f":{line} (reached from rag_foundation_tpu/models/"
                        f"encoder.py:187 make_train_step)",
            "launches": launched, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "exp_floor_ms": main["exp_floor_ms"], "dtype": "bf16",
            "shape": main["shape"],
            **{f"at_s{s}": at[s][name] for s in (32, 512)}})
    return entries, {f"at_train_s{s}": at[s]["flash_attention"]
                     for s in (32, 128, 512)}


def greedy_answer(gen, tdec, torch, np, question, evidences,
                  device="cuda"):
    """The ids ``TextGenerator.stream`` emits for one question, by its own
    loop in process on ``device`` (the card unless asked): (prompt ids,
    the prefill's f32 logits, the vocabulary bias, the answer ids up to
    and including EOS)."""
    cfg = gen.cfg
    ids = gen.tokenizer.encode_prompt(question, evidences, cfg.prefix_len)
    bias_np = gen.vocab_bias(ids)
    padded = torch.full((1, cfg.prefix_len), tdec.PAD_ID, device=device)
    padded[0, :len(ids)] = torch.tensor(ids)
    budget = min(cfg.ans_len, cfg.max_len - len(ids) - 1)
    with torch.inference_mode():
        cache, logits = tdec.prefill(gen.params, padded,
                                     torch.tensor([len(ids)], device=device),
                                     cfg)
        out = [int(np.argmax(logits[0].cpu().numpy() + bias_np))]
        pos, bias = len(ids), torch.as_tensor(bias_np, device=device)
        while out[-1] != tdec.EOS_ID and len(out) < budget \
                and len(ids) + len(out) + gen.block <= cfg.max_len:
            blk, cache, pos = tdec.decode_block(
                gen.params, cache, torch.tensor([out[-1]], device=device),
                pos, cfg=cfg, k_steps=gen.block, bias=bias)
            out += blk[0].tolist()[: budget - len(out)]
    if tdec.EOS_ID in out:
        out = out[: out.index(tdec.EOS_ID) + 1]
    return ids, logits[0], bias_np, out


def generator_phase(args, card, sampled, mods) -> int:
    """Phase 16: the generative chat path at full width. Returns the
    flash-attention forward's launches on it."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.models import decoder as tdec
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    from rag_foundation_tpu_torch.ops import ivf_scan
    from rag_foundation_tpu_torch.utils import roofline
    from torch.profiler import ProfilerActivity, profile
    Engine, EngineConfig, EngineRpcServer, RemoteEngine = mods
    enc_ckpt = ROOT / "checkpoints" / "minilm_ict.npz"
    dec_ckpt = ROOT / "checkpoints" / "decoder_distill.npz"
    for ckpt in (enc_ckpt, dec_ckpt):
        if not ckpt.exists():
            fail(f"{ckpt} not found")
    t_phase = time.perf_counter()
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-chat-")
    sock = str(Path(data_dir) / "engine.sock")
    key = "stores/chip-smoke-chat"
    torch.cuda.reset_peak_memory_stats()
    # phase 13's MiniLM store (IVF-Flat, 16 lists, all probed, capture 10)
    engine = Engine(EngineConfig(
        dim=384, encoder="minilm", encoder_ckpt=str(enc_ckpt),
        generator_ckpt=str(dec_ckpt), gen_block=16, chunk_tokens=76,
        chunk_overlap=16, index_mode="ivf_flat", nlist=16, nprobe=16,
        ivf_p=10, build_threshold=256, batch_window_s=0.02,
        data_dir=data_dir, device="cuda"))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=16)
    questions = [(i, fact_query(i)) for i in sampled[:CHAT_QUESTIONS]]
    try:
        fa.LAUNCHES.reset()                      # counts: this path only
        ivf_scan.LAUNCHES.reset()
        info = remote.prewarm_generator()
        remote.create_store(key)
        for i in range(args.docs):
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        search_launches, ttfd, total, answers, evidences = 0, [], [], {}, {}
        for i, q in questions:
            n0 = fa.LAUNCHES.count
            hits = remote.search([key], q, k=8)
            search_launches += fa.LAUNCHES.count - n0
            evidences[q] = [h.text for h in hits]
            deltas = []
            t0 = time.perf_counter()
            # RemoteEngine.generate_stream returns only on the done frame
            # (it raises on an error frame or a closed connection)
            for delta in remote.generate_stream(q, evidences[q]):
                if not deltas:
                    ttfd.append((time.perf_counter() - t0) * 1e3)
                deltas.append(delta)
            total.append((time.perf_counter() - t0) * 1e3)
            if not deltas:
                ttfd.append(total[-1])     # EOS first: the done frame
            answers[q] = "".join(deltas)
        chat_launches = fa.LAUNCHES.count      # read just after the path
        scan_launches = ivf_scan.LAUNCHES.count
        log(f"generative chat over RPC (decoder_distill.npz: "
            f"{tdec.checkpoint_meta(str(dec_ckpt))}; gen_block 16; MiniLM "
            f"store of {args.docs} fact documents): "
            f"prewarm_generator {info}; {len(questions)} questions, k=8 "
            f"evidences each: flash_attention launches {chat_launches} "
            f"({search_launches} in the searches), ivf_list_scan launches "
            f"{scan_launches} | {card}")
        if search_launches == 0:
            fail("the chat path's searches never launched flash_attention")

        # every answer is grounded: the ids the stream emitted (the
        # in-process loop's, which decode to the text served over RPC) all
        # lie in prompt + function words + EOS. Re-encoding the text can
        # merge pieces emitted apart ("21" "##1" "##d" -> "21" "##1d") into
        # a piece the prompt lacks: counted and printed, not a fault
        gen = engine._text_generator()
        tok = gen.tokenizer
        replay, n_tokens, merged = {}, 0, []
        for _, q in questions:
            replay[q] = greedy_answer(gen, tdec, torch, np, q, evidences[q])
            ids, _, _, out = replay[q]
            n_tokens += len(out)
            if tok.decode(out) != answers[q]:
                fail(f"answer over RPC {answers[q]!r} != in process "
                     f"{tok.decode(out)!r}")
            allowed = set(ids) | gen._fn_ids | {tdec.EOS_ID}
            bad = [t for t in out if t not in allowed]
            if bad:
                fail(f"answer {answers[q]!r} to {q!r} emitted ids outside "
                     f"the prompt, the function words and EOS: {bad}")
            if any(t not in allowed for t in tok.encode_text(answers[q])):
                merged.append((answers[q], [tok._id2piece[t] for t in out]))
        log(f"answers: {sum(bool(a) for a in answers.values())} of "
            f"{len(answers)} non-empty, every one ends with its done frame, "
            f"equals the in-process loop's and emits only ids of its prompt,"
            f" the function words and EOS; {n_tokens} answer tokens (EOS "
            f"included), e.g. {[answers[q] for _, q in questions[:4]]}; "
            f"{len(merged)} re-encode to a merged piece outside that set: "
            f"{merged}")

        # card bf16 against the port's CPU path in f32, teacher-forced on
        # the card's ids, for the two longest answers
        p_cpu, cfg, _ = tdec.load_decoder(str(dec_ckpt), device="cpu")
        p32 = tenc._map(p_cpu, lambda _, t: t.float())
        c32 = cfg._replace(dtype="float32")
        longest = sorted(questions, key=lambda iq: -len(replay[iq[1]][3]))
        worst_pre = worst_all = 0.0
        checked = below = 0
        for _, q in longest[:2]:
            ids, card_logits, bias_np, out = replay[q]
            seq = torch.tensor([ids + out[:-1]])
            with torch.inference_mode():
                f32 = tdec.forward(p32, seq, c32)[0, len(ids) - 1:]
                b16 = tdec.forward(gen.params, seq.to("cuda"), cfg)[
                    0, len(ids) - 1:].cpu()
            pre = float((card_logits.cpu() - f32[0]).abs().max())
            worst_pre = max(worst_pre, pre)
            worst_all = max(worst_all, float((b16 - f32).abs().max()))
            if pre > DECODER_LOGIT_TOL:
                fail(f"prefill logits: card vs CPU f32 {pre} > "
                     f"{DECODER_LOGIT_TOL} for {q!r}")
            for j, want in enumerate(out):
                row = f32[j].numpy() + bias_np
                top2 = np.sort(row)[-2:]
                if top2[1] - top2[0] <= 2 * DECODER_LOGIT_TOL:
                    below += 1
                    continue
                checked += 1
                if int(np.argmax(row)) != want:
                    fail(f"step {j} of {q!r}: card chose {want}, the CPU "
                         f"f32 path {int(np.argmax(row))} (margin "
                         f"{top2[1] - top2[0]:.3f})")
        log(f"card bf16 vs the port's CPU path in f32 (2 questions, "
            f"teacher-forced on the card's ids): prefill logits max abs "
            f"diff {worst_pre:.4f} (tol {DECODER_LOGIT_TOL}), card forward "
            f"on the same ids {worst_all:.4f}; argmax equal on {checked} "
            f"steps above a margin of {2 * DECODER_LOGIT_TOL}, {below} below "
            f"it not compared | {card}")

        # four concurrent streams on distinct questions
        conc = [q for _, q in questions[:4]]
        got = [None] * len(conc)

        def run(j):
            q = conc[j]
            got[j] = "".join(remote.generate_stream(q, evidences[q]))

        threads = [threading.Thread(target=run, args=(j,))
                   for j in range(len(conc))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        conc_s = time.perf_counter() - t0
        if got != [answers[q] for q in conc]:
            fail(f"concurrent streams {got} != sequential "
                 f"{[answers[q] for q in conc]}")
        log(f"4 concurrent RPC streams on distinct questions: the "
            f"sequential texts, in {conc_s * 1e3:.1f} ms | {card}")

        # times: prefill, decode_block, launches, busy share, bound
        ids = replay[questions[0][1]][0]
        padded = torch.full((1, cfg.prefix_len), tdec.PAD_ID, device="cuda")
        padded[0, :len(ids)] = torch.tensor(ids)
        length = torch.tensor([len(ids)], device="cuda")
        reps = 20
        with torch.inference_mode():
            cache, logits = tdec.prefill(gen.params, padded, length, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                cache, logits = tdec.prefill(gen.params, padded, length, cfg)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3 / reps
            prefill_dev = cuda_ms(lambda: tdec.prefill(gen.params, padded,
                                                       length, cfg), reps)
            first = torch.argmax(logits, -1)
            block = gen.block

            def one_block():
                blk, _, _ = tdec.decode_block(gen.params, cache, first,
                                              len(ids), cfg=cfg,
                                              k_steps=block)
                return blk.cpu()      # the stream reads a block's ids once

            one_block()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                one_block()
            block_ms = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one_block()
                torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
        copies = sum(e.count for e in ops if e.key.startswith("Mem"))
        kernels = sum(e.count for e in ops) - copies
        device_ms = sum(e.self_device_time_total for e in ops) / 1e3
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:5]
        token_ms = block_ms / block
        if kernels == 0:
            log(f"torch.profiler saw no device time in a decode block: "
                f"launches a token and the busy share not measured | {card}")
        bound_ms, bound_by, c = roofline.decode_bound(cfg)
        pre_bound, pre_by, _ = roofline.prefill_bound(cfg, len(ids))
        log(f"prefill B=1, P={cfg.prefix_len} ({len(ids)} real tokens): "
            f"{prefill_ms:.3f} ms a call (host clock, synchronized, mean of "
            f"{reps}), {prefill_dev:.3f} ms queued behind a spin (CUDA "
            f"events); bound {pre_bound:.4f} ms ({pre_by}) | {card}")
        log(f"decode_block of {block} steps (B=1, bias on): {block_ms:.3f} ms "
            f"a block = {token_ms:.4f} ms a token = {1e3 / token_ms:,.1f} "
            f"tokens/s (host clock, ids read back, mean of {reps}); one "
            f"block under torch.profiler: {kernels} kernels + {copies} copies"
            f" = {(kernels + copies) / block:.1f} device launches a token, "
            f"device time {device_ms:.3f} ms = {device_ms / block_ms:.1%} "
            f"busy of the unprofiled block; top: "
            + "; ".join(f"{e.key[:48]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in top) + f" | {card}")
        log(f"decode bytes bound a token: {c['bytes']:,} bytes "
            f"({c['weight_bytes']:,} weights + {c['cache_read_bytes']:,} "
            f"K/V cache of all {cfg.max_len} positions + the new slot) / "
            f"{roofline.HBM_BYTES_S:.3g} B/s = {bound_ms * 1e3:.2f} us "
            f"({bound_by}); measured {token_ms * 1e3:.1f} us a token = "
            f"{token_ms / bound_ms:.1f}x the bound, device time "
            f"{device_ms / block * 1e3:.1f} us a token = "
            f"{device_ms / block / bound_ms:.1f}x | {card}")
        log(f"chat over RPC ({len(questions)} questions): time to first "
            f"delta p50 {np.percentile(ttfd, 50):.2f} ms p99 "
            f"{np.percentile(ttfd, 99):.2f} ms; whole answer p50 "
            f"{np.percentile(total, 50):.2f} ms p99 "
            f"{np.percentile(total, 99):.2f} ms; answer tokens/s "
            f"{n_tokens / (sum(total) / 1e3):,.1f} ({n_tokens} tokens in "
            f"{sum(total):.1f} ms of answers); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:,.1f} MiB | {card}")
    finally:
        remote.close()
        server.shutdown()
    shutil.rmtree(data_dir, ignore_errors=True)
    del engine, server, remote, gen, cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return chat_launches


def decoder_grads(torch, tdec, tenc, params, cfg, tokens, mask):
    """One step's gradients of ``lm_loss`` on the card in the trained
    dtype and through the port's CPU path in f32 on the same parameters
    and batch: (worst cosine a leaf, worst relative norm error, seconds of
    the CPU pass). The key third of ``qkv_b`` is left out: its gradient is
    0 in exact arithmetic (a constant added to a row's scores leaves its
    softmax unchanged), so both sides hold rounding noise there."""
    leaves = tenc._leaves(params)
    card_g = torch.autograd.grad(
        tdec.lm_loss(params, tokens, mask, cfg), list(leaves.values()))
    p32 = tenc._map(params, lambda _, t: t.detach().float().cpu()
                    .requires_grad_(True))
    t0 = time.perf_counter()
    cpu_g = torch.autograd.grad(
        tdec.lm_loss(p32, tokens.cpu(), mask.cpu(),
                     cfg._replace(dtype="float32")),
        list(tenc._leaves(p32).values()))
    cpu_s = time.perf_counter() - t0
    h = cfg.hidden
    worst_cos, worst_rel = 1.0, 0.0
    for key, a, r in zip(leaves, card_g, cpu_g):
        a, r = a.double().cpu().ravel(), r.double().ravel()
        if not bool(torch.isfinite(a).all()):
            fail(f"phase 20: the card's gradient of {key} is not finite")
        if key.endswith("['qkv_b']"):
            a, r = torch.cat([a[:h], a[2 * h:]]), torch.cat([r[:h],
                                                             r[2 * h:]])
        if float(r.norm()) == 0.0:
            continue
        worst_cos = min(worst_cos, float(a @ r / (a.norm() * r.norm())))
        worst_rel = max(worst_rel, float((a - r).norm() / r.norm()))
    return worst_cos, worst_rel, cpu_s


def decoder_train_phase(args, card, corpus) -> None:
    """Phase 20: the generative decoder's trainer at full width
    (``tools.train_decoder.train``, the recipe of
    ``checkpoints/decoder_distill.npz`` cut in steps, triples and eval
    questions) on phase 15's corpus, the checkpoint it saved served by
    ``TextGenerator``, one step's gradients against the CPU's f32 path,
    and the step's time beside its bound, its busy share and memory."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.models import decoder as tdec
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.tools import train_decoder
    from rag_foundation_tpu_torch.utils import roofline
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-decoder-")
    ckpt = str(Path(tmp) / "decoder_port.npz")
    targs = train_decoder.parse_args([
        "--corpus", corpus, "--steps", str(args.decoder_steps),
        "--n-examples", str(args.decoder_triples), "--eval-n",
        str(args.decoder_eval), "--seed", str(args.seed), "--out", ckpt,
        "--device", "cuda"])
    recipe = train_decoder.parse_args(["--corpus", corpus])
    log(f"train_decoder, the recipe of decoder_distill.npz (vocab "
        f"{recipe.vocab_size}, hidden {recipe.hidden}, {recipe.layers} "
        f"layers, {recipe.heads} heads, ffn {recipe.ffn}, max_len "
        f"{recipe.max_len}, ans_len {recipe.ans_len}, batch {recipe.batch}, "
        f"lr {recipe.lr}, bf16) cut to {targs.steps} of {recipe.steps} "
        f"steps, {targs.n_examples} of {recipe.n_examples} triples, "
        f"{targs.eval_n} of {recipe.eval_n} eval questions")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = train_decoder.train(targs, log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params, cfg, summary = run["params"], run["cfg"], run["summary"]
    leaves = tenc._leaves(params)
    if cfg.vocab_size != 8192:
        fail(f"phase 20: the vocabulary has {cfg.vocab_size} pieces, not "
             f"8192 (the vocab sample is too small)")
    if tuple(cfg)[:7] != (8192, 384, 6, 6, 1536, 512, 96) \
            or cfg.dtype != "bfloat16":
        fail(f"phase 20: trained {cfg}, not decoder_distill.npz's config")
    off = [k for k, t in leaves.items() if t.device.type != "cuda"]
    if off:
        fail(f"phase 20: parameters off the card after training: {off}")
    # the vocabulary's JSON bytes are as long as its pieces
    with np.load(ckpt) as got, \
            np.load(ROOT / "checkpoints" / "decoder_distill.npz") as want:
        if set(got.files) != set(want.files) or any(
                got[k].shape != want[k].shape for k in want.files
                if k != "__vocab_json"):
            fail("phase 20: the checkpoint's keys or shapes differ from "
                 "decoder_distill.npz's")
    losses = run["losses"]
    steps, secs = targs.steps, run["seconds"]["train"]
    tenth = max(1, steps // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    if not np.isfinite(losses).all():
        fail(f"phase 20: non-finite loss at step "
             f"{int(np.argmin(np.isfinite(losses)))}")
    if not last < first:
        fail(f"phase 20: the loss did not fall: first tenth {first}, last "
             f"{last}")
    tokens, mask = run["tokens"], run["loss_mask"]
    batch = targs.batch
    real = float((tokens[:, :-1] != tdec.PAD_ID).sum(1).mean()) * batch
    answer = float(mask[:, 1:].sum(1).mean()) * batch
    positions = batch * (cfg.max_len - 1)
    host = run["seconds"]
    log(f"train_decoder on the card: {len(tokens)} training rows of "
        f"{summary['triples']} triples (vocab {host['vocab']:.1f} s, "
        f"triples {host['triples']:.1f} s, tokens {host['tokenize']:.2f} s "
        f"on the host), {run['n_params'] / 1e6:.2f}M parameters; {steps} "
        f"steps in {secs:.2f} s = {secs / steps * 1e3:.2f} ms/step (batch "
        f"draws, host loop, logging and the first step's set-up included); "
        f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}, mean of "
        f"the first tenth {first:.4f}, of the last {last:.4f}; peak device "
        f"memory {peak:.2f} GiB | {card}")

    # -- the checkpoint reloads and streams ----------------------------------
    loaded, lcfg, _ = tdec.load_decoder(ckpt, device="cuda")
    for key, t in tenc._leaves(loaded).items():
        if not torch.equal(t, leaves[key].detach()):
            fail(f"phase 20: the saved {key} differs from the trained one")
    gen = tdec.TextGenerator(ckpt, block=16, device="cuda")
    q = run["eval_triples"][0]
    texts = ["".join(gen.stream(q["q"], q["evs"])) for _ in range(2)]
    if texts[0] != texts[1]:
        fail(f"phase 20: two streams of one question differ: {texts}")
    log(f"the checkpoint reloads through load_decoder (every parameter "
        f"equal to the trained one, {lcfg}) and TextGenerator streams from "
        f"it: {q['q'][:60]!r} -> {texts[0][:60]!r} | {card}")
    log(f"eval through TextGenerator ({summary['n_answerable']} answerable, "
        f"{summary['n_refusal']} refusal questions, {host['eval']:.1f} s; "
        f"printed, no floor): answerable_f1 {summary['answerable_f1']}, "
        f"cloze_f1 {summary['cloze_f1']}, other_f1 {summary['other_f1']}, "
        f"refusal_acc {summary['refusal_acc']}, grounded_rate "
        f"{summary['grounded_rate']} | {card}")
    del loaded, gen

    # -- one step's gradients: the card's bf16 against the CPU's f32 ---------
    rows = torch.arange(batch, device="cuda") % len(tokens)
    tb = torch.as_tensor(tokens, device="cuda")[rows]
    mb = torch.as_tensor(mask, device="cuda")[rows]
    worst_cos, worst_rel, cpu_s = decoder_grads(torch, tdec, tenc, params,
                                                cfg, tb, mb)
    log(f"one step's gradients (the trained parameters, batch {batch} x "
        f"{cfg.max_len}), card bf16 vs the port's CPU path in f32 "
        f"({cpu_s:.1f} s there), {len(leaves)} leaves: worst cosine "
        f"{worst_cos:.6f} (floor {GRAD_COS_MIN}), worst relative norm error "
        f"{worst_rel:.4g} | {card}")
    if worst_cos < GRAD_COS_MIN:
        fail(f"phase 20: gradient cosine {worst_cos} < {GRAD_COS_MIN}")

    # -- the step's time, bound, busy share -----------------------------------
    step = run["step"]                 # the trainer's own step and optimizer
    step(params, tb, mb)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step(params, tb, mb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    bound_ms, bound_by, c = roofline.decoder_train_bound(cfg, batch)
    log(f"decoder train step (batch {batch} x {cfg.max_len - 1} positions, "
        f"one batch, host clock, synchronized, mean of {n}): {ms:.2f} ms = "
        f"{positions / ms * 1e3:,.0f} positions/s, {real / ms * 1e3:,.0f} "
        f"real tokens/s ({real / batch:.1f} a row), {answer / ms * 1e3:,.0f}"
        f" answer tokens/s; bound {bound_ms:.2f} ms ({bound_by}: "
        f"{c['forward_operations'] / 1e12:.3f} T forward operations at the "
        f"bf16 peak, {c['backward_operations'] / 1e12:.3f} T backward at the"
        f" f32 peak; {c['bytes'] / 1e9:.2f} GB of f32 logits and scores) = "
        f"{bound_ms / ms:.1%} of it | {card}")
    device_ms = profile_train_steps(
        torch, step, params, (tb, mb), 3, card,
        f"decoder train step (batch {batch}, max_len {cfg.max_len}, bf16)",
        DECODER_STEP_PARTS)
    if device_ms is not None:
        log(f"decoder train step: device time {device_ms:.2f} ms a step = "
            f"{device_ms / ms:.1%} of the unprofiled step's {ms:.2f} ms "
            f"(the card's busy share without the profiler's cost) | {card}")
    del run, params, leaves, step, tb, mb
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")


# -- phases 21-22: processes joined into one mesh; the sharded training step --

POD_TIMEOUT_S = 420    # phase 21's two processes together, start to end
POD_ROWS = 1_000_000   # phase 21's flat rows and PQ body rows
POD_BLOCK = 10_000     # divides each process's 500,000 rows: every block
                       # product has one shape in both processes and in
                       # the single-process scan
# phase 22: the loss of a data=2 step against the data=1 step on the same
# global batch and parameters. The two encode 128 and 256 rows a call, so
# cuBLAS may sum a bf16 product in another order: each embedding moves by
# about a bf16 rounding (2^-8 relative), the logits by 1/temperature = 20
# times that on unit vectors' dots. A loss per data row (negatives from
# the row's own 128) is another function: ln 128 against ln 256 at
# chance, 12% of the loss, far outside. Relative tolerance
DP_LOSS_RTOL = 2 ** -7


def host_ms(torch, fn, reps: int) -> float:
    """Host-clock ms a call of ``fn`` (after one warm-up), ending in a
    synchronize: what a caller waits for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def pod_child(rank: int, port: int, root: str, err_path: str, shared: dict,
              results) -> None:
    """Phase 21's process ``rank`` of two: joins the process group over
    gloo on the one card, keeps its half of each shared corpus and body
    (views of the parent's tensors, received as CUDA IPC handles), runs
    the three sharded searches across the process boundary, and puts its
    results, launches and times (numpy and plain values) on
    ``results``."""
    import os
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)                       # tracebacks go to the parent
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist
    import rag_foundation_tpu_torch.engine  # noqa: F401 (before parallel)
    from rag_foundation_tpu_torch.engine.ivf import IVFFlatIndex
    from rag_foundation_tpu_torch.engine.ivfpq import IVFPQIndex
    from rag_foundation_tpu_torch.ops import ivf_scan, pq_scan
    from rag_foundation_tpu_torch.parallel import sharded_ivf as sivf
    from rag_foundation_tpu_torch.parallel.mesh import (init_distributed,
                                                        make_mesh,
                                                        shard_rows)
    from rag_foundation_tpu_torch.parallel.topk_merge import (
        gather_over_processes, sharded_topk)
    torch.backends.cuda.matmul.allow_tf32 = False
    if not init_distributed(coordinator=f"127.0.0.1:{port}",
                            num_processes=2, process_id=rank,
                            backend="gloo"):
        raise RuntimeError("init_distributed did not join")
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(2, devices=[card])
    out = {"rank": rank, "backend": dist.get_backend(),
           "mesh": dict(mesh.shape), "shard_offset": mesh.shard_offset}

    # flat: this process's 500,000 rows
    blocks = shard_rows(mesh, shared["corpus"])
    fq = shared["flat_queries"]
    out["flat_rows_held"] = int(blocks[0].shape[0])
    v, i = sharded_topk(fq, blocks, 10, mesh=mesh, block_size=POD_BLOCK)
    out["flat"] = (v.cpu().numpy(), i.cpu().numpy())
    out["flat_ms"] = host_ms(torch, lambda: sharded_topk(
        fq, blocks, 10, mesh=mesh, block_size=POD_BLOCK), 3)

    # IVF-Flat: this process's half of the 10M body's lists
    body = sivf.shard_ivf_index(IVFFlatIndex(**shared["ivf"]), mesh)
    qv = shared["ivf_queries"]
    out["ivf_lists_held"] = int(body.shards[0].nlist)
    out["ivf_rows_held"] = int(body.shards[0].n)

    def ivf():
        return sivf.sharded_ivf_search(body, qv, 10, mesh=mesh,
                                       nprobe_local=16, p=3)

    ivf_scan.LAUNCHES.reset()                   # counts: this path only
    v, i = ivf()
    torch.cuda.synchronize()
    out["ivf_launches"] = ivf_scan.LAUNCHES.count   # read just after
    out["ivf"] = (v.cpu().numpy(), i.cpu().numpy())
    out["ivf_ms"] = host_ms(torch, ivf, 5)
    cand = ([v], [i])
    out["gather_ms"] = host_ms(torch, lambda: gather_over_processes(
        *cand, 10, card), 5)

    # IVF-PQ: this process's half of the PQ body's lists
    pq = sivf.shard_ivfpq_index(IVFPQIndex(**shared["pq"]), mesh)
    pq_q = shared["pq_queries"]

    def adc():
        return sivf.sharded_ivfpq_search(pq, pq_q, 10, mesh=mesh,
                                         nprobe_local=16, p=4)

    pq_scan.LAUNCHES.reset()                    # counts: this path only
    v, i = adc()
    torch.cuda.synchronize()
    out["pq_launches"] = pq_scan.LAUNCHES.count     # read just after
    out["pq"] = (v.cpu().numpy(), i.cpu().numpy())
    out["pq_ms"] = host_ms(torch, adc, 5)
    results.put(out)
    dist.barrier()
    dist.destroy_process_group()
    # release the parent's tensors before exiting (CUDA IPC counts them)
    del blocks, body, pq, qv, pq_q, fq, cand, v, i
    shared.clear()
    gc.collect()
    torch.cuda.synchronize()


def run_pod(torch, shared: dict, timeout_s: float) -> list[dict]:
    """Phase 21's two processes (``pod_child``), started together with
    ``torch.multiprocessing``'s spawn; a process that exits non-zero, or
    a pod past ``timeout_s``, kills both and fails with their stderr.
    Returns the two results, rank 0 first."""
    import queue
    import socket
    mp = torch.multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    err_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-pod-")
    errs = [str(Path(err_dir) / f"rank{r}.err") for r in range(2)]
    results = mp.Queue()
    procs = [mp.Process(target=pod_child, args=(r, port, str(ROOT), errs[r],
                                                shared, results))
             for r in range(2)]

    def stderr() -> str:
        return "\n".join(
            f"--- rank {r} stderr ---\n"
            + (Path(e).read_text()[-3000:] if Path(e).exists() else "")
            for r, e in enumerate(errs))

    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < 2:
            try:
                item = results.get(timeout=1.0)
                got[item["rank"]] = item
                continue
            except queue.Empty:
                pass
            if any(p.exitcode not in (None, 0) for p in procs):
                fail(f"phase 21: a process failed "
                     f"({[p.exitcode for p in procs]}):\n{stderr()}")
            if all(p.exitcode is not None for p in procs):
                fail(f"phase 21: the processes ended without their "
                     f"results:\n{stderr()}")
            if time.monotonic() > deadline:
                fail(f"phase 21: the pod did not finish in {timeout_s} s:"
                     f"\n{stderr()}")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        if any(p.exitcode != 0 for p in procs):
            fail(f"phase 21: exit codes {[p.exitcode for p in procs]}:\n"
                 f"{stderr()}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(err_dir, ignore_errors=True)
    return [got[0], got[1]]


def pod_phase(args, card, body, fact_vectors) -> dict:
    """Phase 21: two processes on the one card joined into one mesh by
    ``init_distributed`` (gloo), each holding half of the shards:
    ``sharded_topk`` over 1M x 768 rows, ``sharded_ivf_search`` over
    phase 3's 10M int8 body and ``sharded_ivfpq_search`` over a 1M-row PQ
    body, each against the single-process result (``exact_topk``; the
    two-shard search on ``[card] * 2``), and each list scan on shard 0's
    dispatch against its plain version. Returns the two list scans'
    launches in the processes and their shard-0 checks."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.engine import ivfpq as tpq
    from rag_foundation_tpu_torch.engine.ivf import default_qcap
    from rag_foundation_tpu_torch.engine.ivfpq import build_ivf_pq
    from rag_foundation_tpu_torch.ops import ivf_scan, pq_scan
    from rag_foundation_tpu_torch.ops.topk import exact_topk
    from rag_foundation_tpu_torch.parallel import sharded_ivf as sivf
    from rag_foundation_tpu_torch.parallel.mesh import make_mesh
    from rag_foundation_tpu_torch.utils import roofline
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(args.seed + 21)
    mesh2 = card_mesh(torch, make_mesh, 2)

    # the flat corpus and its single-process scan
    corpus = torch.randn((POD_ROWS, 768), generator=g, device="cuda")
    corpus /= corpus.norm(dim=1, keepdim=True)
    flat_q = torch.randn((1024, 768), generator=g, device="cuda")
    flat_q /= flat_q.norm(dim=1, keepdim=True)
    flat_ref = exact_topk(flat_q, corpus, 10, block_size=POD_BLOCK)
    flat_ms = host_ms(torch, lambda: exact_topk(flat_q, corpus, 10,
                                                block_size=POD_BLOCK), 3)

    # IVF-Flat: phase 3's 10M body on two shards in this process
    ivf_q = torch.as_tensor(fact_vectors, device="cuda")
    two = sivf.shard_ivf_index(body, mesh2)

    def ivf_one():
        return sivf.sharded_ivf_search(two, ivf_q, 10, mesh=mesh2,
                                       nprobe_local=16, p=3)

    ivf_ref = ivf_one()
    ivf_ms = host_ms(torch, ivf_one, 5)
    # shard 0's kernel on the dispatch the process holding shard 0 scans
    # (the same queries routed over the same 2,048 lists), against its
    # plain version, as phase 17 holds a shard of four
    qcap = default_qcap(1024, 16, two.nlist_local)
    _, dispatch, _, dropped, qdisp, scale = sivf.route_shards(
        two, ivf_q, 16, qcap, mesh2)[0]
    shard0 = two.shards[0]
    ivf_shard = shard_kernel_line(
        torch, ivf_scan.ivf_list_scan, ivf_scan.ivf_list_scan_reference,
        (qdisp, shard0.lists, shard0.row_ids, dispatch),
        dict(p=3, scale=scale),
        roofline.scan_bound(shard0.row_ids, ivf_scan.live_slots(dispatch),
                            qcap, 3, 1, 768, "int8"),
        f"phase 21 ivf_list_scan int8, shard 0 of 2 ({shard0.nlist} lists, "
        f"qcap {qcap}, dropped {int(dropped)}), Q=1024 fact questions",
        card)
    del dispatch, qdisp, shard0

    # IVF-PQ: phase 6's body is not built yet at this point of the run
    # (its store comes after the int8 store is released), so a 1M-row
    # body of phase 6's layout (d 768, m 192 unpacked 4-bit codes, no
    # device refine) is built here
    centers = torch.randn((4096, 768), generator=g, device="cuda")
    pq_rows = centers[torch.randint(0, 4096, (POD_ROWS,), generator=g,
                                    device="cuda")]
    pq_rows += 0.5 * torch.randn(pq_rows.shape, generator=g, device="cuda")
    pq_rows /= pq_rows.norm(dim=1, keepdim=True)
    t0 = time.perf_counter()
    pq = build_ivf_pq(pq_rows, nlist=1024, m=192, generator=g, refine=False)
    torch.cuda.synchronize()
    pq_build_s = time.perf_counter() - t0
    pq_q = pq_rows[:1024] + 0.05 * torch.randn((1024, 768), generator=g,
                                               device="cuda")
    del centers
    pq_two = sivf.shard_ivfpq_index(pq, mesh2)

    def pq_one():
        return sivf.sharded_ivfpq_search(pq_two, pq_q, 10, mesh=mesh2,
                                         nprobe_local=16, p=4)

    pq_ref = pq_one()
    pq_ms = host_ms(torch, pq_one, 5)
    # shard 0's ADC scan on its own dispatch of the same queries, as the
    # process holding it routes them (adc_top_rows), against its plain
    # version
    shard0 = pq_two.shards[0]
    q32, _, _, dispatch, _, dropped = tpq.route(
        shard0, pq_q, 16, default_qcap(1024, 16, pq_two.nlist_local))
    lut_disp, _ = tpq.scan_inputs(shard0, q32, dispatch, torch.int8)
    pq_shard = shard_kernel_line(
        torch, pq_scan.pq_list_scan, pq_scan.pq_list_scan_reference,
        (lut_disp, shard0.codes, shard0.row_ids, dispatch), dict(p=4),
        roofline.pq_scan_bound(shard0.row_ids, pq_scan.live_slots(dispatch),
                               dispatch.shape[1], 4, shard0.m,
                               shard0.codes.shape[2], 1),
        f"phase 21 pq_list_scan int8 LUT, shard 0 of 2 ({shard0.nlist} "
        f"lists, qcap {dispatch.shape[1]}, dropped {int(dropped)}), Q=1024 "
        f"stored rows + noise", card)
    del q32, dispatch, lut_disp, shard0
    log(f"phase 21 inputs: flat {POD_ROWS} x 768 f32 (Q=1024 random, "
        f"k=10, block {POD_BLOCK}); IVF-Flat phase 3's 10M int8 body "
        f"(nlist {body.nlist}, {body.n} rows; the data_dir's body.npz holds "
        f"only the real documents, since pads are not persisted, so the "
        f"processes get the 10M body as CUDA IPC handles of this process's "
        f"tensors), Q=1024 fact questions, nprobe_local 16, p 3; IVF-PQ: "
        f"phase 6's body not there yet, a {POD_ROWS}-row body built here "
        f"in {pq_build_s:.1f} s (nlist {pq.nlist}, m {pq.m}, 4-bit, no "
        f"refine), "
        f"Q=1024 stored rows + noise, nprobe_local 16, p 4 | {card}")

    shared = {"corpus": corpus, "flat_queries": flat_q,
              "ivf": body._asdict(), "ivf_queries": ivf_q,
              "pq": pq._asdict(), "pq_queries": pq_q}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run_pod(torch, shared, POD_TIMEOUT_S)
    pod_s = time.perf_counter() - t0
    for r, res in enumerate(got):
        if res["mesh"] != {"data": 1, "shard": 2} \
                or res["shard_offset"] != r:
            fail(f"phase 21: rank {r}'s mesh {res['mesh']} offset "
                 f"{res['shard_offset']}")
        if res["flat_rows_held"] != POD_ROWS // 2 \
                or res["ivf_lists_held"] != body.nlist // 2:
            fail(f"phase 21: rank {r} holds {res['flat_rows_held']} rows, "
                 f"{res['ivf_lists_held']} lists")
        if res["ivf_launches"] == 0 or res["pq_launches"] == 0:
            fail(f"phase 21: rank {r} launched ivf_list_scan "
                 f"{res['ivf_launches']}, pq_list_scan "
                 f"{res['pq_launches']} times")
    for name in ("flat", "ivf", "pq"):
        a, b = got[0][name], got[1][name]
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(f"phase 21: the two processes' {name} results differ")
    rv, ri = (t.cpu().numpy() for t in flat_ref)
    fv, fi = got[0]["flat"]
    if not (np.array_equal(fv, rv) and np.array_equal(fi, ri)):
        fail(f"phase 21: cross-process sharded_topk differs from "
             f"exact_topk in {int((fi != ri).sum())} ids, "
             f"{int((fv != rv).sum())} values")
    for name, ref in (("ivf", ivf_ref), ("pq", pq_ref)):
        v, i = got[0][name]
        want_v, want_i = (t.cpu().numpy() for t in ref)
        if not np.array_equal(i, want_i):
            fail(f"phase 21: cross-process {name} ids differ from the "
                 f"single-process two-shard search in "
                 f"{int((i != want_i).sum())} of {i.size}")
        if not np.array_equal(v, want_v):
            fail(f"phase 21: cross-process {name} values differ from the "
                 f"single-process two-shard search")
    r0 = got[0]
    log(f"phase 21: 2 processes on one card, backend {r0['backend']} (the "
        f"candidates staged through host memory), mesh {r0['mesh']}, each "
        f"holding {r0['flat_rows_held']} flat rows and "
        f"{r0['ivf_lists_held']} lists ({got[0]['ivf_rows_held']} + "
        f"{got[1]['ivf_rows_held']} rows of the 10M body); both processes "
        f"equal: sharded_topk bit-identical to exact_topk, the IVF-Flat and "
        f"IVF-PQ ids and values bit-identical to the two-shard search in "
        f"one process; launches a process: ivf_list_scan "
        f"{[g_['ivf_launches'] for g_ in got]}, pq_list_scan "
        f"{[g_['pq_launches'] for g_ in got]} (counters zeroed just "
        f"before) | {card}")
    log(f"phase 21 Q=1024 times (host clock to a synchronize, each process "
        f"while the other runs the same on the card): flat "
        f"{[round(g_['flat_ms'], 3) for g_ in got]} ms across processes vs "
        f"{flat_ms:.3f} single-process exact_topk; IVF-Flat "
        f"{[round(g_['ivf_ms'], 3) for g_ in got]} ms vs {ivf_ms:.3f} "
        f"two shards in one process, the candidates' all-gather "
        f"{[round(g_['gather_ms'], 3) for g_ in got]} ms of it "
        f"({got[0]['gather_ms'] / got[0]['ivf_ms']:.1%} on rank 0); IVF-PQ "
        f"{[round(g_['pq_ms'], 3) for g_ in got]} ms vs {pq_ms:.3f}; the "
        f"pod {pod_s:.1f} s with start-up; phase 21 "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")
    del shared, corpus, pq, pq_two, pq_rows, two
    gc.collect()
    torch.cuda.empty_cache()
    return {"ivf_list_scan": [g_["ivf_launches"] for g_ in got],
            "pq_list_scan": [g_["pq_launches"] for g_ in got],
            "ivf_shard": ivf_shard, "pq_shard": pq_shard,
            "backend": r0["backend"]}


def sharded_train_phase(args, card, corpus) -> dict:
    """Phase 22: ``make_sharded_train_step`` at the flagship config on
    ``[card] * 4`` (data 2 x shard 2), batch 256 from phase 15's corpus,
    against the ``data=1`` step on the same batch and parameters and the
    single-device searches, and the attention kernels at a data row's
    shapes against their plain versions; then
    ``tools.dryrun_multichip --devices 8`` on the card. Returns the three
    attention kernels' launches in one sharded step and their errors."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.models import optim
    from rag_foundation_tpu_torch.models.tokenizer import Tokenizer
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    from rag_foundation_tpu_torch.ops.kmeans import assign_clusters
    from rag_foundation_tpu_torch.ops.topk import exact_topk
    from rag_foundation_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from rag_foundation_tpu_torch.parallel.train_step import \
        make_sharded_train_step
    from rag_foundation_tpu_torch.tools import dryrun_multichip, train_encoder
    t_phase = time.perf_counter()
    cfg = tenc.EncoderConfig()
    if (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.heads, cfg.ffn,
            cfg.dtype) != (30_522, 384, 6, 12, 1536, "bfloat16"):
        fail(f"phase 22: the flagship config is {cfg}")
    chunks = train_encoder.load_chunks(corpus)[:TRAIN_BATCH]
    tok = Tokenizer(vocab_size=cfg.vocab_size)
    qrng = np.random.default_rng(args.seed + 22)
    qb = torch.as_tensor(tok.encode_batch(
        [train_encoder.keyword_query(qrng, c) for c in chunks], 32),
        device="cuda")
    db = torch.as_tensor(tok.encode_batch(chunks, 128), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 22)
    params = tenc.init_params(g, cfg)
    twin = tenc._map(params, lambda _, t: t.clone())
    rows = torch.randn((1_000_000, cfg.hidden), generator=g, device="cuda")
    rows /= rows.norm(dim=1, keepdim=True)
    cents = torch.randn((4096, cfg.hidden), generator=g, device="cuda")
    card_dev = torch.device("cuda", torch.cuda.current_device())
    # a block of 10,000 rows divides each shard's 500,000: every block
    # product has one shape in the step and in the single-device scan
    recipe = dict(k=10, block_size=POD_BLOCK, temperature=0.05,
                  symmetric=True, max_grad_norm=1.0)
    mesh = make_mesh(2, data=2, devices=[card_dev] * 4)
    mesh1 = make_mesh(2, devices=[card_dev] * 2)
    step = make_sharded_train_step(cfg, optim.adamw(3e-4), mesh, **recipe)
    step1 = make_sharded_train_step(cfg, optim.adamw(3e-4), mesh1, **recipe)
    inputs = (qb, db, shard_rows(mesh, rows), cents)

    counters = (fa.LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES)
    for c in counters:
        c.reset()                                 # counts: this step only
    torch.cuda.synchronize()
    out = step(params, *inputs)
    torch.cuda.synchronize()
    launches = [c.count for c in counters]        # read just after
    out1 = step1(twin, qb, db, shard_rows(mesh1, rows), cents)
    loss, loss1 = float(out.loss), float(out1.loss)
    if not np.isfinite(loss):
        fail(f"phase 22: non-finite loss {loss}")
    if min(launches) == 0:
        fail(f"phase 22: the sharded step launched an attention kernel no "
             f"time: {launches}")
    rel = abs(loss - loss1) / abs(loss1)
    if rel > DP_LOSS_RTOL:
        fail(f"phase 22: data=2 loss {loss} against data=1 {loss1}: "
             f"relative {rel:.3g} > {DP_LOSS_RTOL}")
    worst_cos = 1.0
    for key, a in tenc._leaves(params).items():
        r = tenc._leaves(twin)[key]
        a, r = a.grad.double().ravel(), r.grad.double().ravel()
        if not bool(torch.isfinite(a).all()):
            fail(f"phase 22: the gradient of {key} is not finite")
        if float(r.norm()) == 0.0:
            continue
        worst_cos = min(worst_cos, float(a @ r / (a.norm() * r.norm())))
    if worst_cos < GRAD_COS_MIN:
        fail(f"phase 22: gradient cosine {worst_cos} < {GRAD_COS_MIN}")
    ev, ei = exact_topk(out.queries, rows, 10, block_size=POD_BLOCK)
    if not (torch.equal(out.indices, ei) and torch.equal(out.values, ev)):
        fail(f"phase 22: sharded_topk of the step's queries differs from "
             f"exact_topk in {int((out.indices != ei).sum())} ids")
    # each data row assigns its 128 queries: a product of another shape,
    # so a centroid may win only where two tie within the f32 tolerance
    ref_assign = assign_clusters(out.queries, cents)[0]
    ties = (out.assign != ref_assign).nonzero().flatten().tolist()
    score = out.queries @ cents.T - 0.5 * (cents * cents).sum(dim=1)
    for j in ties:
        gap = float(score[j, out.assign[j]] - score[j, ref_assign[j]])
        if abs(gap) > F32_TOL:
            fail(f"phase 22: query {j} assigned to {int(out.assign[j])}, "
                 f"assign_clusters gives {int(ref_assign[j])} ({gap})")
    off = [k for k, t in tenc._leaves(params).items()
           if t.device.type != "cuda"]
    if off:
        fail(f"phase 22: parameters off the card after the step: {off}")
    # the attention kernels at a data row's shapes (B=128 at S=32 and
    # 128, which no earlier phase checks): layer 0 of each side of row 0,
    # with the gradient its half batch's loss sends back, against their
    # plain versions
    half = TRAIN_BATCH // 2
    cap = capture_calls(fa, torch, (0, cfg.layers))
    torch.autograd.grad(
        tenc.contrastive_loss(params, qb[:half], db[:half], cfg, 0.05, True,
                              attention=cap),
        list(tenc._leaves(params).values()))
    attn_err = {"flash_attention": 0.0, "flash_attention_bwd_dkv": 0.0,
                "flash_attention_bwd_dq": 0.0}
    for s_len, call in ((32, 0), (128, cfg.layers)):
        q, k, v, sq, skv, scale, do = cap.captured[call]
        what = f"phase 22 layer 0 B={q.shape[0]} S={s_len}"
        fwd, lse = fa.flash_attention_forward(q, k, v, sq, skv, scale,
                                              with_lse=True)
        err_f, _ = check_attention(
            torch, fwd, fa.flash_attention_reference(q, k, v, sq, skv, scale),
            v, "bf16", f"{what} flash_attention")
        di = (fwd.float() * do.float()).sum(dim=-1)
        err_kv, err_q = check_bwd_kernels(torch, fa, q, k, v, sq, skv, lse,
                                          do, di, scale, "bf16", what)
        for name, err in zip(attn_err, (err_f, err_kv, err_q)):
            attn_err[name] = max(attn_err[name], err)
    del cap, q, k, v, sq, skv, do, fwd, lse, di
    log(f"phase 22: make_sharded_train_step, MiniLM-L6 (vocab 30522, hidden "
        f"384, 6 layers, 12 heads, ffn 1536, bf16), batch {TRAIN_BATCH} "
        f"(q_len 32, d_len 128, phase 15's corpus), symmetric InfoNCE "
        f"t=0.05, adamw 3e-4, clip 1.0, mesh {mesh.shape} on [card] * 4; "
        f"sharded_topk k=10 over 1,000,000 x 384 f32, assign_clusters to "
        f"4096 centroids: loss {loss:.6f} vs the data=1 step's {loss1:.6f} "
        f"(relative {rel:.3g}, tolerance {DP_LOSS_RTOL}); worst gradient "
        f"cosine of {len(tenc._leaves(params))} leaves {worst_cos:.6f} "
        f"(floor {GRAD_COS_MIN}); ids and values equal exact_topk, "
        f"assignment equal assign_clusters but {len(ties)} near-ties, "
        f"parameters on the card; a data row's layer 0 (B={half}, S=32 "
        f"and 128) against the plain versions: max_abs_err forward "
        f"{attn_err['flash_attention']:.3g}, dK/dV "
        f"{attn_err['flash_attention_bwd_dkv']:.3g}, dQ "
        f"{attn_err['flash_attention_bwd_dq']:.3g}; "
        f"attention launches a step: flash_attention {launches[0]}, "
        f"flash_attention_bwd_dkv {launches[1]}, flash_attention_bwd_dq "
        f"{launches[2]} | {card}")

    # times: the sharded step, the data=1 step, phase 15's plain step
    plain = tenc.make_train_step(cfg, optim.adamw(3e-4), max_grad_norm=1.0,
                                 temperature=0.05, symmetric=True)
    spare = tenc._map(params, lambda _, t: t.detach().clone())
    runs = {"data 2 x shard 2": lambda: step(params, *inputs),
            "data 1 x shard 2": lambda: step1(twin, qb, db,
                                               shard_rows(mesh1, rows), cents),
            "phase 15's step (one device, no search)":
                lambda: plain(spare, qb, db)}
    times = {name: [] for name in runs}
    for name, fn in list(runs.items()) + list(reversed(runs.items())):
        times[name].append(host_ms(torch, fn, 3))
    log("phase 22 ms a step (host clock to a synchronize, two runs of 3 "
        "each, in turns): " + "; ".join(
            f"{n} {min(t):.2f}-{max(t):.2f}" for n, t in times.items())
        + f" | {card}")
    device_ms = profile_train_steps(
        torch, step, params, inputs, 3, card,
        f"sharded training step (data 2 x shard 2 on one card, batch "
        f"{TRAIN_BATCH}, with sharded_topk and assign_clusters)")
    del params, twin, spare, rows, inputs, out, out1, step, step1, plain
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dry = dryrun_multichip.dryrun_multichip(8, "cuda")
    log(f"tools.dryrun_multichip --devices 8 on [card] * 8: mesh "
        f"{dry['mesh']}, loss {dry['loss']:.4f}, "
        f"{time.perf_counter() - t0:.1f} s; phase 22 "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")
    return {"flash_attention": launches[0],
            "flash_attention_bwd_dkv": launches[1],
            "flash_attention_bwd_dq": launches[2],
            "max_abs_err": attn_err,
            "step_ms": {n: min(t) for n, t in times.items()},
            "step_device_ms": device_ms}

# -- phase 23: the port's app on the card -------------------------------------

# the settings of tests/app_helpers.make_settings, as RAGTPU_* variables
APP_SETTINGS = {
    "ENVIRONMENT": "test", "DEV_LOGIN_ENABLED": "true", "MOCK_MODE": "false",
    "ENGINE_DIM": "128", "ENGINE_CHUNK_TOKENS": "40",
    "ENGINE_CHUNK_OVERLAP": "8", "RATE_LIMIT_GLOBAL_PER_MIN": "100000",
    "RATE_LIMIT_CHAT_PER_MIN": "100000", "RATE_LIMIT_UPLOAD_PER_MIN": "10000",
    "RATE_LIMIT_LOGIN_PER_MIN": "10000", "STREAM_KEEPALIVE_S": "5.0",
    "WORKER_RETRY_BACKOFF_S": "0.0"}
APP_CONCURRENCY = 64      # concurrent SSE chats of phase 23 (b)
APP_API_PROCESSES = 4     # API processes (--workers) in front of the engine
APP_CLIENT_PROCESSES = 8  # processes the concurrent chats of (b) come from
APP_WAVES = 32            # waves of APP_CONCURRENCY chats sent together
# the engine's batches are the arrivals of one admission window, which the
# host paces: on an H100 host, three runs of this script formed a batch of
# 17-32 queries (one launch each) 2 and 4 times in 16 waves and 23 times
# in 32. Where no measured wave crossed, more waves are sent, this many at
# a time and at most APP_MORE_WAVES, until one does
APP_WAVES_STEP = 16
APP_MORE_WAVES = 160
ENGINE_STAGES = "engine_query_stage_seconds"
APP_FACT_DOCS = 16        # fact documents uploaded through the app in (b)
SCORE_TIE = 1e-5          # (a): card and CPU hits may swap only near-ties
SSE_HEAD = ["start", "text-start"]
SSE_TAIL = ["text-end"]
# phase 24: the split topology
APP_SPLIT_WORKERS = 2     # worker_main processes draining the job queue
APP_AUDIT_S = 10.0        # their recall audit cron's period, seconds
LOADGEN_USERS = 16        # benchmark.loadgen: users, seconds, the most
LOADGEN_DURATION_S = 20   # think time (seconds) and the reference's
LOADGEN_THINK_S = 0.5     # chat share (4 chats : 1 upload)
LOADGEN_CHAT_RATIO = 0.8


def sse_contract_ok(frames: list) -> bool:
    """start, text-start, text-delta*, text-end, source-document*,
    finish, [DONE]."""
    i = 2
    if frames[:2] != SSE_HEAD:
        return False
    while i < len(frames) and frames[i] == "text-delta":
        i += 1
    if frames[i:i + 1] != SSE_TAIL:
        return False
    i += 1
    while i < len(frames) and frames[i] == "source-document":
        i += 1
    return frames[i:] == ["finish", "[DONE]"]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def app_env(work: Path, env_extra: dict) -> dict:
    """The environment of the app's processes over the deployment in
    ``work`` (its sqlite and data dir): ``APP_SETTINGS`` and
    ``env_extra`` as ``RAGTPU_*`` variables."""
    import os
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAGTPU_")}
    env.update({f"RAGTPU_{k}": v for k, v in APP_SETTINGS.items()})
    env.update(PYTHONPATH=str(ROOT),
               RAGTPU_DATA_DIR=str(work / "data"),
               RAGTPU_DATABASE_PATH=str(work / "app.db"))
    env.update({f"RAGTPU_{k}": str(v) for k, v in env_extra.items()})
    return env


class AppProcess:
    """``python -m rag_foundation_tpu_torch.app.main`` in its own process
    group on a free port (``workers`` API processes), its log in
    ``work/<name>.log``; ``stop`` ends them and returns the log. With
    ``module`` ``rag_foundation_tpu_torch.app.worker_main`` it is a worker
    process instead (no port)."""

    def __init__(self, work: Path, env_extra: dict, workers: int = 1, *,
                 module: str = "rag_foundation_tpu_torch.app.main",
                 name: str = "app"):
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.log_path = work / f"{name}.log"
        argv = ["--port", str(self.port), "--workers", str(workers)] \
            if module.endswith(".app.main") else []
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            cwd=ROOT, env=app_env(work, env_extra), stdout=self._log,
            stderr=subprocess.STDOUT, start_new_session=True)

    def wait_live(self, timeout_s: float = 300.0) -> float:
        import socket
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            if self.proc.poll() is not None:
                fail(f"the app exited {self.proc.returncode}: "
                     f"{self.log_path.read_text()[-3000:]}")
            try:
                with socket.create_connection(("127.0.0.1", self.port), 0.5):
                    return time.perf_counter() - t0
            except OSError:
                time.sleep(0.2)
        fail("the app did not start listening")

    def stop(self) -> str:
        import os
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait(timeout=30)
        self._log.close()
        return self.log_path.read_text()


def started_devices(log_text: str) -> list[str]:
    return [json.loads(line)["device"] for line in log_text.splitlines()
            if '"app_started"' in line and line.startswith("{")]


def log_events(log_text: str, msg: str) -> list[dict]:
    """The JSON log lines of ``log_text`` whose ``msg`` is ``msg``."""
    out = []
    for line in log_text.splitlines():
        if line.startswith("{") and f'"{msg}"' in line:
            try:
                event = json.loads(line)
            except ValueError:
                continue
            if event.get("msg") == msg:
                out.append(event)
    return out


def pct(xs, q) -> float:
    import numpy as np
    return float(np.percentile(xs, q)) if xs else float("nan")


def cpu_seconds(pids) -> float:
    """User + system CPU seconds of the live processes ``pids`` so far
    (``/proc/<pid>/stat``)."""
    import os
    tick = os.sysconf("SC_CLK_TCK")
    total = 0.0
    for pid in pids:
        try:
            fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
        except OSError:
            continue
        utime, stime = fields.split()[11:13]
        total += (int(utime) + int(stime)) / tick
    return total


def process_tree(pid: int) -> list[int]:
    """``pid`` and its children (one level: the app's forked API
    processes)."""
    kids = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            ppid = int(stat.read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            kids.append(int(stat.parent.name))
    return [pid] + kids


def stage_means(text: str, family: str) -> dict:
    """{label: mean ms} of a latency histogram in Prometheus text, parsed
    by hand (``_sum`` over ``_count`` of each child)."""
    sums, counts = {}, {}
    for line in text.splitlines():
        if not line.startswith(family + "_") or "{" not in line:
            continue
        name, rest = line.split("{", 1)
        labels, value = rest.rsplit("} ", 1)
        label = labels.split('"')[1]
        if name.endswith("_sum"):
            sums[label] = float(value)
        elif name.endswith("_count"):
            counts[label] = float(value)
    return {k: round(sums[k] / counts[k] * 1e3, 3)
            for k in sums if counts.get(k)}


def run_chats_elsewhere(base: str, token: str, stores: list[int],
                        questions: list[dict], concurrency: int,
                        work: Path, *, waves: bool = False,
                        tag: str = "") -> tuple[list[dict], float]:
    """``concurrency`` concurrent chats from ``run_benchmark`` outside
    this process, whose interpreter lock the engine needs, from
    ``APP_CLIENT_PROCESSES`` processes with a share of the clients each
    (in one process, 64 client threads spend more time contending for its
    lock than chatting, and the load they offer sags). The processes
    start together (a barrier of files in ``work``). As a closed loop each
    client asks its next question as soon as its last is answered; with
    ``waves`` the questions go in waves of ``concurrency`` chats sent
    together, each wave once every process has ended the last. Returns
    the results in the order of ``questions`` and the wall seconds from
    the first process's start to the last one's end. ``tag`` names the
    barrier of a later call in the same ``work``."""
    import os
    n = APP_CLIENT_PROCESSES
    step = concurrency if waves else len(questions)
    # per process, per wave: the indices of its questions
    shares = [[list(range(w, min(w + step, len(questions))))[j::n]
               for w in range(0, len(questions), step)] for j in range(n)]
    barrier = work / f"barrier-{'waves' if waves else 'loop'}{tag}"
    barrier.mkdir()
    code = (
        "import json, os, sys, time\n"
        "from rag_foundation_tpu_torch.benchmark.runner import (ApiClient,"
        " run_benchmark)\n"
        "base, token, stores, n, qpath, opath, bdir, j, parties = "
        "sys.argv[1:]\n"
        "c, out = ApiClient(base, token=token), []\n"
        "for w, qs in enumerate(json.loads(open(qpath).read())):\n"
        "    open(os.path.join(bdir, f'{w}-{j}'), 'w').close()\n"
        "    while sum(f.startswith(f'{w}-') for f in os.listdir(bdir)) < "
        "int(parties):\n"
        "        time.sleep(0.001)\n"
        "    out += run_benchmark(c, json.loads(stores), qs, "
        "concurrency=int(n))['results']\n"
        "open(opath, 'w').write(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = []
    t0 = time.perf_counter()
    for j in range(n):
        qpath = work / f"chats-in-{j}.json"
        opath = work / f"chats-out-{j}.json"
        qpath.write_text(json.dumps([[questions[i] for i in wave]
                                     for wave in shares[j]]))
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code, base, token, json.dumps(stores),
             str(concurrency // n), str(qpath), str(opath), str(barrier),
             str(j), str(n)], cwd=ROOT, env=env, stderr=subprocess.PIPE,
            text=True), opath))
    errors = []
    for proc, _ in procs:
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            errors.append(err[-2000:])
    wall = time.perf_counter() - t0
    if errors:
        fail(f"a chat clients' process failed: {errors[0]}")
    results = [None] * len(questions)
    for j, (_, opath) in enumerate(procs):
        order = [i for wave in shares[j] for i in wave]
        for i, r in zip(order, json.loads(opath.read_text())):
            results[i] = r
    return results, wall


def app_inprocess_phase(args, card) -> dict:
    """Phase 23 (a): the port's app with its ``Engine`` in process on the
    card (``exact``, the settings of ``tests/app_helpers.make_settings``),
    started through its entry point and driven by its benchmark client:
    register and log in, create a store, upload the ten documents of
    ``benchmarks/quality/docs`` through ``/api/upload`` (the in-process
    worker ingests them on the card), poll ``op-status``, then the quality
    questions over SSE (``run_benchmark``, 4 clients). The same with
    ``RAGTPU_ENGINE_PLATFORM=cpu``: the answers and citations must be
    equal, question by question, and every stream keep the SSE contract.
    Returns the phase's numbers."""
    from rag_foundation_tpu_torch.benchmark.runner import (ApiClient,
                                                           run_benchmark)
    quality = ROOT / "benchmarks" / "quality"
    docs = sorted((quality / "docs").glob("*.md"))
    questions = [json.loads(line) for line in (
        quality / "questions.jsonl").read_text().splitlines()
        if line.strip()]
    runs, numbers = {}, {}
    for platform in ("cuda", "cpu"):
        work = Path(tempfile.mkdtemp(prefix=f"ragtpu-chip-app-{platform}-"))
        extra = {"ENGINE_INDEX_MODE": "exact"}
        if platform == "cpu":
            extra["ENGINE_PLATFORM"] = "cpu"
        app = AppProcess(work, extra)
        try:
            start_s = app.wait_live()
            client = ApiClient.from_credentials(
                app.base, "chip@example.com", "Chip-Passw0rd-1",
                register=True)
            client.poll_interval_s = 0.05
            store = client.ensure_store("quality")
            t0 = time.perf_counter()
            for path in docs:
                st = client.upload_and_poll(store["id"], path)
                if st["status"] != "DONE":
                    fail(f"phase 23 (a) {platform}: {path.name} {st}")
            ingest_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = run_benchmark(client, store["id"], questions,
                                concurrency=4)
            wall = time.perf_counter() - t0
        finally:
            log_text = app.stop()
            shutil.rmtree(work, ignore_errors=True)
        devices = started_devices(log_text)
        want = "cpu" if platform == "cpu" else "cuda"
        if not devices or not all(d.startswith(want) for d in devices):
            fail(f"phase 23 (a) {platform}: app_started devices {devices}")
        s = out["summary"]
        if s["errors"]:
            fail(f"phase 23 (a) {platform}: {s['errors']} chats failed: "
                 f"{[r.get('error') for r in out['results']][:3]}")
        broken = [r["question"] for r in out["results"]
                  if not sse_contract_ok(r["frames"])]
        if broken:
            fail(f"phase 23 (a) {platform}: SSE contract broken for "
                 f"{broken[:3]}")
        ttft = [r["ttft_s"] * 1e3 for r in out["results"] if r["ttft_s"]]
        lat = [r["latency_s"] * 1e3 for r in out["results"]]
        runs[platform] = out
        log(f"app (a) on {devices[0]}: started in {start_s:.1f} s, "
            f"{len(docs)} documents uploaded and ingested in "
            f"{ingest_s:.2f} s, {len(questions)} questions over SSE (4 "
            f"clients) in {wall:.2f} s = {len(questions) / wall:.1f} chats/s:"
            f" EM {s['em']:.4f} F1 {s['f1']:.4f} citation hit "
            f"{s['citation_hit']:.4f} refusal accuracy {s['refusal_ok']:.4f}"
            f" latency avg {s['latency_avg_s'] * 1e3:.2f} ms p95 "
            f"{s['latency_p95_s'] * 1e3:.2f} ms, time to first text-delta "
            f"p50 {pct(ttft, 50):.2f} ms | {card}")
        numbers[platform] = {
            "em": s["em"], "f1": s["f1"], "citation_hit": s["citation_hit"],
            "refusal_ok": s["refusal_ok"],
            "latency_avg_ms": s["latency_avg_s"] * 1e3,
            "latency_p95_ms": s["latency_p95_s"] * 1e3,
            "ttft_p50_ms": pct(ttft, 50), "answer_p50_ms": pct(lat, 50),
            "chats_s": len(questions) / wall, "ingest_s": ingest_s}
    differ = [(q, a, b) for q, a, b in zip(
        questions, runs["cuda"]["results"], runs["cpu"]["results"])
        if (a["answer"], a["citations"]) != (b["answer"], b["citations"])]
    if differ:
        app_near_ties(differ, docs, card)
    log(f"app (a): card and CPU answers and citations equal on "
        f"{len(questions) - len(differ)} of {len(questions)} questions "
        f"(the rest near-ties within {SCORE_TIE}) | {card}")
    return {"questions": len(questions), "differ_near_tie": len(differ),
            "card": numbers["cuda"], "cpu": numbers["cpu"]}


def app_near_ties(differ, docs, card) -> None:
    """Where the card's and the CPU's chats differ, the two engines'
    hits for the question, printed; the run fails unless the first hit
    that differs ties its counterpart within ``SCORE_TIE``."""
    from rag_foundation_tpu_torch.app.config import Settings
    from rag_foundation_tpu_torch.app.services.rag import (
        EngineRag, engine_config_from_settings, reformulate_query)
    from rag_foundation_tpu_torch.engine import Engine
    settings = Settings(**{k: v for k, v in APP_SETTINGS.items()},
                        DATA_DIR="")
    rags = {}
    for dev in ("cuda", "cpu"):
        rag = EngineRag(settings, engine=Engine(
            engine_config_from_settings(settings, device=dev)))
        key = rag.create_store("quality", 1)
        for i, path in enumerate(docs, start=1):
            rag.ingest_document(key, f"doc-{i}", path.name,
                                path.read_text())
        rags[dev] = (rag, key)
    for q, a, b in differ:
        question = reformulate_query(q["question"], None)
        hits = {dev: rag.engine.search([key], question, k=128)
                for dev, (rag, key) in rags.items()}
        log(f"app (a) differs on {q['question']!r}: card "
            f"{a['answer']!r} {a['citations']}, CPU {b['answer']!r} "
            f"{b['citations']}")
        for dev, hs in hits.items():
            log(f"  {dev} hits: " + ", ".join(
                f"{h.doc_name}#{h.ordinal} {h.score:.7f}" for h in hs[:8]))
        for hc, hp in zip(hits["cuda"], hits["cpu"]):
            if (hc.doc_id, hc.ordinal) != (hp.doc_id, hp.ordinal):
                if abs(hc.score - hp.score) > SCORE_TIE:
                    fail(f"phase 23 (a): the card and the CPU differ on "
                         f"{q['question']!r} beyond a near-tie: "
                         f"{hc.score} vs {hp.score} | {card}")
                break
        else:
            fail(f"phase 23 (a): the chats differ on {q['question']!r} but "
                 f"the engines' hits do not")


def adopt_store(engine, key: str, new_key: str, body, body_cids,
                pads: int) -> None:
    """Phase 3's store under an app store's key: its chunks, its tail and
    the 10M body (pads are not persisted: no body.npz rewrite, and the
    engine over-fetches past them as the padding engine did)."""
    src, dst = engine._store(key), engine._store(new_key)
    with dst.lock:
        dst.segment, dst.chunks = src.segment, src.chunks
        dst.next_chunk_id = src.next_chunk_id
        dst.segment.adopt_body(body, body_cids)
        dst.saved_body_version = dst.segment.body_version
    engine._pad_counts[new_key] = pads


def app_connect_phase(args, card, ctx, mods) -> tuple[dict, dict, dict]:
    """Phase 23 (b): ``APP_API_PROCESSES`` API processes of the port's app
    (``--workers``, ``RAGTPU_ENGINE_RPC_MODE=connect``) in front of an
    ``EngineRpcServer`` in this process that serves phase 3's 10M int8
    body at phase 3's settings (an ``Engine`` restarted on its
    data_dir). Through the API: two stores; the first's ``engine_key``,
    read from the app's sqlite, gets the 10M body (adopted as phase 19
    does); ``APP_FACT_DOCS`` fact documents are uploaded into the second.
    Then chats over [the 10M store, the fact store]: one at a time (the
    right document cited first, >= ``RECALL_MIN``), then
    ``APP_CONCURRENCY`` concurrent SSE chats from ``run_benchmark`` in
    other processes (``run_chats_elsewhere``), as a closed loop and then
    in ``APP_WAVES`` waves sent together (``ivf_list_scan``'s counter,
    zeroed just before each and read just after, must move in the waves:
    the closed loop's batches mostly stay under the Q*nprobe*8 > nlist
    crossover on this host, which is printed; the largest dispatch the
    chats gave the kernel is held to the plain version, bit for bit, and
    timed beside its bound). Then, its API processes stopped, phase 24
    behind the same server (``app_split_phase``). Returns (the
    ``ivf_list_scan`` entry's keys for both paths, phase 24's numbers,
    this phase's numbers)."""
    import resource
    import sqlite3
    from rag_foundation_tpu_torch.benchmark.runner import (ApiClient,
                                                           run_benchmark)
    from rag_foundation_tpu_torch.utils import roofline
    (Engine, EngineConfig, EngineRpcServer, tivf, ivf_scan) = mods
    (cfg, key, sock, body, body_cids, sampled, rng) = ctx
    t_phase = time.perf_counter()
    engine = Engine(EngineConfig(**cfg))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    work = Path(tempfile.mkdtemp(prefix="ragtpu-chip-app-connect-"))
    app = AppProcess(work, {
        "ENGINE_RPC_MODE": "connect", "ENGINE_RPC_SOCKET": sock,
        "ENGINE_DIM": cfg["dim"], "MAX_CONCURRENT_STREAMS": APP_CONCURRENCY,
        "KV_BACKEND": "sqlite"}, workers=APP_API_PROCESSES)
    fact_ids = list(range(args.docs + 2000, args.docs + 2000 + APP_FACT_DOCS))
    scan_calls = []
    scan = tivf.ivf_list_scan
    try:
        start_s = app.wait_live()
        client = ApiClient.from_credentials(
            app.base, "chip@example.com", "Chip-Passw0rd-1", register=True)
        client.poll_interval_s = 0.05
        big = client.ensure_store("ten million")
        facts = client.ensure_store("fact sheets")
        with sqlite3.connect(work / "app.db") as db:
            big_key = db.execute("SELECT engine_key FROM stores WHERE id=?",
                                 (big["id"],)).fetchone()[0]
        adopt_store(engine, key, big_key, body, body_cids,
                    args.rows - args.docs)
        t0 = time.perf_counter()
        for i in fact_ids:
            path = work / f"project-{i}.txt"
            path.write_text(fact_doc(i))
            client.upload_and_poll(facts["id"], path)
        ingest_s = time.perf_counter() - t0
        with sqlite3.connect(work / "app.db") as db:
            fact_key = db.execute("SELECT engine_key FROM stores WHERE id=?",
                                  (facts["id"],)).fetchone()[0]
        hits = engine.search([big_key, fact_key], fact_query(sampled[0]),
                             k=12)
        if not hits or hits[0].doc_id != f"doc-{sampled[0]}":
            fail(f"phase 23 (b): the adopted store's top hit for project "
                 f"{sampled[0]} is {hits[0].doc_id if hits else None}")
        stats = engine.store_stats(big_key)
        log(f"app (b): {APP_API_PROCESSES} API processes (connect mode) "
            f"started in {start_s:.1f} s; store {big['id']} -> {big_key} "
            f"holds {stats['vectors']} vectors (the 10M body adopted), "
            f"{APP_FACT_DOCS} fact documents uploaded and ingested over "
            f"RPC in {ingest_s:.2f} s | {card}")
        stores = [big["id"], facts["id"]]
        asked = [(i, big_key) for i in sampled] + \
            [(i, None) for i in fact_ids]

        def q_of(i):
            return {"question": fact_query(i), "answers": [f"ZEBRA{i * 7}"],
                    "answerable": True,
                    "expected_sources": [f"project-{i}.txt"]}

        single = run_benchmark(client, stores, [q_of(i) for i, _ in asked],
                               concurrency=1)
        first = [bool(r.get("citations")) and r["citations"][0]
                 == f"project-{i}.txt"
                 for (i, _), r in zip(asked, single["results"])]
        right_first = sum(first) / len(first)
        s1 = single["summary"]
        lat1 = [r["latency_s"] * 1e3 for r in single["results"]]
        ttft1 = [r["ttft_s"] * 1e3 for r in single["results"]
                 if r.get("ttft_s")]
        log(f"app (b), one chat at a time over [10M store, fact store]: "
            f"right document cited first {right_first:.4f} of "
            f"{len(first)}; EM {s1['em']:.4f} F1 {s1['f1']:.4f}; time to "
            f"first text-delta p50 {pct(ttft1, 50):.2f} ms p99 "
            f"{pct(ttft1, 99):.2f} ms; answer p50 {pct(lat1, 50):.2f} ms "
            f"p99 {pct(lat1, 99):.2f} ms (each waits out the "
            f"{cfg['batch_window_s'] * 1e3:.0f} ms window) | {card}")
        if s1["errors"]:
            fail(f"phase 23 (b): {s1['errors']} single chats failed: "
                 f"{[r.get('error') for r in single['results']][:3]}; "
                 f"app log {app.log_path.read_text()[-2000:]}")
        if right_first < RECALL_MIN:
            fail(f"phase 23 (b): right document first {right_first} < "
                 f"{RECALL_MIN}")

        # concurrent chats: the batcher coalesces the API processes'
        # searches into batches past the Q*nprobe*8 > nlist crossover
        def keep_largest(qdisp, lists, row_ids, dispatch=None, **kw):
            live = int((dispatch >= 0).sum()) if dispatch is not None else 0
            if not scan_calls or live > scan_calls[0][0]:
                scan_calls[:] = [(live, (qdisp, lists, row_ids, dispatch),
                                  kw)]
            return scan(qdisp, lists, row_ids, dispatch, **kw)

        asks = {mode: [q_of(asked[j][0]) for j in rng.integers(
            0, len(asked), size=APP_CONCURRENCY * rounds)]
            for mode, rounds in (("closed_loop", 8), ("waves", APP_WAVES))}
        bounds = engine.metrics.search_batch_size.buckets + (float("inf"),)
        app_pids = process_tree(app.proc.pid)
        conc, launches = {}, {}
        tivf.ivf_list_scan = keep_largest
        try:
            for mode, qs in asks.items():
                batches0 = engine.metrics.search_batch_size.labels()._counts[:]
                cpu0 = (cpu_seconds(app_pids), time.process_time(),
                        resource.getrusage(resource.RUSAGE_CHILDREN))
                ivf_scan.LAUNCHES.reset()       # counts: this run only
                results, wall = run_chats_elsewhere(
                    app.base, client.token, stores, qs, APP_CONCURRENCY,
                    work, waves=mode == "waves")
                launches[mode] = ivf_scan.LAUNCHES.count   # read just after
                kids = resource.getrusage(resource.RUSAGE_CHILDREN)
                cpu = {"api_processes": cpu_seconds(app_pids) - cpu0[0],
                       "engine_process": time.process_time() - cpu0[1],
                       "client_processes": (kids.ru_utime + kids.ru_stime)
                       - (cpu0[2].ru_utime + cpu0[2].ru_stime)}
                sizes = [a - b for a, b in zip(
                    engine.metrics.search_batch_size.labels()._counts,
                    batches0)]
                ok = [r for r in results if not r.get("error")]
                n_err = len(results) - len(ok)
                contract = sum(1 for r in ok if sse_contract_ok(r["frames"]))
                ttft = [r["ttft_s"] * 1e3 for r in ok if r.get("ttft_s")]
                lat = [r["latency_s"] * 1e3 for r in ok]
                conc[mode] = {
                    "clients": APP_CONCURRENCY, "chats": len(qs),
                    "chats_s": len(qs) / wall,
                    "ttft_p50_ms": pct(ttft, 50),
                    "ttft_p99_ms": pct(ttft, 99),
                    "answer_p50_ms": pct(lat, 50),
                    "answer_p99_ms": pct(lat, 99),
                    "right_first": sum(
                        1 for q, r in zip(qs, results) if r.get("citations")
                        and r["citations"][0] == q["expected_sources"][0])
                    / len(qs),
                    "batch_sizes": {str(b): n for b, n in zip(bounds, sizes)
                                    if n},
                    "cpu_s": {k: round(v, 2) for k, v in cpu.items()},
                    "launches": launches[mode]}
                c = conc[mode]
                how = (f"a closed loop" if mode == "closed_loop" else
                       f"{len(qs) // APP_CONCURRENCY} waves of "
                       f"{APP_CONCURRENCY} chats sent together")
                how += f" from {APP_CLIENT_PROCESSES} client processes"
                log(f"app (b), {APP_CONCURRENCY} concurrent SSE chats over "
                    f"[10M store, fact store] ({how}): {len(qs)} chats in "
                    f"{wall:.2f} s = {c['chats_s']:.1f} chats/s, errors "
                    f"{n_err}; time to first text-delta p50 "
                    f"{c['ttft_p50_ms']:.2f} ms p99 {c['ttft_p99_ms']:.2f} ms;"
                    f" answer p50 {c['answer_p50_ms']:.2f} ms p99 "
                    f"{c['answer_p99_ms']:.2f} ms; right document first "
                    f"{c['right_first']:.4f} (batched: probes past qcap are "
                    f"dropped, not asserted); SSE contract kept by "
                    f"{contract} of {len(ok)}; engine batches by size (le "
                    f"bucket: count) {c['batch_sizes']}; ivf_list_scan "
                    f"launches {launches[mode]}; CPU seconds {c['cpu_s']} "
                    f"(8 cores) | {card}")
                if n_err or contract != len(qs):
                    fail(f"phase 23 (b): {n_err} chats failed, "
                         f"{len(qs) - contract} broke the SSE contract")
            # no measured wave crossed: more waves, the counter still
            # running from just before the first wave
            more = 0
            while launches["waves"] == 0 and more < APP_MORE_WAVES:
                qs = [q_of(asked[j][0]) for j in rng.integers(
                    0, len(asked), size=APP_CONCURRENCY * APP_WAVES_STEP)]
                results, _ = run_chats_elsewhere(
                    app.base, client.token, stores, qs, APP_CONCURRENCY,
                    work, waves=True, tag=f"-more-{more}")
                launches["waves"] = ivf_scan.LAUNCHES.count  # read just after
                more += APP_WAVES_STEP
                ok = [r for r in results if not r.get("error")]
                broken = sum(1 for r in ok if not sse_contract_ok(r["frames"]))
                if len(ok) != len(qs) or broken:
                    fail(f"phase 23 (b): {len(qs) - len(ok)} chats of the "
                         f"more waves failed, {broken} broke the SSE "
                         f"contract")
            conc["waves"]["more_waves"] = more
            if more:
                log(f"app (b): no batch of the {APP_WAVES} measured waves "
                    f"crossed Q*nprobe*8 > nlist; {more} more waves of "
                    f"{APP_CONCURRENCY} sent, ivf_list_scan launches "
                    f"{launches['waves']} over all {APP_WAVES + more} | "
                    f"{card}")
        finally:
            tivf.ivf_list_scan = scan
        app_metrics = client._request("GET", "/metrics", stream=True).read(
            ).decode()
        log(f"app (b), where the chats' time went: one API process's chat "
            f"stages, mean ms {stage_means(app_metrics, 'chat_stage_seconds')}"
            f", its engine calls "
            f"{stage_means(app_metrics, 'engine_latency_seconds')}; the "
            f"engine's stages a batch (all its searches), mean ms "
            f"{stage_means(engine.metrics.render(), ENGINE_STAGES)} | {card}")
        if launches["waves"] == 0:
            fail("phase 23 (b): the concurrent chats never launched "
                 "ivf_list_scan")
        # the largest dispatch the chats gave the kernel, against the plain
        # version and timed beside its bound
        live, (qdisp, lists, row_ids, dispatch), kw = scan_calls[0]
        kv, ki = scan(qdisp, lists, row_ids, dispatch, **kw)
        rv, ri = ivf_scan.ivf_list_scan_reference(qdisp, lists, row_ids,
                                                  dispatch, **kw)
        err = check_scan(kv, ki, rv, ri, True, qdisp, lists,
                         "ivf_list_scan int8, phase 23 chats' dispatch")
        del kv, ki, rv, ri
        ms = cuda_ms(lambda: scan(qdisp, lists, row_ids, dispatch, **kw),
                     reps=10)
        live_n = ivf_scan.live_slots(dispatch)
        bound_ms, bound_by, c = roofline.scan_bound(
            row_ids, live_n, qdisp.shape[1], kw["p"], 1, qdisp.shape[2],
            "int8")
        log(f"ivf_list_scan int8 on the largest dispatch of the chats "
            f"({live} live slots, qcap {qdisp.shape[1]}, {c['lists_read']} "
            f"lists read): bit-identical to the plain version; kernel "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | {card}")
        log_text = app.stop()
        t_b = time.perf_counter() - t_phase
        # -- phase 24: the split topology behind the same engine server
        split_entry, split = app_split_phase(
            args, card, (engine, sock, key, body, body_cids, cfg),
            (tivf, ivf_scan))
    finally:
        log_text = app.stop()
        server.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    devices = started_devices(log_text)
    if not devices or set(devices) != {"remote"}:
        fail(f"phase 23 (b): app_started devices {devices}")
    log(f"phase 23 (b): {t_b:.1f} s")
    entry = {"launches_app_chat": launches["waves"],
             "app_chat_more_waves": conc["waves"]["more_waves"],
             "launches_app_chat_closed_loop": launches["closed_loop"],
             "app_chat_dispatch": {
        "live_slots": live, "qcap": int(qdisp.shape[1]), "max_abs_err": err,
        "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by},
             **split_entry}
    return entry, split, {
        "api_processes": APP_API_PROCESSES,
        "right_first_one_at_a_time": right_first,
        "single": {"ttft_p50_ms": pct(ttft1, 50),
                   "ttft_p99_ms": pct(ttft1, 99),
                   "answer_p50_ms": pct(lat1, 50),
                   "answer_p99_ms": pct(lat1, 99), "em": s1["em"],
                   "f1": s1["f1"]},
        "concurrent": conc}


def app_split_phase(args, card, ctx, mods) -> tuple[dict, dict]:
    """Phase 24: the app in the split topology production runs, behind
    phase 23 (b)'s ``EngineRpcServer`` (phase 3's 10M int8 body).
    ``APP_API_PROCESSES`` API processes in connect mode with
    ``WORKER_IN_PROCESS=0`` and ``APP_SPLIT_WORKERS`` ``python -m
    rag_foundation_tpu_torch.app.worker_main`` processes in connect mode
    (the recall audit cron every ``APP_AUDIT_S`` s) over one sqlite
    deployment whose first admin ``tools.create_first_admin`` makes.
    Through the API: ``APP_FACT_DOCS`` fact documents uploaded together
    reach DONE through the workers, each job leased once; a chat on each
    fact cites its document first; a deleted document is no longer cited
    and is listed under ``/api/admin/deletions``; restored, it is cited
    first again; ``/api/admin/engine/recall-probe`` on a store holding the
    10M body (k 10, the default sample 32) launches ``ivf_list_scan``
    (the counter zeroed just before, read just after; the probe's own
    dispatch held to the plain version bit for bit and timed beside its
    bound) and gives the recall a worker's ``recall_audit`` line gives for
    that store; ``/api/admin/system`` equals the sqlite rows,
    ``/api/costs/summary`` counts the user's chats, ``/api/settings``
    round-trips, ``/`` and ``/static/app.js`` serve their files; then
    ``benchmark.loadgen`` (``LOADGEN_*``) runs with no errors. Returns (the
    ``ivf_list_scan`` entry's keys for the probe, the phase's numbers)."""
    import os
    import sqlite3
    from rag_foundation_tpu_torch.benchmark.runner import ApiClient
    from rag_foundation_tpu_torch.utils import roofline
    (engine, sock, key, body, body_cids, cfg) = ctx
    (tivf, ivf_scan) = mods
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="ragtpu-chip-app-split-"))
    env_extra = {"ENGINE_RPC_MODE": "connect", "ENGINE_RPC_SOCKET": sock,
                 "ENGINE_DIM": cfg["dim"], "KV_BACKEND": "sqlite",
                 "WORKER_IN_PROCESS": "false", "ARCHIVE_UPLOADS": "true",
                 "ENGINE_RECALL_AUDIT_S": APP_AUDIT_S,
                 "MAX_CONCURRENT_STREAMS": APP_CONCURRENCY}
    admin_pw = "Admin-Passw0rd-24"
    made = subprocess.run(
        [sys.executable, "-m", "rag_foundation_tpu_torch.tools."
         "create_first_admin", "--email", "admin@example.com",
         "--password", admin_pw], cwd=ROOT, env=app_env(work, env_extra),
        capture_output=True, text=True, timeout=120)
    if made.returncode != 0 or "created admin" not in made.stdout:
        fail(f"phase 24: create_first_admin exited {made.returncode}: "
             f"{made.stdout[-500:]} {made.stderr[-1500:]}")
    app = AppProcess(work, env_extra, workers=APP_API_PROCESSES)
    workers = [AppProcess(work, env_extra, name=f"worker-{i}",
                          module="rag_foundation_tpu_torch.app.worker_main")
               for i in range(APP_SPLIT_WORKERS)]
    fact_ids = list(range(args.docs + 4000,
                          args.docs + 4000 + APP_FACT_DOCS))
    scan = tivf.ivf_list_scan
    real_probe = engine.recall_probe
    local = threading.local()
    probes = []        # (store key, result, the scans it launched)

    def traced_probe(store_key, **kw):
        local.calls = []
        try:
            out = real_probe(store_key, **kw)
            probes.append((store_key, out, local.calls))
            return out
        finally:
            local.calls = None

    def traced_scan(qdisp, lists, row_ids, dispatch=None, **kw):
        calls = getattr(local, "calls", None)
        if calls is not None:
            calls.append((qdisp, lists, row_ids, dispatch, kw))
        return scan(qdisp, lists, row_ids, dispatch, **kw)

    try:
        start_s = app.wait_live()
        t0 = time.perf_counter()
        while not all(log_events(w.log_path.read_text(), "worker_started")
                      for w in workers):
            for w in workers:
                if w.proc.poll() is not None:
                    fail(f"phase 24: a worker exited {w.proc.returncode}: "
                         f"{w.log_path.read_text()[-3000:]}")
            if time.perf_counter() - t0 > 300:
                fail("phase 24: the workers did not log worker_started")
            time.sleep(0.2)
        w_devices = [log_events(w.log_path.read_text(), "worker_started")[0]
                     ["device"] for w in workers]
        if set(w_devices) != {"remote"}:
            fail(f"phase 24: worker_started devices {w_devices}")
        admin = ApiClient.from_credentials(app.base, "admin@example.com",
                                           admin_pw)
        user = ApiClient.from_credentials(
            app.base, "split@example.com", "Split-Passw0rd-1",
            register=True)
        user.poll_interval_s = 0.05
        big = user.ensure_store("ten million")
        facts = user.ensure_store("split facts")
        db_path = work / "app.db"
        with sqlite3.connect(db_path) as db:
            big_key = db.execute("SELECT engine_key FROM stores WHERE id=?",
                                 (big["id"],)).fetchone()[0]
        adopt_store(engine, key, big_key, body, body_cids,
                    args.rows - args.docs)
        t_adopted = time.time()     # the workers' log lines' clock

        # 1. the fact documents, uploaded together, drained by the workers
        upload_s = [None] * len(fact_ids)

        def upload(j):
            path = work / f"project-{fact_ids[j]}.txt"
            path.write_text(fact_doc(fact_ids[j]))
            t = time.perf_counter()
            try:
                user.upload_and_poll(facts["id"], path, timeout_s=300)
            except Exception as e:  # noqa: BLE001 — reported below
                upload_s[j] = e
                return
            upload_s[j] = time.perf_counter() - t

        threads = [threading.Thread(target=upload, args=(j,))
                   for j in range(len(fact_ids))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        bad = [u for u in upload_s if not isinstance(u, float)]
        if bad:
            fail(f"phase 24: {len(bad)} uploads did not reach DONE: "
                 f"{bad[:2]}")
        with sqlite3.connect(db_path) as db:
            jobs = db.execute("SELECT status, attempts FROM jobs").fetchall()
        if jobs != [("done", 1)] * len(fact_ids):
            fail(f"phase 24: jobs (status, attempts) {jobs}: a job failed "
                 f"or was leased twice")
        drained_by = [sum(1 for _ in log_events(w.log_path.read_text(),
                                                "ingestion_done"))
                      for w in workers]

        def first_cited(i) -> str | None:
            out = user.ask(fact_query(i), [facts["id"]])
            if out["error"]:
                fail(f"phase 24: chat on project {i}: {out['error']}")
            return out["citations"][0]["title"] if out["citations"] \
                else None

        # 2. a chat on each fact cites its document first
        wrong = [i for i in fact_ids
                 if first_cited(i) != f"project-{i}.txt"]
        if wrong:
            fail(f"phase 24: chats on {wrong} did not cite their document "
                 f"first")
        log(f"app split (24): {APP_API_PROCESSES} API processes "
            f"(WORKER_IN_PROCESS=0) up in {start_s:.1f} s, "
            f"{APP_SPLIT_WORKERS} worker processes (connect mode); "
            f"{len(fact_ids)} uploads sent together, upload to DONE p50 "
            f"{pct(upload_s, 50):.3f} s max {max(upload_s):.3f} s, jobs "
            f"drained per worker {drained_by}, each leased once; each fact "
            f"cited first | {card}")

        # 3. delete one document: no longer cited, listed as deleted
        victim = fact_ids[0]
        title = f"project-{victim}.txt"
        with sqlite3.connect(db_path) as db:
            doc_id = db.execute("SELECT id FROM documents WHERE filename=?",
                                (title,)).fetchone()[0]
        t = time.perf_counter()
        user._request("DELETE", f"/api/documents/{doc_id}")
        out = user.ask(fact_query(victim), [facts["id"]])
        delete_ms = (time.perf_counter() - t) * 1e3
        if out["error"] or title in [c["title"] for c in out["citations"]]:
            fail(f"phase 24: deleted {title} still cited: {out}")
        _, dels = admin._request("GET", "/api/admin/deletions")
        if doc_id not in [d["id"] for d in dels["documents"]]:
            fail(f"phase 24: /api/admin/deletions {dels}")
        # 4. restore: re-ingested by a worker, cited first again
        t = time.perf_counter()
        _, r = admin._request("POST",
                              f"/api/admin/documents/{doc_id}/restore")
        if not r.get("reingest"):
            fail(f"phase 24: restore {r}")
        while True:
            _, st = user._request("GET",
                                  f"/api/upload/op-status/doc-{doc_id}")
            if st["done"]:
                break
            if time.perf_counter() - t > 300:
                fail(f"phase 24: the restored document stays {st}")
            time.sleep(0.05)
        if st["status"] != "DONE" or first_cited(victim) != title:
            fail(f"phase 24: restored {title}: {st}")
        restore_s = time.perf_counter() - t
        log(f"app split (24): delete to unserved (DELETE, then a chat that "
            f"no longer cites it) {delete_ms:.2f} ms; restore to cited first "
            f"again (through a worker) {restore_s:.3f} s | {card}")

        # 5. the recall probe on the 10M store, through the route
        engine.recall_probe = traced_probe
        tivf.ivf_list_scan = traced_scan
        try:
            ivf_scan.LAUNCHES.reset()       # counts: the probe only
            n_probes = len(probes)
            t = time.perf_counter()
            _, probe = admin._request("POST",
                                      "/api/admin/engine/recall-probe",
                                      json_body={"store_id": big["id"],
                                                 "k": 10})
            http_ms = (time.perf_counter() - t) * 1e3
            launches = ivf_scan.LAUNCHES.count      # read just after
        finally:
            engine.recall_probe = real_probe
            tivf.ivf_list_scan = scan
        mine = [p for p in probes[n_probes:] if p[0] == big_key
                and p[1] == probe]
        if probe.get("recall") is None or not mine or not mine[0][2]:
            fail(f"phase 24: recall probe {probe}, its scans "
                 f"{[len(p[2]) for p in mine]}")
        if launches == 0 or probe["k"] != 10:
            fail(f"phase 24: the recall probe launched ivf_list_scan "
                 f"{launches} times: {probe}")
        qdisp, lists, row_ids, dispatch, kw = mine[0][2][0]
        kv, ki = scan(qdisp, lists, row_ids, dispatch, **kw)
        rv, ri = ivf_scan.ivf_list_scan_reference(qdisp, lists, row_ids,
                                                  dispatch, **kw)
        err = check_scan(kv, ki, rv, ri, True, qdisp, lists,
                         "ivf_list_scan int8, phase 24 recall probe's "
                         "dispatch")
        del kv, ki, rv, ri
        ms = cuda_ms(lambda: scan(qdisp, lists, row_ids, dispatch, **kw),
                     reps=10)
        plain_ms = cuda_ms(lambda: ivf_scan.ivf_list_scan_reference(
            qdisp, lists, row_ids, dispatch, **kw), reps=3, warmup=1)
        library_ms, lib_chunks = library_ms_of(qdisp, lists, kw["p"])
        live_n = ivf_scan.live_slots(dispatch)
        bound_ms, bound_by, c = roofline.scan_bound(
            row_ids, live_n, qdisp.shape[1], kw["p"], 1, qdisp.shape[2],
            "int8")
        live, qcap = int((dispatch >= 0).sum()), int(qdisp.shape[1])
        log(f"app split (24): POST /api/admin/engine/recall-probe on the "
            f"10M store (k 10, sample 32) in {http_ms:.1f} ms: recall@10 "
            f"{probe['recall']:.4f}; ivf_list_scan launches {launches} "
            f"(counter zeroed just before); its dispatch ({live} live "
            f"slots, qcap {qcap}, {c['lists_read']} lists read) "
            f"bit-identical to the plain version, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, torch.bmm+topk (f32, every slot, "
            f"{lib_chunks} list chunks) {library_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}) | {card}")
        del qdisp, lists, row_ids, dispatch, mine
        probes.clear()

        # 6. system counts against the sqlite rows
        _, counts = admin._request("GET", "/api/admin/system")
        with sqlite3.connect(db_path) as db:
            rows = {t: db.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                    for t in ("users", "stores", "documents", "query_log",
                              "chat_sessions")}
            by_status = dict(db.execute(
                "SELECT status, COUNT(*) FROM documents WHERE deleted_at IS"
                " NULL GROUP BY status").fetchall())
            jobs = dict(db.execute(
                "SELECT status, COUNT(*) FROM jobs GROUP BY status"
                ).fetchall())
            (chats,) = db.execute(
                "SELECT COUNT(*) FROM query_log q JOIN users u ON"
                " u.id = q.user_id WHERE u.email=? AND q.model != 'INDEX'",
                ("split@example.com",)).fetchone()
        if {t: counts.get(t) for t in rows} != rows \
                or counts.get("documents_by_status") != by_status \
                or counts.get("jobs") != jobs:
            fail(f"phase 24: /api/admin/system {counts} != sqlite {rows} "
                 f"{by_status} {jobs}")
        # 7. the user's costs count their chats
        _, costs = user._request("GET", "/api/costs/summary")
        if costs["queries"] != chats or chats != len(fact_ids) + 2:
            fail(f"phase 24: /api/costs/summary {costs}, query_log chats "
                 f"{chats}")
        # 8. branding settings round-trip
        want = {"app_name": "ragtpu on the card", "theme": "dark"}
        admin._request("PUT", "/api/settings", json_body=want)
        _, got = ApiClient(app.base)._request("GET", "/api/settings")
        if any(got["settings"].get(k) != v for k, v in want.items()):
            fail(f"phase 24: /api/settings {got}")
        # 9. the SPA
        static = ROOT / "rag_foundation_tpu_torch" / "app" / "static"
        for path, name in (("/", "index.html"),
                           ("/static/app.js", "app.js")):
            resp = ApiClient(app.base)._request("GET", path, stream=True)
            if resp.status != 200 or resp.read() != (
                    static / name).read_bytes():
                fail(f"phase 24: GET {path} did not serve {name}")
        log(f"app split (24): /api/admin/system equals the sqlite rows "
            f"({rows}, jobs {jobs}); costs count the user's {chats} chats "
            f"(month to date {costs['month_to_date_usd']} USD); settings "
            f"round-trip; / and /static/app.js served byte for byte | "
            f"{card}")

        # 10. the reference's load profile, in its own process
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "rag_foundation_tpu_torch.benchmark."
             "loadgen", "--base-url", app.base, "--users",
             str(LOADGEN_USERS), "--duration", str(LOADGEN_DURATION_S),
             "--think", str(LOADGEN_THINK_S), "--chat-ratio",
             str(LOADGEN_CHAT_RATIO), "--register", "--tmp",
             str(work / "load")], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
            capture_output=True, text=True, timeout=300)
        load_wall = time.perf_counter() - t
        if out.returncode != 0:
            fail(f"phase 24: loadgen exited {out.returncode}: "
                 f"{out.stderr[-2000:]}")
        load = json.loads(out.stdout)
        if any(load[task]["error_rate"] != 0 or not load[task]["requests"]
               for task in ("chat", "upload")):
            fail(f"phase 24: loadgen {load}")
        log(f"app split (24): loadgen {LOADGEN_USERS} users, "
            f"{LOADGEN_DURATION_S} s, think <= {LOADGEN_THINK_S} s, chat "
            f"share {LOADGEN_CHAT_RATIO} ({load_wall:.1f} s with start and "
            f"join): " + "; ".join(
                f"{task} {v['requests']} requests, {v['rps']:.2f} rps, ok "
                f"{v['ok_rps']:.2f} rps, p95 {v['latency_p95_s'] * 1e3:.1f} "
                f"ms, errors {v['errors']}" for task, v in load.items())
            + f" | {card}")

        # the workers' recall audit of the same store, same seed (an
        # audit begun before the body's adoption saw an empty store)
        t = time.perf_counter()
        while True:
            audits = [e for w in workers
                      for e in log_events(w.log_path.read_text(),
                                          "recall_audit")
                      if e["store"] == big_key and e["sample"]
                      and e["ts"] > t_adopted]
            if audits:
                break
            if time.perf_counter() - t > 120:
                fail("phase 24: no worker logged recall_audit for the 10M "
                     "store")
            time.sleep(0.5)
        cron = {k: audits[0][k] for k in ("recall", "sample", "k")}
        if cron != {k: probe[k] for k in cron}:
            fail(f"phase 24: the worker's recall_audit {cron} != the "
                 f"route's probe {probe}")
        failed = [e for w in workers for e in log_events(
            w.log_path.read_text(), "recall_audit_failed")]
        if failed:
            fail(f"phase 24: recall_audit_failed {failed[:2]}")
        for w in workers:
            text = w.stop()                 # SIGTERM to its group
            if w.proc.returncode != 0 or not log_events(text,
                                                        "worker_stopped"):
                fail(f"phase 24: a worker stopped with "
                     f"{w.proc.returncode}: {text[-2000:]}")
        log(f"app split (24): the workers' recall_audit of the 10M store "
            f"gives {cron}, as the route; {len(audits)} audits of it "
            f"logged; SIGTERM: both workers logged worker_stopped | {card}")
    finally:
        engine.recall_probe = real_probe
        tivf.ivf_list_scan = scan
        for w in workers:
            w.stop()
        log_text = app.stop()
        shutil.rmtree(work, ignore_errors=True)
    devices = started_devices(log_text)
    if not devices or set(devices) != {"remote"}:
        fail(f"phase 24: app_started devices {devices}")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s")
    entry = {"launches_app_admin": launches, "app_admin_probe": {
        "live_slots": live, "qcap": qcap,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "http_ms": http_ms,
        "recall": probe["recall"], "sample": probe["sample"],
        "k": probe["k"]}}
    return entry, {
        "api_processes": APP_API_PROCESSES,
        "worker_processes": APP_SPLIT_WORKERS,
        "upload_to_done_s": {"p50": pct(upload_s, 50),
                             "max": max(upload_s)},
        "jobs_per_worker": drained_by,
        "delete_to_unserved_ms": delete_ms,
        "restore_to_cited_s": restore_s,
        "probe": {"http_ms": http_ms, "recall": probe["recall"],
                  "kernel_ms": ms, "bound_ms": bound_ms},
        "loadgen": {task: {k: load[task][k] for k in
                           ("requests", "errors", "rps", "ok_rps",
                            "latency_p95_s")} for task in load}}


# -- phase 25: the app at the quality benchmark's production configurations --

QUALITY = ROOT / "benchmarks" / "quality"
BENCH_CONFIG = QUALITY / "benchmarks.yml"
# benchmarks/README.md's production configuration of the quality benchmark
# (summary_hybrid.json: "Production default config"): the hybrid encoder
# at 768 (MiniLM 384 from the checkpoint, the native hash channel 384)
PROD_APP = {
    "ENGINE_ENCODER": "hybrid", "ENGINE_DIM": "768",
    "ENGINE_ENCODER_CKPT": str(ROOT / "checkpoints" / "minilm_ict.npz"),
    "ENGINE_MIN_COVERAGE": "0.35", "ENGINE_CHUNK_TOKENS": "120",
    "ENGINE_CHUNK_OVERLAP": "24", "ENGINE_INDEX_MODE": "exact",
    "ENGINE_TOP_K": "5"}
# the generative tier at ab_summary.json's configuration
GEN_APP = {
    "ENGINE_GENERATOR": "generative",
    "ENGINE_GENERATOR_CKPT": str(ROOT / "checkpoints" / "decoder_distill.npz"),
    "ENGINE_ENCODER": "hash", "ENGINE_DIM": "384",
    "ENGINE_INDEX_MODE": "exact", "ENGINE_MIN_COVERAGE": "0.35",
    "ENGINE_CHUNK_TOKENS": "120", "ENGINE_CHUNK_OVERLAP": "24",
    "ENGINE_TOP_K": "5"}
# (a): both devices run MiniLM in bf16, which rounds at other places on
# the card than on the CPU; a hit's score moves by that rounding, within
# tests/test_torch_engine.py's ENC_TOL, and hits that close may swap
HYBRID_TIE = 5e-3
# (b): greedy ids may differ only at a step whose top-2 margin (the CPU's
# logits, the vocabulary bias added) is at most this
# (tests/test_torch_decoder.py's rule for bf16)
GEN_MARGIN = 0.25
GEN_CPU_BUDGET_S = 120.0  # (b): the CPU run's questions, as many as fit
BENCH_USER = ("chip@example.com", "Chip-Passw0rd-1")
GATE_OUTCOME = re.compile(
    r'^engine_calls_total\{op="generate",outcome="([a-z_]+)"\} (\S+)$', re.M)


class ShapeCapture(ShapeTally):
    """``ShapeTally`` that also keeps the inputs of the first launch of
    each (B, S): layer 0 of the first encode at that shape."""

    def __init__(self, fa):
        super().__init__(fa)
        self.inputs = {}

    def start(self) -> "ShapeCapture":
        super().start()
        tally = self.fa.flash_attention_forward

        def captured(q, k, v, seg_q, seg_kv, sm_scale, *a, **kw):
            key = (q.shape[0], q.shape[2])
            if q.device.type == "cuda" and key not in self.inputs:
                self.inputs[key] = tuple(t.clone() for t in (
                    q, k, v, seg_q, seg_kv)) + (sm_scale,)
            return tally(q, k, v, seg_q, seg_kv, sm_scale, *a, **kw)

        self.fa.flash_attention_forward = captured
        return self


def upload_quality_docs(base: str):
    """Register, make the benchmark's store and upload the ten quality
    documents through ``/api/upload``; (client, store, upload to DONE
    seconds)."""
    from rag_foundation_tpu_torch.benchmark.runner import (ApiClient,
                                                           read_bench_config)
    client = ApiClient.from_credentials(base, *BENCH_USER, register=True)
    client.poll_interval_s = 0.05
    name = read_bench_config(BENCH_CONFIG.read_text())["quality"]["store"]
    store = client.ensure_store(name)
    t0 = time.perf_counter()
    for path in sorted((QUALITY / "docs").glob("*.md")):
        st = client.upload_and_poll(store["id"], path)
        if st["status"] != "DONE":
            fail(f"phase 25: {path.name} {st}")
    return client, store, time.perf_counter() - t0


def bench_cli(base: str, bench: str, work: Path) -> tuple[list, dict]:
    """``python -m rag_foundation_tpu_torch.benchmark.runner --config
    benchmarks.yml --bench <bench>`` against the app at ``base`` (the
    documents are in already: ``--docs`` names an empty directory);
    (results, summary)."""
    import os
    out = work / f"bench-{bench}"
    empty = work / "no-docs"
    empty.mkdir(exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "rag_foundation_tpu_torch.benchmark.runner",
         "--base-url", base, "--email", BENCH_USER[0], "--password",
         BENCH_USER[1], "--config", str(BENCH_CONFIG), "--bench", bench,
         "--docs", str(empty), "--out-dir", str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"phase 25: benchmark.runner --bench {bench} exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    results = [json.loads(line) for line in (
        out / "results.jsonl").read_text().splitlines() if line.strip()]
    return results, json.loads((out / "summary.json").read_text())


def check_results(results: list, what: str) -> None:
    """Every chat answered, and every stream kept the SSE contract."""
    errors = [r for r in results if r.get("error")]
    if errors:
        fail(f"{what}: {len(errors)} chats failed: "
             f"{[r['error'] for r in errors][:3]}")
    broken = [r["question"] for r in results
              if not sse_contract_ok(r["frames"])]
    if broken:
        fail(f"{what}: SSE contract broken for {broken[:3]}")


def latency_line(results: list) -> dict:
    ttft = [r["ttft_s"] * 1e3 for r in results if r.get("ttft_s")]
    lat = [r["latency_s"] * 1e3 for r in results]
    return {"ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
            "answer_p50_ms": pct(lat, 50), "answer_p99_ms": pct(lat, 99)}


def quality_numbers(summary: dict, results: list) -> dict:
    return {**{k: summary[k] for k in ("em", "f1", "contains",
                                       "citation_hit", "refusal_ok")},
            **latency_line(results)}


def latency_text(n: dict) -> str:
    return (f"time to first delta p50 {n['ttft_p50_ms']:.2f} ms p99 "
            f"{n['ttft_p99_ms']:.2f} ms, answer p50 {n['answer_p50_ms']:.2f}"
            f" ms p99 {n['answer_p99_ms']:.2f} ms")


def numbers_text(n: dict) -> str:
    return (f"EM {n['em']:.4f} F1 {n['f1']:.4f} contains "
            f"{n['contains']:.4f} citation hit {n['citation_hit']:.4f} "
            f"refusal accuracy {n['refusal_ok']:.4f}, {latency_text(n)}")


def app_settings(extra: dict, data_dir: Path):
    """The app's ``Settings`` of a phase-25 deployment, built in this
    process (``APP_SETTINGS`` and ``extra``, as the app's processes read
    them)."""
    from rag_foundation_tpu_torch.app.config import Settings
    return Settings(**{**APP_SETTINGS, **extra}, DATA_DIR=str(data_dir))


def first_swap(engines: dict, query: str) -> tuple[int, float]:
    """(rank, |score difference|) where the two engines' top-128 for the
    query first differ; (-1, 0.0) where they do not."""
    hits = {dev: engine.search([key], query, k=128)
            for dev, (engine, key) in engines.items()}
    for rank, (a, b) in enumerate(zip(hits["cuda"], hits["cpu"])):
        if (a.doc_id, a.ordinal) != (b.doc_id, b.ordinal):
            return rank, abs(a.score - b.score)
    return -1, 0.0


def attention_buckets(fa, torch, inputs: dict, card) -> dict:
    """The forward kernel on the app's own layer-0 inputs of each (B, S)
    it launched at: held to the plain version, timed beside its bound,
    the plain version and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.utils import roofline
    out_by = {}
    for (b, s), (q, k, v, sq, skv, scale) in sorted(inputs.items()):
        out = fa.flash_attention(q, k, v, sq, skv, scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, sq, skv, scale)
        err, tol = check_attention(torch, out, ref, v, "bf16",
                                   f"flash_attention app B={b} S={s}")
        h, d = q.shape[1], q.shape[3]
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, sq, skv, scale),
                     reps=20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, sq, skv, scale), reps=5, warmup=1)
        mask = (sq[:, :, None] == skv[:, None, :])[:, None]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), reps=20)
        bound_ms, bound_by, c = roofline.attention_bound(sq, skv, h, d, 2)
        log(f"flash_attention bf16 on the hybrid app's layer-0 inputs, B={b}"
            f" H={h} S={s} D={d} ({c['pairs']} of {c['dense_pairs']} pairs "
            f"share a segment): max_abs_err={err:.3g} (tol {tol:.3g}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}) | {card}")
        out_by[f"{b},{s}"] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": library_ms}
    return out_by


def production_phase(args, card) -> tuple[dict, dict]:
    """Phase 25 (a): the app at the quality benchmark's production
    configuration (``PROD_APP``), on the card and on the CPU. Returns the
    phase's numbers and the forward kernel's entries on this path."""
    import torch
    from rag_foundation_tpu_torch.app.services.rag import (
        engine_config_from_settings, reformulate_query)
    from rag_foundation_tpu_torch.benchmark.runner import read_bench_config
    from rag_foundation_tpu_torch.engine import Engine
    from rag_foundation_tpu_torch.engine.rpc import EngineRpcServer
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    benches = ("quality", "quality_multiturn")
    config = read_bench_config(BENCH_CONFIG.read_text())
    asked = {b: [json.loads(line) for line in (
        QUALITY / config[b]["questions"]).read_text().splitlines()
        if line.strip()] for b in benches}
    runs, numbers, engines, works = {}, {}, {}, []
    for platform in ("cuda", "cpu"):
        work = Path(tempfile.mkdtemp(prefix=f"ragtpu-chip-prod-{platform}-"))
        works.append(work)
        extra, server = dict(PROD_APP), None
        settings = app_settings(extra, work / "data")
        if platform == "cuda":
            # the engine in this process, the app in connect mode in front
            # of it: the launches count here
            engine = Engine(engine_config_from_settings(settings,
                                                        device="cuda"))
            sock = str(work / "engine.sock")
            server = EngineRpcServer(engine, sock).start()
            extra.update(ENGINE_RPC_MODE="connect", ENGINE_RPC_SOCKET=sock)
        else:
            extra["ENGINE_PLATFORM"] = "cpu"
        app = AppProcess(work, extra)
        try:
            start_s = app.wait_live()
            if platform == "cuda":
                fa.LAUNCHES.reset()              # counts: this path only
                capture = ShapeCapture(fa).start()
            _, _, ingest_s = upload_quality_docs(app.base)
            if platform == "cuda":
                ingest_launches = fa.LAUNCHES.count
            out = {b: bench_cli(app.base, b, work) for b in benches}
            if platform == "cuda":
                launches = fa.LAUNCHES.count     # read just after
                by_shape = capture.stop()
        finally:
            log_text = app.stop()
            if server is not None:
                server.shutdown()
        devices = started_devices(log_text)
        want = "remote" if platform == "cuda" else "cpu"
        if not devices or not all(d == want for d in devices):
            fail(f"phase 25 (a) {platform}: app_started devices {devices}")
        if platform == "cuda":
            engines["cuda"] = (engine, engine.list_stores()[0])
        else:   # the CPU app's engine, restored here from its data dir
            restored = Engine(engine_config_from_settings(settings,
                                                          device="cpu"))
            engines["cpu"] = (restored, restored.list_stores()[0])
        runs[platform] = {b: out[b][0] for b in benches}
        numbers[platform] = {"ingest_s": ingest_s}
        for b in benches:
            check_results(out[b][0], f"phase 25 (a) {platform} {b}")
            numbers[platform][b] = quality_numbers(out[b][1], out[b][0])
            log(f"production app (a) {b} on {platform} (app {want}, started "
                f"in {start_s:.1f} s; ten documents uploaded and ingested in "
                f"{ingest_s:.2f} s), {len(out[b][0])} questions through "
                f"benchmark.runner --config: "
                f"{numbers_text(numbers[platform][b])} | {card}")
    if launches == 0 or ingest_launches == 0 \
            or launches == ingest_launches:
        fail(f"phase 25 (a): flash_attention launched {ingest_launches} "
             f"times on ingest and {launches - ingest_launches} on the "
             f"questions of the hybrid app")
    log(f"production app (a): flash_attention launches on the hybrid app "
        f"path {launches} (ingest {ingest_launches}, questions "
        f"{launches - ingest_launches}); by shape {capture.text()} | {card}")
    ties = []
    for b in benches:
        for q, a, c in zip(asked[b], runs["cuda"][b], runs["cpu"][b]):
            if (a["answer"], a["citations"]) == (c["answer"], c["citations"]):
                continue
            query = reformulate_query(q["question"], q.get("history"))
            rank, diff = first_swap(engines, query)
            log(f"production app (a) {b} differs on {q['question']!r}: card "
                f"{a['answer']!r} {a['citations']}, CPU {c['answer']!r} "
                f"{c['citations']}; the engines' hits first differ at rank "
                f"{rank}, scores {diff:.3g} apart")
            if rank < 0 or diff > HYBRID_TIE:
                fail(f"phase 25 (a): the card and the CPU differ on "
                     f"{q['question']!r} beyond a near-tie (rank {rank}, "
                     f"{diff}) | {card}")
            ties.append(diff)
    total = sum(len(asked[b]) for b in benches)
    log(f"production app (a): card and CPU answers and citations equal on "
        f"{total - len(ties)} of {total} questions, {len(ties)} near-ties "
        f"within {HYBRID_TIE} | {card}")
    ref = json.loads((ROOT / "benchmarks" / "results" / "quality" /
                      "summary_hybrid.json").read_text())["summary"]
    log(f"production app (a), for reference only (a JAX run on a CPU, "
        f"benchmarks/results/quality/summary_hybrid.json): EM "
        f"{ref['em']:.4f} F1 {ref['f1']:.4f} contains {ref['contains']:.4f} "
        f"citation hit {ref['citation_hit']:.4f} refusal accuracy "
        f"{ref['refusal_ok']:.4f}")
    buckets = attention_buckets(fa, torch, capture.inputs, card)
    del capture, engines, engine
    for work in works:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 25 (a): {time.perf_counter() - t_phase:.1f} s")
    return ({"questions": total, "near_ties": len(ties),
             "card": numbers["cuda"], "cpu": numbers["cpu"]},
            {"launches_app_hybrid": launches,
             "launches_app_hybrid_by_b_s": {f"{b},{s}": n for (b, s), n
                                            in by_shape.items()},
             "app_hybrid": buckets})


def gate_outcomes(base: str) -> dict:
    """{outcome: count} of the app's ``engine_calls_total{op="generate"}``
    (its ``/metrics``)."""
    import urllib.request
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    return {k: int(float(v)) for k, v in GATE_OUTCOME.findall(text)}


def decode_trace(torch, tdec, gens: dict, question, evidences,
                 card) -> float:
    """Where the card's and the CPU's greedy decodes of one prompt first
    part: the top-2 margin of the CPU's logits (bias added) at that step,
    fed the common prefix. Fails where they do not part."""
    import numpy as np
    ids, _, bias_np, card_out = greedy_answer(
        gens["cuda"], tdec, torch, np, question, evidences)
    _, _, _, cpu_out = greedy_answer(gens["cpu"], tdec, torch, np, question,
                                     evidences, device="cpu")
    step = next((j for j, (a, b) in enumerate(zip(card_out, cpu_out))
                 if a != b), None)
    if step is None:
        fail(f"phase 25 (b): the answers to {question!r} differ, the "
             f"card's and the CPU's greedy ids do not | {card}")
    gen = gens["cpu"]
    seq = torch.tensor([ids + cpu_out[:step]])
    with torch.inference_mode():
        row = tdec.forward(gen.params, seq, gen.cfg)[0, -1].float().numpy()
    top2 = np.sort(row + bias_np)[-2:]
    return float(top2[1] - top2[0])


def generative_app_phase(args, card) -> dict:
    """Phase 25 (b): the app's generative tier (``GEN_APP``, the decoder
    in the app's process) on the card over the 120 quality questions, and
    on the CPU over as many as ``GEN_CPU_BUDGET_S`` allows."""
    import torch
    from rag_foundation_tpu_torch.app.services.rag import (
        EngineRag, engine_config_from_settings, reformulate_query)
    from rag_foundation_tpu_torch.benchmark.runner import run_benchmark
    from rag_foundation_tpu_torch.engine import Engine
    from rag_foundation_tpu_torch.models import decoder as tdec
    t_phase = time.perf_counter()
    questions = [json.loads(line) for line in (
        QUALITY / "questions.jsonl").read_text().splitlines()
        if line.strip()]
    runs, outcomes, numbers, works = {}, {}, {}, {}
    for platform in ("cuda", "cpu"):
        work = Path(tempfile.mkdtemp(prefix=f"ragtpu-chip-gen-{platform}-"))
        works[platform] = work
        extra = dict(GEN_APP)
        if platform == "cpu":
            extra["ENGINE_PLATFORM"] = "cpu"
        app = AppProcess(work, extra)
        try:
            start_s = app.wait_live()
            client, store, ingest_s = upload_quality_docs(app.base)
            t0 = time.perf_counter()
            if platform == "cuda":
                results, _ = bench_cli(app.base, "quality", work)
            else:      # as many questions as the budget allows, 8 a round
                results = []
                while len(results) < len(questions) \
                        and time.perf_counter() - t0 < GEN_CPU_BUDGET_S:
                    results += run_benchmark(
                        client, store["id"],
                        questions[len(results):len(results) + 8],
                        concurrency=4, top_k=5)["results"]
            wall = time.perf_counter() - t0
            outcomes[platform] = gate_outcomes(app.base)
        finally:
            log_text = app.stop()
        devices = started_devices(log_text)
        if not devices or not all(d.startswith(platform) for d in devices):
            fail(f"phase 25 (b) {platform}: app_started devices {devices}")
        check_results(results, f"phase 25 (b) {platform}")
        errors = {k: n for k, n in outcomes[platform].items()
                  if k.endswith("_engine_error") and n}
        if errors or not outcomes[platform]:
            fail(f"phase 25 (b) {platform}: gate outcomes "
                 f"{outcomes[platform]} | {card}")
        runs[platform] = results
        numbers[platform] = {**latency_line(results), "ingest_s": ingest_s,
                             "questions": len(results), "wall_s": wall,
                             "outcomes": outcomes[platform]}
        log(f"generative app (b) on {devices[0]} (decoder_distill.npz, "
            f"started in {start_s:.1f} s): {len(results)} questions in "
            f"{wall:.2f} s, {latency_text(numbers[platform])}; gate "
            f"outcomes {outcomes[platform]} | {card}")
    tokenizer = tdec.load_decoder(GEN_APP["ENGINE_GENERATOR_CKPT"],
                                  device="cpu")[2]
    pieces = sum(len(tokenizer.encode_text(r["answer"]))
                 for r in runs["cuda"])
    answer_s = sum(r["latency_s"] for r in runs["cuda"])
    numbers["cuda"]["answer_tokens_s"] = pieces / answer_s
    jax_ab = json.loads((ROOT / "benchmarks" / "results" / "quality" /
                         "ab_summary.json").read_text())
    log(f"generative app (b) on the card: {pieces} answer tokens (the "
        f"decoder's tokenizer, over all 120 streamed answers, generated "
        f"or the span reader's) in {answer_s:.2f} s of summed answer "
        f"latency = {numbers['cuda']['answer_tokens_s']:.1f} tokens/s; gate "
        f"outcomes "
        f"{outcomes['cuda']} beside the JAX CPU run's (ab_summary.json, for "
        f"reference) {jax_ab['generative_gate_outcomes']} | {card}")
    covered = len(runs["cpu"])
    differ = [(q, a, c) for q, a, c in zip(questions, runs["cuda"],
                                           runs["cpu"])
              if (a["answer"], a["citations"]) != (c["answer"],
                                                   c["citations"])]
    margins = []
    if differ:
        # each device's deployment restored here, the app's own pipeline
        # in process: the evidences it hands the decoder, then both decodes
        rags, gens = {}, {}
        for dev in ("cuda", "cpu"):
            settings = app_settings(GEN_APP, works[dev] / "data")
            engine = Engine(engine_config_from_settings(settings, device=dev))
            rags[dev] = (EngineRag(settings, engine=engine),
                         engine.list_stores()[0])
            gens[dev] = engine._text_generator()
        for q, a, c in differ:
            prompts = {}
            for dev, (rag, key) in rags.items():
                seen = []
                real = rag.engine.generate_stream

                def spy(question, evidences, *, _seen=seen, _real=real,
                        **kw):
                    _seen.append((question, list(evidences)))
                    yield from _real(question, evidences, **kw)

                rag.engine.generate_stream = spy
                it, _ = rag.ask_stream(q["question"], [key], model="chip")
                "".join(it)
                rag.engine.generate_stream = real
                prompts[dev] = seen
            if prompts["cuda"] != prompts["cpu"]:
                engines = {dev: (rag.engine, key)
                           for dev, (rag, key) in rags.items()}
                rank, diff = first_swap(engines,
                                        reformulate_query(q["question"], None))
                if rank < 0 or diff > SCORE_TIE:
                    fail(f"phase 25 (b): the decoder's evidences differ on "
                         f"{q['question']!r} beyond a near-tie of the hits "
                         f"(rank {rank}, {diff}) | {card}")
                log(f"generative app (b) differs on {q['question']!r}: the "
                    f"hits swap at rank {rank}, scores {diff:.3g} apart")
                continue
            if not prompts["cuda"]:
                fail(f"phase 25 (b): the answers to {q['question']!r} "
                     f"differ and neither reached the decoder | {card}")
            question, evidences = prompts["cuda"][0]
            margin = decode_trace(torch, tdec, gens, question, evidences,
                                  card)
            log(f"generative app (b) differs on {q['question']!r}: card "
                f"{a['answer']!r}, CPU {c['answer']!r}; the greedy decodes "
                f"part at a step whose top-2 margin is {margin:.4f} (limit "
                f"{GEN_MARGIN})")
            if margin > GEN_MARGIN:
                fail(f"phase 25 (b): the card's and the CPU's decodes of "
                     f"{q['question']!r} part at a margin of {margin} | "
                     f"{card}")
            margins.append(margin)
        del rags, gens
    log(f"generative app (b): the CPU covered {covered} of "
        f"{len(questions)} questions in {numbers['cpu']['wall_s']:.1f} s "
        f"(budget {GEN_CPU_BUDGET_S:.0f} s); card and "
        f"CPU answers and citations equal on {covered - len(differ)} of "
        f"them, {len(differ)} parting at a near-tie (hits within "
        f"{SCORE_TIE}, or a decode step of margin <= {GEN_MARGIN}) | {card}")
    for work in works.values():
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 25 (b): {time.perf_counter() - t_phase:.1f} s")
    return {"covered_on_cpu": covered, "differ": len(differ),
            "margins": margins, "card": numbers["cuda"],
            "cpu": numbers["cpu"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="int8 store size after padding (default 10M)")
    ap.add_argument("--pq-rows", type=int, default=10_000_000,
                    help="ivf_pq store size after padding (default 10M)")
    ap.add_argument("--exact-rows", type=int, default=1_000_000,
                    help="rows of the exact scan and of the host-streamed "
                         "scan (default 1M)")
    ap.add_argument("--docs", type=int, default=400,
                    help="real documents ingested before padding")
    ap.add_argument("--long-docs", type=int, default=8,
                    help="long documents (257 chunks each) of phase 13")
    ap.add_argument("--corpus-passages", type=int, default=6000,
                    help="passages of phase 15's ICT corpus")
    ap.add_argument("--train-steps", type=int, default=300,
                    help="steps of phase 15's training run")
    ap.add_argument("--decoder-steps", type=int, default=300,
                    help="steps of phase 20's decoder training (recipe "
                         "4000)")
    ap.add_argument("--decoder-triples", type=int, default=6000,
                    help="triples of phase 20 (recipe 60000)")
    ap.add_argument("--decoder-eval", type=int, default=64,
                    help="eval questions of phase 20 (recipe 128)")
    ap.add_argument("--lengths-out", default=None,
                    help="write phase 15's layer-0 row lengths (JSON by S) "
                         "here, for time_kernels --lengths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "rag_foundation_tpu_torch").is_dir():
        fail("rag_foundation_tpu_torch/ not found beside chip_smoke.py: run "
             "it from a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card")
    sys.path.insert(0, str(ROOT))
    from rag_foundation_tpu_torch.engine import ivf as tivf
    from rag_foundation_tpu_torch.engine import ivfpq as tpq
    from rag_foundation_tpu_torch.engine.api import Engine, EngineConfig
    from rag_foundation_tpu_torch.engine.archive import HostArchive
    from rag_foundation_tpu_torch.engine.ivf import ivf_search, scan_inputs
    from rag_foundation_tpu_torch.engine.profile import search_profile
    from rag_foundation_tpu_torch.engine.rpc import (EngineRpcServer,
                                                     RemoteEngine)
    from rag_foundation_tpu_torch.ops import (cuda_lib, flash_attention,
                                              gather, ivf_scan, pq_scan,
                                              quantize)
    from rag_foundation_tpu_torch.parallel import sharded_ivf as sivf
    from rag_foundation_tpu_torch.parallel.mesh import make_mesh
    from rag_foundation_tpu_torch.utils import roofline

    # -- phase 1: card and build -------------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(host_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_names = ["ivf_list_scan", "pq_list_scan", "gather_rescore_int8",
                    "block_topk", "fused_topk", "flash_attention",
                    "flash_attention_bwd"]
    report = cuda_lib.build(kernel_names)
    for name, r in report.items():
        log(f"build {name}: {r['seconds']:.2f} s")
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    for name in kernel_names:
        cuda_lib.load(name)

    # -- phase 2: kernels vs plain versions, small size ---------------------
    phase_small_kernels(ivf_scan, torch)
    phase_small_pq_kernels(pq_scan, gather, torch)
    phase_edge_kernels(ivf_scan, pq_scan, torch)

    # -- phase 3: the main path through the RPC entry point -----------------
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-")
    sock = str(Path(data_dir) / "engine.sock")
    # a 20 ms admission window: 64 closed-loop clients then coalesce into
    # batches past the Q*nprobe*8 > nlist crossover (with 2 ms they
    # stagger into batches of one or two and never leave the small path).
    # build_threshold below --docs: the real documents build an int8
    # body, which the store saves and the restart reloads
    cfg = dict(dim=768, index_mode="ivf_flat_int8", nlist=4096, nprobe=32,
               ivf_p=3, batch_window_s=0.02, build_threshold=256,
               data_dir=data_dir, device="cuda")
    key = "stores/chip-smoke"
    rng = np.random.default_rng(args.seed)
    sampled = [int(i) for i in rng.choice(args.docs, size=64, replace=False)]
    ivf_scan.LAUNCHES.reset()                      # counts: main path only
    engine = Engine(EngineConfig(**cfg))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    try:
        remote.create_store(key)
        t0 = time.perf_counter()
        for i in range(args.docs):
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        seg = engine._store(key).segment
        saved = seg.body
        if saved is None or saved.lists.dtype != torch.int8:
            fail("the real documents built no int8 body")
        saved = (saved.lists.clone(), saved.row_ids.clone(), saved.scale)
        log(f"ingested {args.docs} documents in "
            f"{time.perf_counter() - t0:.2f} s "
            f"({remote.store_stats(key)['chunks']} chunks; int8 body of "
            f"{int((saved[1] >= 0).sum())} rows, nlist {saved[1].shape[0]},"
            f" tail {seg.tail.count})")
        before_pad = {i: remote.search([key], fact_query(i), k=5)
                      for i in sampled}
        for i, hits in before_pad.items():
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"before padding: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")

        n_pad = args.rows - args.docs
        t0 = time.perf_counter()
        remote.pad_store(key, n_pad, seed=args.seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        body = seg.body
        body_bytes = (body.lists.numel() * body.lists.element_size()
                      + body.row_ids.numel() * 4 + body.centroids.numel() * 4)
        mean_list = body.n / body.nlist
        log(f"store rows {args.rows} (pad {n_pad}) d=768: device build "
            f"{build_s:.2f} s = {args.rows / build_s:,.0f} vec/s; body "
            f"nlist={body.nlist} cap_len={body.cap_len} live={body.n} "
            f"(mean list {mean_list:.1f}, cap_len/mean "
            f"{body.cap_len / mean_list:.3f}) bytes={body_bytes} "
            f"({body_bytes / 2**30:.2f} GiB; live int8 rows "
            f"{body.n * 768 / 2**30:.2f} GiB) | {card}")

        # single searches (Q=1: the small-batch path at nlist=4096)
        lat = []
        prom0 = prom_samples(remote.metrics_text())
        for i in sampled * 3:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"padded store: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        prom1 = prom_samples(remote.metrics_text())
        sent = {k: prom1.get(f"engine_search_batch_size_{k}", 0.0)
                - prom0.get(f"engine_search_batch_size_{k}", 0.0)
                for k in ("count", "sum")}
        stages = sorted(k for k in prom1 if k.startswith(
            "engine_query_stage_seconds_count"))
        log(f"metrics_text over RPC: engine_search_batch_size_count +"
            f"{sent['count']:.0f}, _sum +{sent['sum']:.0f} over "
            f"{len(lat)} sequential searches; stage series {stages}")
        if sent["count"] != len(lat) or sent["sum"] != len(lat):
            fail(f"metrics_text: batch-size histogram moved by {sent}, "
                 f"{len(lat)} searches sent")
        if len(stages) != 3:
            fail(f"metrics_text: stage series {stages}")
        p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
        log(f"single search over RPC: p50 {p50:.3f} ms p99 {p99:.3f} ms "
            f"({len(lat)} searches; a lone request waits out the "
            f"{cfg['batch_window_s'] * 1e3:.0f} ms admission window) | {card}")
        qv1 = engine.encoder.encode([fact_query(i) for i in sampled])
        lat1, served = [], []
        for i in range(len(sampled)):
            t0 = time.perf_counter()
            served.append(seg.search(qv1[i:i + 1], 10)[1][0])
            lat1.append((time.perf_counter() - t0) * 1e3)
        log(f"StoreIndex.search Q=1 in process (no RPC, no window): p50 "
            f"{np.percentile(lat1, 50):.3f} ms p99 "
            f"{np.percentile(lat1, 99):.3f} ms | {card}")
        # recall@10 of the single-search path on the fact questions
        exact = seg.exact_reference_search(qv1, 10)
        fact_recall = float(np.mean([
            len(set(a[a >= 0]) & set(b[b >= 0])) / 10
            for a, b in zip(served, exact)]))
        log(f"recall@10 of fact questions (Q=1 path) vs "
            f"exact_reference_search: {fact_recall:.4f} "
            f"({len(sampled)} questions) | {card}")
        if fact_recall < RECALL_MIN:
            fail(f"fact-question recall@10 {fact_recall} < {RECALL_MIN}")

        # concurrent searches: the micro-batcher forms Q*nprobe*8 > nlist
        # batches, which take the list-scan kernel. Like the JAX engine,
        # a batch drops the probes past a list's default qcap, so similar
        # questions in one batch can lose their answer: counted, not
        # asserted
        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 24)]
        launches0 = ivf_scan.LAUNCHES.count
        search_profile.reset()
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        batches = search_profile.snapshot().get("body_dispatch",
                                                {"n": 0})["n"]
        right = sum(1 for i, h in zip(qids, hits)
                    if h and h[0].doc_id == f"doc-{i}")
        conc_launch = ivf_scan.LAUNCHES.count - launches0
        log(f"concurrent search over RPC: {threads} threads, {len(qids)} "
            f"queries in {wall:.3f} s = {len(qids) / wall:,.1f} QPS; "
            f"{batches} batches (mean {len(qids) / max(1, batches):.1f} "
            f"queries), kernel launches {conc_launch}; right top hit "
            f"{right}/{len(qids)} ({right / len(qids):.4f}) | {card}")
        if conc_launch == 0:
            fail("concurrent batches never reached the list-scan kernel")

        # one Q=1024 batch (int8 query transport, qcap from the batch)
        bq = [fact_query(int(i)) for i in rng.integers(0, args.docs, 1024)]
        remote.search_batch(key, bq[:64], k=10)          # warm shapes
        t0 = time.perf_counter()
        scores, ids = remote.search_batch(key, bq, k=10)
        bwall = time.perf_counter() - t0
        if scores.shape != (1024, 10):
            fail(f"search_batch returned {scores.shape}")
        log(f"search_batch Q=1024 over RPC (encode included): "
            f"{bwall * 1e3:.1f} ms = {1024 / bwall:,.0f} QPS; top score "
            f"finite for {int(np.isfinite(scores[:, 0]).sum())}/1024 | {card}")

        probe = remote.recall_probe(key, k=10, sample=64)
        if probe["recall"] is None:
            fail(f"recall_probe {probe}")
        main_launches = ivf_scan.LAUNCHES.count    # read just after
        log(f"recall_probe@10 (stored rows, nearly all pads) vs "
            f"exact_reference_search: {probe['recall']:.4f} "
            f"(sample {probe['sample']}) | {card}")
        log(f"main path kernel launches: ivf_list_scan {main_launches}; "
            f"device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            f" | {card}")
        if main_launches == 0:
            fail("the main path never launched ivf_list_scan")

        # the index alone on the same batch (no RPC, no encode)
        qv = engine.encoder.encode(bq)
        seg.search(qv, 10)
        t0 = time.perf_counter()
        for _ in range(5):
            seg.search(qv, 10)
        dwall = (time.perf_counter() - t0) / 5
        fact_drop = int(scan_inputs(body, torch.as_tensor(qv, device="cuda"),
                                    32)[3])
        log(f"StoreIndex.search Q=1024 in process: {dwall * 1e3:.2f} ms = "
            f"{1024 / dwall:,.0f} QPS; probes dropped by qcap "
            f"{fact_drop}/{1024 * 32} | {card}")

        # phase 5 input: a batch of 1024 stored rows (uniform traffic)
        probe_rows, probe_ids = seg.sample_live_rows(1024,
                                                     seed=args.seed + 1)
        body_cids = seg.body_chunk_ids                   # phase 17
        seg.search(probe_rows, 10)
        t0 = time.perf_counter()
        for _ in range(5):
            seg.search(probe_rows, 10)
        swall = (time.perf_counter() - t0) / 5
        log(f"StoreIndex.search Q=1024 stored rows in process (host "
            f"clock, int8 transport, tail merge): {swall * 1e3:.2f} ms = "
            f"{1024 / swall:,.0f} QPS | {card}")
    finally:
        remote.close()
        server.shutdown()

    # -- phase 4: restart on the same data_dir -------------------------------
    del engine, seg, remote, server       # body stays alive for phase 5
    gc.collect()
    engine2 = Engine(EngineConfig(**cfg))
    server2 = EngineRpcServer(engine2, sock, allow_pad=True).start()
    remote2 = RemoteEngine(sock)
    try:
        back = engine2._store(key).segment.body
        if back is None or not (torch.equal(back.lists, saved[0])
                                and torch.equal(back.row_ids, saved[1])
                                and back.scale == saved[2]):
            fail("restart: the reloaded int8 body differs from the saved one")
        for i in sampled:
            again = remote2.search([key], fact_query(i), k=5)
            if again != before_pad[i]:
                fail(f"restart: hits for project {i} differ")
        log(f"restart: body.npz reloaded verbatim on the card (lists, ids, "
            f"scale); {len(sampled)} queries give the same hits (the store "
            f"as saved; pads are not persisted)")
    finally:
        remote2.close()
        server2.shutdown()
    del engine2, remote2, server2, back, saved
    gc.collect()

    # -- phase 5: kernel vs plain on the main path's dispatch, with times ---
    # a Q=1024 batch of stored rows, routed and inverted by the engine's
    # own code, dispatch included (empty slots are skipped)
    p = 3
    _, dispatch, _, dropped, qdisp, s = scan_inputs(
        body, torch.as_tensor(probe_rows, device="cuda"), 32)
    lists, row_ids = body.lists, body.row_ids
    nlist, qcap, d = qdisp.shape
    cap_len = lists.shape[1]
    live_n = ivf_scan.live_slots(dispatch)
    kv, ki = ivf_scan.ivf_list_scan(qdisp, lists, row_ids, dispatch, p=p,
                                    scale=s)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.ivf_list_scan_reference(qdisp, lists, row_ids,
                                              dispatch, p=p, scale=s)
    max_err = check_scan(kv, ki, rv, ri, True, qdisp, lists,
                         "ivf_list_scan int8 main")
    del kv, ki, rv, ri
    ms = cuda_ms(lambda: ivf_scan.ivf_list_scan(
        qdisp, lists, row_ids, dispatch, p=p, scale=s), reps=10)
    plain_ms = cuda_ms(lambda: ivf_scan.ivf_list_scan_reference(
        qdisp, lists, row_ids, dispatch, p=p, scale=s), reps=2, warmup=1)
    library_ms, lib_chunks = library_ms_of(qdisp, lists, p)
    bound_ms, bound_by, c = roofline.scan_bound(row_ids, live_n, qcap, p, 1, d,
                                       "int8")
    log(f"ivf_list_scan int8 main path, Q=1024 stored rows: nlist={nlist} "
        f"qcap={qcap} (dropped {int(dropped)}) cap_len={cap_len} d={d} "
        f"p={p}, {c['lists_read']} lists with queries, {c['live_slots']} "
        f"live slots, {c['rows_needed']} live rows of "
        f"{c['rows_in_lists_read']}: bit-identical; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.bmm+topk (f32, every slot, "
        f"{lib_chunks} list chunks) {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}) | {card}")
    # the same Q=1024 search split by stage, as StoreIndex runs it (int8
    # transport with the body's scale, k=10 -> fetch 16)
    qj = torch.as_tensor(np.clip(np.round(probe_rows / np.float32(
        body.scale)), -127, 127).astype(np.int8), device="cuda")
    stage_split(
        torch, lambda: ivf_search(body, qj, 16, nprobe=32, p=p),
        [(tivf, "scan_inputs", "after"), (tivf, "ivf_list_scan", "after")],
        ["coarse + dispatch", "list scan", "regather and top-k"], card,
        "ivf_flat_int8 search of Q=1024 stored rows (ivf_search, split by "
        "CUDA events between its stages in one call)")
    del qj

    # -- phase 19: the app's engine calls over the same body ----------------
    ivf_app, app_calls = app_calls_phase(
        args, card, (cfg, key, sock, body, body_cids, sampled, rng),
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine, tivf,
         ivf_scan))
    gc.collect()

    # -- phase 23: the port's app on the card --------------------------------
    app_inproc = app_inprocess_phase(args, card)
    ivf_app_chat, app_split, app_chat = app_connect_phase(
        args, card, (cfg, key, sock, body, body_cids, sampled, rng),
        (Engine, EngineConfig, EngineRpcServer, tivf, ivf_scan))
    gc.collect()

    # -- phase 17: the sharded engine over the same body ---------------------
    ivf_sharded = mesh_flat_phase(
        args, card, (cfg, key, sock, body, body_cids, qv1, exact, probe_rows,
                     probe_ids, sampled, rng),
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
         make_mesh, sivf, tivf, ivf_scan, roofline))

    # -- phase 21: processes joined into one mesh over the same body ---------
    pod = pod_phase(args, card, body, qv)
    shutil.rmtree(data_dir, ignore_errors=True)
    # release the int8 store before the ivf_pq phases (the servers'
    # handler threads, which hold their engine, end once their clients'
    # connections are closed)
    del body, lists, row_ids, qdisp, dispatch, live_n
    time.sleep(0.5)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"int8 store released: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # -- phases 6-8: the ivf_pq store -----------------------------------------
    pq_kernels, host_rerank = pq_phases(
        args, card, rng, sampled,
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
         HostArchive, tpq, pq_scan, gather, quantize))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ivf_pq store released: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # -- phases 9-11: the exact flat scan --------------------------------------
    exact_kernels = exact_phases(args, card)

    # -- phases 12-13: the MiniLM encoder and its attention kernel ------------
    phase_small_attention(flash_attention, torch)
    attn_kernel = encoder_phases(
        args, card, rng, sampled,
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine))

    # -- phases 14-15: encoder training and the attention backward kernels ---
    phase_small_attention_bwd(flash_attention, torch)
    corpus_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-corpus-")
    corpus = build_corpus(args, corpus_dir)
    bwd_kernels, fwd_train = train_phases(args, card, rng, sampled, corpus,
                                          (Engine, EngineConfig))
    attn_kernel.update(fwd_train)

    # -- phase 22: the sharded training step -------------------------------
    dp_train = sharded_train_phase(args, card, corpus)

    # -- phase 16: the generative chat path -------------------------------
    attn_kernel["launches_generative_chat"] = generator_phase(
        args, card, sampled,
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine))

    # -- phase 20: the generative decoder's trainer ---------------------------
    decoder_train_phase(args, card, corpus)
    shutil.rmtree(corpus_dir, ignore_errors=True)

    # -- phase 25: the app at the quality benchmark's production configs ---
    production, attn_app = production_phase(args, card)
    attn_kernel.update(attn_app)
    generative_app = generative_app_phase(args, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = {"kernels": [{
        "name": "ivf_list_scan",
        "route": "cuda",
        "source": "rag_foundation_tpu_torch/csrc/ivf_list_scan.cu",
        "replaces": "rag_foundation_tpu/ops/pallas_ivf.py:101",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "dtype": "int8",
        "shape": {"nlist": nlist, "qcap": qcap, "cap_len": cap_len, "d": d,
                  "p": p, **c},
        **ivf_sharded,
        **ivf_app,
        **ivf_app_chat,
        "launches_pod": pod["ivf_list_scan"],
        "pod_shard": pod["ivf_shard"],
    }] + pq_kernels + exact_kernels + [attn_kernel] + bwd_kernels}
    # phase 21's launches in each of its two processes; phase 22's in one
    # sharded training step
    for entry in kernels["kernels"]:
        if entry["name"] == "pq_list_scan":
            entry["launches_pod"] = pod["pq_list_scan"]
            entry["pod_shard"] = pod["pq_shard"]
        if entry["name"] in dp_train:
            entry["launches_sharded_train_step"] = dp_train[entry["name"]]
            entry["max_abs_err_sharded_train_step"] = \
                dp_train["max_abs_err"][entry["name"]]
    # the host shim's and the app calls' numbers, apart from the kernels
    print(json.dumps({"host_shim": {"host_rerank": host_rerank,
                                    "ingest_chunks_s": app_calls.pop(
                                        "ingest_chunks_s"),
                                    "ingest_save_s": app_calls.pop(
                                        "ingest_save_s"),
                                    "encode_chunks_s": app_calls.pop(
                                        "encode_chunks_s")},
                      "app_calls": app_calls,
                      "app": {"in_process": app_inproc,
                              "connect": app_chat,
                              "split": app_split,
                              "production": production,
                              "generative": generative_app}}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
