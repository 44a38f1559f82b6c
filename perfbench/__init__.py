"""The benchmark of the PyTorch and CUDA port (``rag_foundation_tpu_torch``).

One run is one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix)::

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A search cell makes the corpus and the queries on the card from the
seed, builds the index through the port's own build entry, warms the
cell's shapes, drives ``StoreIndex.search_many`` for the measured window,
checks what the window served against the plain reference
(``reference.py``), and prints one JSON line. A generation cell (its
configuration's ``kind`` is ``"generate"``, ``generate.py``) loads the
model, serves seeded prompts (``prompts.py``) through the port's own
serving loop and judges the answers by their logits against a plain
float32 reference (``reference_decoder.py``). Configurations, traffic
mixes, adapters and per-layer metric readers are files of their own
(``configs/``, ``traffic/``, ``systems/``, ``metrics/``), found by the
names in ``BENCHMARK.json``.

Nothing here imports JAX or the JAX package; the reference modules
(``corpus.py``, ``reference.py``, ``reference_decoder.py``,
``compare.py``, ``roofline.py``, ``prompts.py``) import nothing of the
port.
"""
