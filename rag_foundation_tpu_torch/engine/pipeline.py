"""Pipelined ingestion: overlap host encoding with device inserts.

The PP-analog from SURVEY.md §2.4: ingestion is a host-chunking ->
encode -> insert pipeline. For large documents, a producer thread
encodes batch i+1 while the device executes the (async-dispatched)
insert of batch i — double buffering across the host->device boundary.
Bounded queue keeps memory flat; any stage error propagates.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Sequence

import numpy as np

_SENTINEL = object()


def pipelined_ingest(
    encode: Callable[[list[str]], np.ndarray],
    insert: Callable[[np.ndarray, np.ndarray], None],
    texts: Sequence[str],
    ids: np.ndarray,
    *,
    batch_size: int = 256,
    depth: int = 2,
) -> int:
    """Encode ``texts`` in batches on a producer thread while ``insert``
    consumes on the caller thread. Returns the number of rows inserted."""
    n = len(texts)
    if n == 0:
        return 0
    if n <= batch_size:
        insert(encode(list(texts)), np.asarray(ids))
        return n

    q: queue.Queue = queue.Queue(maxsize=depth)
    error: list[BaseException] = []

    def producer():
        try:
            for start in range(0, n, batch_size):
                batch = list(texts[start : start + batch_size])
                vecs = encode(batch)
                q.put((vecs, np.asarray(ids[start : start + batch_size])))
        except BaseException as e:  # noqa: BLE001 — crossed to consumer
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True,
                         name="ragtpu-ingest-encode")
    t.start()
    inserted = 0
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            vecs, batch_ids = item
            insert(vecs, batch_ids)  # async dispatch overlaps next encode
            inserted += len(batch_ids)
    finally:
        # drain on consumer failure too: the producer blocks on the
        # bounded q.put holding encoded batches — without this, an
        # insert error leaks the thread and its pinned memory forever
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
    if error:
        raise error[0]
    return inserted
