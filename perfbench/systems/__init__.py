"""Adapters that build the system under test, one file a ``mode`` of
the configurations (``systems/<mode>.py``): for a search configuration
``build(cfg, corpus, device) -> Built``; for a generation configuration
(``kind: "generate"``) ``load(cfg, root, device)``, an object with
``widths`` (the architecture it loaded), ``serve(feed)`` (answers the
requests ``feed.take()`` hands it, at most ``feed.concurrency`` at once,
until it hands none; see ``generate.py``) and ``free()``. With the
harness's read of the program's ``search_profile`` spans, they are the
benchmark's only imports of the port."""

from __future__ import annotations

import torch


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Built:
    """A built ``StoreIndex`` (chunk id = corpus row) and its build's
    seconds, the device synchronised on both sides."""

    def __init__(self, store, build_s: float, stored_rows, spill: bool,
                 codes=None):
        self.store = store
        self.build_s = build_s
        self._stored_rows = stored_rows
        self.spill = spill
        self._codes = codes

    def state(self, sample: torch.Tensor) -> dict:
        """Copies of what the reference follows and checks: the body's
        centroids and rows by list, the exact tail's rows, and the rows
        ``sample`` as the body stores them; for product-quantized lists
        also the codebook and the codes (not copied: the reference reads
        them after the rest of the program is freed)."""
        body = self.store.body
        tail = torch.as_tensor(self.store.tail.state()["ids"],
                               dtype=torch.int64, device=sample.device)
        state = {"centroids": body.centroids.float().clone(),
                 "list_rows": body.row_ids.clone(),
                 "tail_rows": tail,
                 "stored": self._stored_rows(self.store, sample).clone()}
        if self._codes is not None:
            state.update(self._codes(self.store))
        return state

    def describe(self) -> str:
        """The built body's shape, for the run's log."""
        body = self.store.body
        live = (body.row_ids >= 0).sum(dim=1).float()
        mean = float(live.mean())
        return (f"body nlist {body.row_ids.shape[0]} cap_len "
                f"{body.row_ids.shape[1]} (cap_len/mean "
                f"{body.row_ids.shape[1] / mean:.3f}; largest list "
                f"{int(live.max())}, mean {mean:.1f}, smallest "
                f"{int(live.min())}), tail {self.store.tail.count}, build "
                f"{self.build_s:.3f} s")
