"""Upload progress state machine — executable spec for the poll loop in
static/stores.js (``uploadFileInto``, reference hooks/useUploads.ts).

Twin pairing (same pattern as utils/sse.py ↔ static/sse.js): the JS
renders DOM; this module carries the identical transition logic so the
behavior executes under test (tests/test_torch_frontend.py drives it
with the port app's live /api/upload + op-status responses).

Per-file lifecycle:
  uploading… → "<status>… <secs>s" while polling (PENDING/RUNNING)
             → "done (<chunks> chunks, <secs>s)"  [removed after 1.5 s]
             → "error: <error|status>"  on done-with-ERROR
             → "error: <message>"       on poll/upload failure
The shared ``active`` counter gates the caller's onDone refresh
(stores.js ``finish``/``onDone``: re-render only when it hits 0).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class UploadItem:
    filename: str
    phase: str = "uploading…"
    error: bool = False
    done: bool = False
    removed: bool = False      # done items clear from the list


@dataclass
class UploadTracker:
    """stores.js state.activeUploads + the per-item poll transitions."""

    active: int = 0
    refreshes: int = 0         # onDone fired with no uploads in flight
    items: list[UploadItem] = field(default_factory=list)

    def start(self, filename: str) -> UploadItem:
        item = UploadItem(filename)
        self.items.append(item)
        self.active += 1
        return item

    def _finish(self, item: UploadItem) -> None:
        item.done = True
        self.active -= 1
        if self.active == 0:
            self.refreshes += 1

    def upload_failed(self, item: UploadItem, message: str) -> None:
        """POST /api/upload rejected (4xx/5xx)."""
        item.error = True
        item.phase = f"error: {message}"
        self._finish(item)

    def poll(self, item: UploadItem, st: dict, secs: int) -> bool:
        """One op-status response; returns True when polling stops."""
        if item.done:
            raise RuntimeError("poll after clearInterval")
        if st.get("done"):
            if st.get("status") != "DONE":   # done=true covers ERROR too
                item.error = True
                item.phase = f"error: {st.get('error') or st.get('status')}"
            else:
                item.phase = f"done ({st.get('chunks')} chunks, {secs}s)"
                item.removed = True          # setTimeout(remove, 1500)
            self._finish(item)
            return True
        item.phase = f"{str(st.get('status', '')).lower()}… {secs}s"
        return False

    def poll_failed(self, item: UploadItem, message: str) -> bool:
        item.error = True
        item.phase = f"error: {message}"
        self._finish(item)
        return True
