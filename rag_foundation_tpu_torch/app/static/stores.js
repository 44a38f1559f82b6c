/* Store cards, document lists, drag-drop uploads with op-status polling
 * (reference StoreContext.tsx + hooks/useUploads.ts).
 *
 * BEHAVIORAL TWIN: utils/uploadview.py executes uploadFileInto's poll
 * state machine under test (same pairing as sse.js ↔ utils/sse.py).
 * Any transition change here MUST land there too
 * (tests/test_frontend_behavior.py). */
"use strict";

import { $, api, banner, esc, state } from "./api.js";

export async function refreshStores() {
  let out;
  try {
    out = await api("GET", "/api/stores");
  } catch (e) {
    banner(`Could not load stores: ${e.message}`);
    return;
  }
  state.stores = out.stores;
  // restore the last visit's selection once (reference
  // useThreadPersistence.ts keeps the working set across reloads)
  const live = new Set(out.stores.map((s) => s.id));
  if (!state.selectedStores.size) {
    try {
      for (const id of JSON.parse(
          localStorage.getItem("ragtpu-stores") || "[]")) {
        if (live.has(id)) state.selectedStores.add(id);
      }
    } catch (e) { /* corrupt entry: fall through to the default */ }
  }
  // prune selections for deleted stores or chat 404s forever
  for (const id of [...state.selectedStores]) {
    if (!live.has(id)) state.selectedStores.delete(id);
  }
  if (!state.selectedStores.size && out.stores.length) {
    state.selectedStores.add(out.stores[0].id);
  }
  persistSelection();
  renderChatStores();
  renderStoreCards();
}

function persistSelection() {
  localStorage.setItem("ragtpu-stores",
                       JSON.stringify([...state.selectedStores]));
}

function renderChatStores() {
  const ul = $("chat-store-list");
  ul.innerHTML = "";
  for (const s of state.stores) {
    const li = document.createElement("li");
    const cb = document.createElement("input");
    cb.type = "checkbox";
    cb.checked = state.selectedStores.has(s.id);
    cb.addEventListener("change", () => {
      cb.checked ? state.selectedStores.add(s.id)
                 : state.selectedStores.delete(s.id);
      persistSelection();
    });
    li.append(cb, ` ${s.name}`);
    ul.appendChild(li);
  }
}

let renderGen = 0;

export async function renderStoreCards() {
  const gen = ++renderGen;   // stale overlapping renders must not
  const root = $("store-cards");  // append into the rebuilt container
  root.innerHTML = "";
  const docFetches = state.stores.map((s) =>
    api("GET", `/api/stores/${s.id}/documents`).catch(() => null));
  for (let si = 0; si < state.stores.length; si++) {
    const s = state.stores[si];
    if (gen !== renderGen) return;
    const card = document.createElement("div");
    card.className = "card";
    const created = s.created_at
      ? new Date(s.created_at * 1000).toLocaleDateString() : "";
    card.innerHTML = `<h4>${esc(s.name)}</h4>
      <p class="doc-row"><span class="status">created
        ${esc(created)}</span></p>`;
    const del = document.createElement("button");
    del.textContent = "Delete store";
    del.addEventListener("click", async () => {
      if (!confirm(`Delete store "${s.name}" and all its documents?`)) {
        return;
      }
      await api("DELETE", `/api/stores/${s.id}`);
      refreshStores();
    });
    const drop = document.createElement("div");
    drop.className = "dropzone";
    drop.textContent = "Drop files here or click to choose";
    const up = document.createElement("input");
    up.type = "file";
    up.multiple = true;
    up.hidden = true;
    drop.addEventListener("click", () => up.click());
    drop.addEventListener("dragover", (e) => {
      e.preventDefault();
      drop.classList.add("over");
    });
    drop.addEventListener("dragleave", () =>
      drop.classList.remove("over"));
    const onDone = () => {
      if (state.activeUploads === 0) renderStoreCards();
    };
    drop.addEventListener("drop", (e) => {
      e.preventDefault();
      drop.classList.remove("over");
      for (const f of e.dataTransfer.files) {
        uploadFileInto(s.id, f, card.querySelector(".uploads"), onDone);
      }
    });
    up.addEventListener("change", () => {
      for (const f of up.files) {
        uploadFileInto(s.id, f, card.querySelector(".uploads"), onDone);
      }
      up.value = "";
    });
    const uploads = document.createElement("div");
    uploads.className = "uploads";
    const docs = document.createElement("ul");
    card.append(del, drop, up, uploads, docs);
    root.appendChild(card);
    const out = await docFetches[si];
    if (gen !== renderGen) return;
    if (!out) continue;  // doc list failed; card still usable
    for (const d of out.documents) {
      const li = document.createElement("li");
      li.className = "doc-row";
      li.innerHTML = `<span>${esc(d.filename)}</span>
        <span class="status ${esc(d.status)}">${esc(d.status)}` +
        (d.chunks ? ` · ${Number(d.chunks)} chunks` : "") +
        (d.last_error ? ` — ${esc(d.last_error)}` : "") + `</span>`;
      const rm = document.createElement("button");
      rm.textContent = "✕";
      rm.addEventListener("click", async () => {
        await api("DELETE", `/api/documents/${d.id}`);
        renderStoreCards();
      });
      li.appendChild(rm);
      docs.appendChild(li);
    }
  }
}

/* per-file progress element (reference useUploads.ts + upload progress
 * components): uploading -> queued/processing (elapsed) -> done/error.
 * Renders into any container so the chat composer (reference
 * ComposerAttachments.tsx) reuses the same machinery. */
export function uploadFileInto(storeId, file, uploadsEl, onDone) {
  const item = document.createElement("div");
  item.className = "upload-item";
  item.innerHTML = `<span>${esc(file.name)}</span>
    <span class="phase">uploading…</span>`;
  uploadsEl.appendChild(item);
  const phase = item.querySelector(".phase");
  const t0 = Date.now();
  state.activeUploads += 1;
  const finish = () => {
    state.activeUploads -= 1;
    if (onDone) onDone();
  };
  const form = new FormData();
  form.append("store_id", String(storeId));
  form.append("file", file);
  api("POST", "/api/upload", form, true).then((out) => {
    const poll = setInterval(async () => {
      try {
        const st = await api("GET", `/api/upload/op-status/${out.op_id}`);
        const secs = Math.round((Date.now() - t0) / 1000);
        if (st.done) {
          clearInterval(poll);
          if (st.status !== "DONE") {  // done=true covers ERROR too
            item.classList.add("error");
            phase.textContent = `error: ${st.error || st.status}`;
          } else {
            phase.textContent = `done (${st.chunks} chunks, ${secs}s)`;
            setTimeout(() => { item.remove(); }, 1500);
          }
          finish();
        } else {
          phase.textContent = `${st.status.toLowerCase()}… ${secs}s`;
        }
      } catch (e) {
        clearInterval(poll);
        item.classList.add("error");
        phase.textContent = `error: ${e.message}`;
        finish();
      }
    }, 800);
  }).catch((e) => {
    item.classList.add("error");
    phase.textContent = `error: ${e.message}`;
    finish();
  });
}

export function initStores() {
  $("store-form").addEventListener("submit", async (e) => {
    e.preventDefault();
    await api("POST", "/api/stores", { name: $("store-name").value });
    $("store-name").value = "";
    refreshStores();
  });
}
