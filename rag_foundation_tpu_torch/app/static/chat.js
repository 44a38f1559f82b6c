/* Chat view: sessions, SSE streaming via the shared parser, citations,
 * retry/stop (reference contexts/ChatContext.tsx + useSseRuntime.ts +
 * CitationPanel.tsx).
 *
 * BEHAVIORAL TWIN: utils/chatview.py executes this view's logic under
 * test (handleFrame/mdLite/submit lifecycle/sessions/chips — same
 * pairing as sse.js ↔ utils/sse.py). Any behavior change here MUST
 * land there too (tests/test_frontend_behavior.py). */
"use strict";

import { $, api, banner, esc, state } from "./api.js";
import { consumeSseResponse } from "./sse.js";
import { refreshStores, uploadFileInto } from "./stores.js";

function relTime(ts) {
  const s = Math.max(1, (Date.now() / 1000 - ts) | 0);
  if (s < 60) return `${s}s`;
  if (s < 3600) return `${(s / 60) | 0}m`;
  if (s < 86400) return `${(s / 3600) | 0}h`;
  return `${(s / 86400) | 0}d`;
}

export async function refreshSessions() {
  let out;
  try {
    out = await api("GET", "/api/chat/sessions");
  } catch (e) {
    banner(`Could not load sessions: ${e.message}`);
    return;
  }
  const ul = $("session-list");
  ul.innerHTML = "";
  for (const s of out.sessions) {
    const li = document.createElement("li");
    li.classList.toggle("active", s.id === state.sessionId);
    const title = document.createElement("span");
    title.textContent = s.title || `session ${s.id}`;
    const when = document.createElement("span");
    when.className = "when";
    when.textContent = relTime(s.updated_at || s.created_at);
    const del = document.createElement("button");
    del.className = "del";
    del.textContent = "✕";
    del.title = "Delete session";
    del.addEventListener("click", async (e) => {
      e.stopPropagation();
      await api("DELETE", `/api/chat/sessions/${s.id}`);
      if (state.sessionId === s.id) $("new-session").click();
      refreshSessions();
    });
    li.append(title, when, del);
    li.addEventListener("click", () => loadSession(s.id));
    ul.appendChild(li);
  }
}

function persistSession() {
  if (state.sessionId) {
    localStorage.setItem("ragtpu-session", String(state.sessionId));
  } else {
    localStorage.removeItem("ragtpu-session");
  }
}

async function loadSession(id) {
  state.sessionId = id;
  persistSession();
  const out = await api("GET", `/api/chat/sessions/${id}/messages`);
  $("messages").innerHTML = "";
  for (const m of out.messages) addMessage(m.role, m.content);
  refreshSessions();
}

/* reference useThreadPersistence.ts: reopen the thread the user was in
 * before the reload (silently drops sessions deleted meanwhile) */
export async function restoreSession() {
  const saved = parseInt(localStorage.getItem("ragtpu-session"), 10);
  if (!saved || state.sessionId) return;
  try {
    await loadSession(saved);
  } catch (e) {
    state.sessionId = null;
    persistSession();
  }
}

function welcomeCard() {
  const div = document.createElement("div");
  div.className = "card welcome";
  div.id = "welcome-card";
  div.innerHTML = "<h3>Ask your documents</h3>";
  return div;
}

function addMessage(role, text) {
  const w = $("welcome-card");
  if (w) w.remove();
  const div = document.createElement("div");
  div.className = `msg ${role}`;
  div.textContent = text;
  $("messages").appendChild(div);
  $("messages").scrollTop = $("messages").scrollHeight;
  return div;
}

/* CitationPanel analog: numbered, expandable, attached to the message */
function citationPanel() {
  const details = document.createElement("details");
  details.className = "citations";
  details.innerHTML = "<summary>Sources (0)</summary><ol></ol>";
  return details;
}

function addCitation(panel, frame) {
  const ol = panel.querySelector("ol");
  const li = document.createElement("li");
  li.innerHTML = `<span class="cite-title">${esc(frame.title)}</span>
    <div class="cite-snippet">${esc(frame.snippet || "")}</div>`;
  ol.appendChild(li);
  panel.querySelector("summary").textContent =
    `Sources (${ol.children.length})`;
}

/* numbered [1]..[n] chips under the finished assistant message; a
 * click opens the source panel and highlights + scrolls that entry
 * (reference AssistantMessageContent.tsx chips + CitationPanel
 * highlightIndex scrollIntoView) */
function addCitationChips(target, panel) {
  const items = panel.querySelectorAll("ol > li");
  if (!items.length) return;
  const row = document.createElement("div");
  row.className = "cite-chips";
  items.forEach((li, idx) => {
    const chip = document.createElement("button");
    chip.type = "button";
    chip.className = "cite-chip";
    chip.textContent = `[${idx + 1}]`;
    chip.title = "View source document chunk";
    chip.addEventListener("click", () => {
      panel.open = true;
      items.forEach((x) => x.classList.remove("hl"));
      li.classList.add("hl");
      li.scrollIntoView({ behavior: "smooth", block: "center" });
    });
    row.appendChild(chip);
  });
  target.appendChild(row);
}

/* toolbar status dot (reference ChatToolbar.tsx "Generating…"/"Ready") */
function setStreamingUi(on) {
  $("chat-status").textContent = on ? "Generating…" : "Ready";
  $("chat-dot").classList.toggle("live", on);
  $("send").disabled = on;
  $("stop").hidden = !on;
  $("edit-last").hidden = on || !state.lastQuestion;
}

function setChatError(msg, canRetry = false) {
  $("chat-error-text").textContent = msg;
  $("retry").hidden = !(canRetry && state.lastQuestion);
}

/* markdown-lite for completed assistant messages (reference renders
 * prose via assistant-ui markdown classes): escape FIRST, then allow
 * bold / italic / inline code / bullet lines. No raw HTML ever. */
function mdLite(text) {
  const html = esc(text)
    .replace(/\*\*([^*\n]+)\*\*/g, "<b>$1</b>")
    .replace(/(^|[^*])\*([^*\n]+)\*/g, "$1<i>$2</i>")
    .replace(/`([^`\n]+)`/g, "<code>$1</code>");
  return html.split("\n").map((line) =>
    /^\s*[-•]\s+/.test(line)
      ? `<li>${line.replace(/^\s*[-•]\s+/, "")}</li>`
      : line).join("<br>").replace(/<\/li><br>/g, "</li>");
}

function handleFrame(frame, target, panel) {
  switch (frame.type) {
    case "text-delta":
      target._raw = (target._raw || "") + frame.delta;
      target.textContent = target._raw;
      target.appendChild(streamDot());
      $("messages").scrollTop = $("messages").scrollHeight;
      break;
    case "text-end":
      target.innerHTML = mdLite(target._raw || "");
      break;
    case "source-document":
      addCitation(panel, frame);
      break;
    case "error":
    case "budget_exceeded":
      setChatError(frame.message || frame.errorText, true);
      break;
    default:  /* start / text-start / finish */
      break;
  }
}

/* streaming in-progress indicator (reference
 * MessagePartPrimitive.InProgress dot) */
function streamDot() {
  const s = document.createElement("span");
  s.className = "stream-dot";
  s.textContent = " ●";
  return s;
}

async function submitQuestion() {
  if (state.streaming) return;
  const q = $("question").value.trim();
  if (!q || !state.selectedStores.size) {
    setChatError(q ? "Select at least one store" : "");
    return;
  }
  state.lastQuestion = q;
  $("question").value = "";
  setChatError("");
  addMessage("user", q);
  const target = addMessage("assistant", "");
  const panel = citationPanel();
  state.streaming = true;
  state.abort = new AbortController();
  setStreamingUi(true);
  try {
    const headers = { "Content-Type": "application/json",
                      "X-Requested-With": "XMLHttpRequest",
                      Authorization: `Bearer ${state.token}` };
    const body = {
      question: q,
      store_ids: [...state.selectedStores],
      session_id: state.sessionId,
    };
    const topk = $("opt-topk").value;
    if (topk) body.top_k = parseInt(topk, 10);
    const tags = $("opt-tags").value.trim();
    if (tags) {
      // tags are key=value labels for the cost ledger (the backend
      // requires an OBJECT; sanitize_tags caps 5 entries)
      const obj = {};
      for (const part of tags.split(",")) {
        const [k, ...rest] = part.split("=");
        if (k.trim()) obj[k.trim()] = rest.join("=").trim() || "1";
      }
      if (Object.keys(obj).length) body.tags = obj;
    }
    const model = $("opt-model").value;
    if (model) body.model = model;
    const resp = await fetch("/api/chat", {
      method: "POST", headers, body: JSON.stringify(body),
      signal: state.abort.signal,
    });
    if (!resp.ok) {
      const err = await resp.json();
      throw new Error(err.detail || resp.statusText);
    }
    const sid = resp.headers.get("x-session-id");
    if (sid) state.sessionId = parseInt(sid, 10);
    persistSession();
    await consumeSseResponse(resp, (f) => handleFrame(f, target, panel));
    if (panel.querySelector("ol").children.length) {
      target.after(panel);
      addCitationChips(target, panel);
    }
    refreshSessions();
  } catch (err) {
    if (err.name !== "AbortError") {
      setChatError(err.message, true);
    }
  } finally {
    // stopped/failed streams keep their partial text, lose the dot
    target.querySelector(".stream-dot")?.remove();
    if (target._raw && !target.querySelector(".cite-chips")) {
      target.innerHTML = mdLite(target._raw);
    }
    state.streaming = false;
    state.abort = null;
    setStreamingUi(false);
  }
}

/* composer attachments (reference ComposerAttachments.tsx): attach or
 * drop files straight into the first selected store from the chat
 * view; progress rides the same upload-item machinery as store cards */
function composerUpload(files) {
  const sid = [...state.selectedStores][0];
  if (!sid) {
    setChatError("Select a store before attaching files");
    return;
  }
  for (const f of files) {
    const lim = state.uploadLimits;
    if (lim && f.size > lim.max_mb * 1024 * 1024) {
      banner(`${f.name}: exceeds the ${lim.max_mb} MB upload limit`);
      continue;
    }
    uploadFileInto(sid, f, $("composer-uploads"), () => {
      if (state.activeUploads === 0) refreshStores();
    });
  }
}

export function initChat() {
  $("attach").addEventListener("click", () => $("attach-input").click());
  $("attach-input").addEventListener("change", () => {
    composerUpload($("attach-input").files);
    $("attach-input").value = "";
  });
  const form = $("chat-form");
  form.addEventListener("dragover", (e) => e.preventDefault());
  form.addEventListener("drop", (e) => {
    e.preventDefault();
    composerUpload(e.dataTransfer.files);
  });
  $("retry").addEventListener("click", () => {
    if (!state.lastQuestion || state.streaming) return;
    $("question").value = state.lastQuestion;
    $("chat-form").dispatchEvent(new Event("submit"));
  });
  // "Edit last" loads the previous question into the composer for
  // tweaking without sending (reference ChatToolbar onEditLast ->
  // handleLoadLastIntoComposer)
  $("edit-last").addEventListener("click", () => {
    if (!state.lastQuestion || state.streaming) return;
    $("question").value = state.lastQuestion;
    $("question").focus();
  });
  $("stop").addEventListener("click", () => state.abort?.abort());
  // keyboard: Escape cancels a running stream, Ctrl/Cmd+Enter sends
  // (reference ChatLayout composer onKeyDown)
  document.addEventListener("keydown", (e) => {
    if (e.key === "Escape" && state.streaming) {
      e.preventDefault();
      state.abort?.abort();
    }
  });
  $("question").addEventListener("keydown", (e) => {
    if ((e.metaKey || e.ctrlKey) && e.key === "Enter") {
      e.preventDefault();
      $("chat-form").dispatchEvent(new Event("submit"));
    }
  });
  $("chat-form").addEventListener("submit", (e) => {
    e.preventDefault();
    submitQuestion();
  });
  $("new-session").addEventListener("click", () => {
    state.sessionId = null;
    persistSession();
    $("messages").innerHTML = "";
    $("messages").appendChild($("welcome-card") || welcomeCard());
  });
}
