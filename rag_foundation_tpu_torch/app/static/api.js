/* Shared app state + REST client (reference: the axios-ish fetch layer
 * under frontend/src/contexts/*). Exports the singletons the view
 * modules share. */
"use strict";

export const state = {
  token: localStorage.getItem("ragtpu-token") || null,
  stores: [],
  selectedStores: new Set(),
  sessionId: null,
  role: "user",
  streaming: false,
  abort: null,
  lastQuestion: null,
  activeUploads: 0,
};

export const $ = (id) => document.getElementById(id);

export function esc(s) {
  const div = document.createElement("div");
  div.textContent = s == null ? "" : String(s);
  return div.innerHTML;
}

export function banner(msg) {
  let el = $("banner");
  if (!el) {
    el = document.createElement("div");
    el.id = "banner";
    el.className = "error";
    document.querySelector("main").prepend(el);
  }
  el.textContent = msg || "";
  if (msg) setTimeout(() => { el.textContent = ""; }, 6000);
}

export function logout() {
  state.token = null;
  localStorage.removeItem("ragtpu-token");
  localStorage.removeItem("ragtpu-email");
  location.reload();
}

export async function api(method, path, body, isForm = false) {
  const headers = { "X-Requested-With": "XMLHttpRequest" };
  if (state.token) headers["Authorization"] = `Bearer ${state.token}`;
  if (body && !isForm) headers["Content-Type"] = "application/json";
  const resp = await fetch(path, {
    method,
    headers,
    body: body ? (isForm ? body : JSON.stringify(body)) : undefined,
  });
  if (resp.status === 401 && state.token) {
    logout();  // schedules reload; callers must still see a rejection
    throw new Error("Session expired");
  }
  const data = resp.headers.get("content-type")?.includes("json")
    ? await resp.json() : await resp.text();
  if (!resp.ok) throw new Error(data.detail || resp.statusText);
  return data;
}
