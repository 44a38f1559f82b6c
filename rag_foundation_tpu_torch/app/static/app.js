/* App shell: boot, navigation, auth (reference frontend/src/App.tsx +
 * LoginBox.tsx). View logic lives in the sibling modules:
 *   api.js    — shared state + REST client
 *   sse.js    — SSE frame parser (twin of utils/sse.py, the
 *               contract-tested executable spec)
 *   theme.js  — theme presets + preview cards
 *   chat.js   — sessions, streaming, citations
 *   stores.js — store cards, uploads + op-status polling
 *   admin.js  — costs, admin console, branding
 */
"use strict";

import { $, api, logout, state } from "./api.js";
import { initChat, refreshSessions, restoreSession } from "./chat.js";
import { applyBranding, fillBrandingForm, initAdmin, refreshAdmin,
         refreshCosts } from "./admin.js";
import { initStores, refreshStores } from "./stores.js";
import { applyTheme, initThemeControls } from "./theme.js";

/* ---- navigation ----------------------------------------------------- */
function showView(name) {
  for (const v of ["chat", "stores", "costs", "admin"]) {
    $(`view-${v}`).hidden = v !== name;
  }
  document.querySelectorAll("nav button[data-view]").forEach((b) =>
    b.classList.toggle("active", b.dataset.view === name));
  if (name === "costs") refreshCosts();
  if (name === "admin") { refreshAdmin(); fillBrandingForm(); }
  if (name === "stores") refreshStores();
}
document.querySelectorAll("nav button[data-view]").forEach((b) =>
  b.addEventListener("click", () => showView(b.dataset.view)));

async function probeAdmin() {
  try {
    await api("GET", "/api/admin/system");
    state.role = "admin";
    $("nav-admin").hidden = false;
  } catch (e) { state.role = "user"; }
}

/* ---- auth ----------------------------------------------------------- */
function setLoggedIn(token) {
  state.token = token;
  localStorage.setItem("ragtpu-token", token);
  $("view-login").hidden = true;
  $("logout").hidden = false;
  // signed-in identity in the header (reference ChatLayout keeps
  // lastLoginEmail in sessionStorage and shows it in the sidebar)
  $("whoami").textContent = localStorage.getItem("ragtpu-email") || "";
  showView("chat");
  refreshStores();
  refreshSessions().then(restoreSession);
  probeAdmin();
}

$("login-form").addEventListener("submit", async (e) => {
  e.preventDefault();
  try {
    const out = await api("POST", "/api/auth/login", {
      email: $("login-email").value, password: $("login-password").value,
    });
    localStorage.setItem("ragtpu-email", $("login-email").value);
    setLoggedIn(out.access_token);
  } catch (err) { $("login-error").textContent = err.message; }
});

/* password rules surfaced live on register (reference
 * utils/passwordValidation.ts) */
const PW_RULES = [  // mirrors auth.check_password_policy exactly
  ["At least 10 characters", (p) => p.length >= 10],
  ["A letter", (p) => /[a-zA-Z]/.test(p)],
  ["A digit", (p) => /[0-9]/.test(p)],
];

function renderPasswordHints() {
  const ul = $("password-hints");
  ul.hidden = false;
  ul.innerHTML = "";
  const p = $("login-password").value;
  for (const [label, test] of PW_RULES) {
    const li = document.createElement("li");
    li.textContent = label;
    li.className = test(p) ? "ok" : "";
    ul.appendChild(li);
  }
}

let pwHintsWired = false;
$("register-btn").addEventListener("click", async () => {
  renderPasswordHints();
  if (!pwHintsWired) {
    pwHintsWired = true;
    $("login-password").addEventListener("input", renderPasswordHints);
  }
  try {
    await api("POST", "/api/auth/register", {
      email: $("login-email").value, password: $("login-password").value,
    });
    localStorage.setItem("ragtpu-email", $("login-email").value);
    $("login-form").dispatchEvent(new Event("submit"));
  } catch (err) { $("login-error").textContent = err.message; }
});

$("logout").addEventListener("click", async () => {
  try { await api("POST", "/api/auth/logout"); } catch (e) { /* ok */ }
  logout();
});

/* ---- boot ------------------------------------------------------------ */
initThemeControls();
initChat();
initStores();
initAdmin();
applyTheme(localStorage.getItem("ragtpu-theme") || "system", false);
applyBranding();
if (state.token) {
  api("GET", "/api/stores").then(() => setLoggedIn(state.token))
    .catch(() => logout());
}
