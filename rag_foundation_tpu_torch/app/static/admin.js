/* Costs panel + admin console (reference CostPanel.tsx,
 * components/admin/*, hooks/useAdminConsole.ts) + branding. */
"use strict";

import { $, api, banner, esc, state } from "./api.js";
import { applyTheme } from "./theme.js";

export async function refreshCosts() {
  const c = await api("GET", "/api/costs/summary");
  const mtd = +c.month_to_date_usd;
  let budgetHtml;  // *Html = sanitized fragment (xss-lint convention)
  if (c.budget_usd === null) {
    budgetHtml = "<p>no budget set</p>";
  } else {
    const used = Math.min(100, (mtd / +c.budget_usd) * 100 || 0);
    budgetHtml = `<p>$${(+c.budget_usd).toFixed(2)} budget ·
      $${(+c.remaining_usd).toFixed(2)}
      left</p><div class="meter ${used > 85 ? "hot" : ""}">
      <div style="width:${used.toFixed(1)}%"></div></div>`;
  }
  $("cost-panel").innerHTML = `
    <div class="card"><h4>Month to date</h4>
      <p>$${mtd.toFixed(4)}</p></div>
    <div class="card"><h4>Queries</h4><p>${Number(c.queries)}
      (${Number(c.prompt_tokens)} in /
       ${Number(c.completion_tokens)} out tok)</p></div>
    <div class="card"><h4>Indexing</h4><p>${Number(c.index_tokens)}
      tokens, $${(+c.index_cost_usd).toFixed(4)}</p></div>
    <div class="card"><h4>Budget</h4>${budgetHtml}</div>`;
}

export async function refreshAdmin() {
  let users;
  try {
    users = await api("GET", "/api/admin/users");
  } catch (e) {
    banner(`Admin data failed to load: ${e.message}`);
    return;
  }
  const table = $("admin-users");
  table.innerHTML = "<tr><th>id</th><th>email</th><th>role</th>" +
                    "<th>active</th><th>budget</th><th>notes</th>" +
                    "<th></th></tr>";
  for (const u of users.users) {
    const tr = document.createElement("tr");
    const budget = u.monthly_usd == null
      ? "—" : `$${(+u.monthly_usd).toFixed(2)}`;
    const notes = (u.admin_notes || "").slice(0, 40);
    tr.innerHTML = `<td>${Number(u.id)}</td><td>${esc(u.email)}</td>` +
                   `<td>${esc(u.role)}</td>` +
                   `<td>${u.is_active ? "yes" : "no"}</td>` +
                   `<td>${esc(budget)}</td><td>${esc(notes)}</td>`;
    const td = document.createElement("td");
    const manage = document.createElement("button");
    manage.textContent = "Manage";
    manage.addEventListener("click", () => openUserModal(u));
    td.appendChild(manage);
    tr.appendChild(td);
    table.appendChild(tr);
  }
  const sys = await api("GET", "/api/admin/system");
  const cards = $("admin-system-cards");
  cards.innerHTML = "";
  const items = [
    ["Users", sys.users], ["Stores", sys.stores],
    ["Documents", sys.documents], ["Queue pending", sys.queue_pending],
  ].filter(([, v]) => v !== undefined);
  for (const [label, v] of items) {
    const div = document.createElement("div");
    div.className = "card";
    div.innerHTML = `<h4>${esc(label)}</h4><p>${esc(v)}</p>`;
    cards.appendChild(div);
  }
  $("admin-system").textContent = JSON.stringify(sys, null, 2);
  const sel = $("recall-store");
  sel.innerHTML = "<option value=''>store…</option>";
  for (const s of state.stores || []) {
    const opt = document.createElement("option");
    opt.value = s.id;
    opt.textContent = s.name;
    sel.appendChild(opt);
  }
  const audit = await api("GET", "/api/admin/audit");
  const at = $("admin-audit");
  at.innerHTML = "<tr><th>time</th><th>admin</th><th>action</th>" +
                 "<th>target</th></tr>";
  for (const a of audit.audit.slice(0, 25)) {
    const tr = document.createElement("tr");
    const when = new Date(a.created_at * 1000).toISOString();
    tr.innerHTML = `<td>${esc(when)}</td>` +
                   `<td>${Number(a.admin_user_id)}</td>` +
                   `<td>${esc(a.action)}</td><td>${esc(a.target)}</td>`;
    at.appendChild(tr);
  }
}

/* manage-user modal (reference admin/AdminUserModal.tsx: role toggle
 * with self-demotion guard, operator notes, budget prefill+update) */
let modalUser = null;

function openUserModal(u) {
  modalUser = u;
  $("um-email").textContent = `#${u.id} · ${u.email}`;
  $("um-admin").checked = u.role === "admin";
  $("um-active").checked = !!u.is_active;
  $("um-notes").value = u.admin_notes || "";
  $("um-budget").value = u.monthly_usd == null ? "" : u.monthly_usd;
  // self-guard mirrors the server's 409 (admin.py self-demotion ban):
  // the reference disables the checkbox for the signed-in admin
  const isSelf = u.email === localStorage.getItem("ragtpu-email");
  $("um-admin").disabled = isSelf;
  $("um-active").disabled = isSelf;
  $("um-self-hint").hidden = !isSelf;
  $("um-status").textContent = "";
  $("user-modal").hidden = false;
}

function closeUserModal() {
  $("user-modal").hidden = true;
  modalUser = null;
}

async function saveUserModal() {
  if (!modalUser) return;
  const u = modalUser;
  const patch = {};
  const role = $("um-admin").checked ? "admin" : "user";
  if (role !== u.role) patch.role = role;
  const active = $("um-active").checked;
  if (active !== !!u.is_active) patch.is_active = active;
  const notes = $("um-notes").value;
  if (notes !== (u.admin_notes || "")) patch.admin_notes = notes;
  $("um-status").textContent = "saving…";
  try {
    if (Object.keys(patch).length) {
      await api("PATCH", `/api/admin/users/${u.id}`, patch);
    }
    const bud = $("um-budget").value;
    if (bud !== "" && +bud !== +(u.monthly_usd ?? NaN)) {
      await api("PUT", `/api/admin/budgets/${u.id}`,
                { monthly_usd: parseFloat(bud) });
    }
    closeUserModal();
    refreshAdmin();
  } catch (e) {
    $("um-status").textContent = e.message;
  }
}

/* reference components/admin/IconPicker.tsx icon set analog */
const ICONS = ["✦", "🔎", "📚", "🤖", "💬", "🗂", "⚡", "🧠"];

export async function applyBranding() {
  try {
    const out = await api("GET", "/api/settings");
    const s = out.settings;
    state.branding = s;
    state.uploadLimits = out.upload || null;
    if (out.upload) {
      $("attach").title = `Attach to the selected store ` +
        `(≤${out.upload.max_mb} MB, ${out.upload.mime_count} ` +
        `allowed types)`;
    }
    if (s.app_name) {
      $("app-name").textContent = s.app_name;
      document.title = s.app_name;
    }
    $("app-icon").textContent = s.app_icon || "";
    // colors land as CSS custom properties (reference ThemeContext
    // applies primary/accent the same way)
    const root = document.documentElement;
    if (s.primary_color) root.style.setProperty("--accent",
                                                s.primary_color);
    if (s.accent_color) root.style.setProperty("--accent-2",
                                               s.accent_color);
    if (s.favicon_url) {
      let link = document.querySelector("link[rel=icon]");
      if (!link) {
        link = document.createElement("link");
        link.rel = "icon";
        document.head.appendChild(link);
      }
      link.href = s.favicon_url;
    }
    const foot = $("app-footer");
    foot.hidden = !s.footer_text;
    foot.textContent = s.footer_text || "";
    if (s.welcome_message) {
      const wm = $("welcome-message");
      if (wm) wm.textContent = s.welcome_message;
    }
    renderWelcomePrompts(s.welcome_prompts);
    // user-local theme choice beats the deployment default
    if (s.theme && !localStorage.getItem("ragtpu-theme")) {
      applyTheme(s.theme, false);
    }
    const sel = $("opt-model");
    if (out.models && !sel.children.length) {
      for (const m of out.models) {
        const opt = document.createElement("option");
        opt.value = m === out.default_model ? "" : m;
        opt.textContent = m + (m === out.default_model ?
                               " (default)" : "");
        sel.appendChild(opt);
      }
    }
  } catch (e) { /* pre-auth errors fine */ }
}

/* suggested-prompt chips on the welcome card (reference
 * AppSettings.suggested_prompt_1..3 + WelcomeCard.tsx): click fills
 * and submits the composer */
function renderWelcomePrompts(prompts) {
  const box = $("welcome-prompts");
  if (!box) return;
  box.innerHTML = "";
  for (const p of String(prompts || "").split("\n")) {
    const text = p.trim();
    if (!text) continue;
    const chip = document.createElement("button");
    chip.type = "button";
    chip.className = "chip";
    chip.textContent = text;
    chip.addEventListener("click", () => {
      $("question").value = text;
      $("chat-form").dispatchEvent(new Event("submit"));
    });
    box.appendChild(chip);
  }
}

export function initAdmin() {
  $("um-close").addEventListener("click", closeUserModal);
  $("um-save").addEventListener("click", saveUserModal);
  $("user-modal").addEventListener("click", (e) => {
    if (e.target === $("user-modal")) closeUserModal();
  });
  document.addEventListener("keydown", (e) => {
    if (e.key === "Escape" && !$("user-modal").hidden) closeUserModal();
  });
  $("watchdog-btn").addEventListener("click", async () => {
    try {
      const out = await api("POST", "/api/admin/watchdog/reset-stuck");
      alert(`reset ${out.reset} stuck ingestion(s)`);
    } catch (e) {
      banner(`Watchdog reset failed: ${e.message}`);
    }
  });
  $("recall-btn").addEventListener("click", async () => {
    const sid = parseInt($("recall-store").value, 10);
    if (!sid) return;
    $("recall-out").textContent = "probing…";
    try {
      const out = await api("POST", "/api/admin/engine/recall-probe",
                            {store_id: sid, k: 10});
      $("recall-out").textContent = out.recall === null
        ? (out.skipped ? `skipped: ${out.skipped}` : "store empty")
        : `recall@${out.k} = ${out.recall.toFixed(4)} (n=${out.sample})`;
    } catch (e) {
      $("recall-out").textContent = `error: ${e.message}`;
    }
  });
  // icon picker (reference IconPicker.tsx): one-click selection
  const iconBox = $("branding-icons");
  for (const ic of ICONS) {
    const b = document.createElement("button");
    b.type = "button";
    b.textContent = ic;
    b.addEventListener("click", () => {
      $("branding-icon").value = ic;
      iconBox.querySelectorAll("button").forEach((x) =>
        x.classList.toggle("sel", x === b));
    });
    iconBox.appendChild(b);
  }
  $("branding-form").addEventListener("submit", async (e) => {
    e.preventDefault();
    const body = {
      app_name: $("branding-name").value,
      app_icon: $("branding-icon").value,
      primary_color: $("branding-primary").value,
      accent_color: $("branding-accent").value,
      welcome_prompts: $("branding-prompts").value,
      footer_text: $("branding-footer").value,
    };
    if ($("branding-welcome").value) {
      body.welcome_message = $("branding-welcome").value;
    }
    // drop empties so a partial form never clears existing branding
    for (const k of Object.keys(body)) if (!body[k]) delete body[k];
    try {
      await api("PUT", "/api/settings", body);
      $("branding-saved").textContent = "✓ saved";
      setTimeout(() => { $("branding-saved").textContent = ""; }, 1500);
      applyBranding();
    } catch (err) {
      banner(`Branding save failed: ${err.message}`);
    }
  });
}

/* prefill the branding form from current settings when the admin view
 * opens (reference CustomizationPanel loads current values) */
export function fillBrandingForm() {
  const s = state.branding || {};
  if ($("branding-name").value === "") {
    $("branding-name").value = s.app_name || "";
  }
  $("branding-icon").value = s.app_icon || "";
  if (s.primary_color) $("branding-primary").value = s.primary_color;
  if (s.accent_color) $("branding-accent").value = s.accent_color;
  if (s.welcome_message) {
    $("branding-welcome").value = s.welcome_message;
  }
  if ($("branding-prompts").value === "") {
    $("branding-prompts").value = s.welcome_prompts || "";
  }
  if ($("branding-footer").value === "") {
    $("branding-footer").value = s.footer_text || "";
  }
}
