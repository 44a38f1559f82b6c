/* Theme presets + preview cards (reference themes/presets.ts +
 * CustomizationPanel). */
"use strict";

import { $, api, esc, state } from "./api.js";

export const THEMES = ["system", "light", "dark", "ocean", "forest",
                       "contrast"];
const THEME_SWATCHES = {
  light: ["#f7f7f9", "#2456c4", "#1c1e21"],
  dark: ["#121417", "#6ea8fe", "#e8eaed"],
  ocean: ["#0b2233", "#39c1e0", "#dff3ff"],
  forest: ["#f2f6ef", "#2e7d32", "#21301f"],
  contrast: ["#000", "#ffd600", "#fff"],
  system: ["#888", "#aaa", "#ccc"],
};

export function applyTheme(name, persist) {
  if (!THEMES.includes(name)) name = "system";
  document.body.dataset.theme = name;
  if (persist) localStorage.setItem("ragtpu-theme", name);
  $("theme-quick").value = name;
  document.querySelectorAll(".theme-card").forEach((c) =>
    c.classList.toggle("active", c.dataset.theme === name));
}

export function initThemeControls() {
  const sel = $("theme-quick");
  for (const t of THEMES) {
    const opt = document.createElement("option");
    opt.value = t;
    opt.textContent = t;
    sel.appendChild(opt);
  }
  sel.addEventListener("change", () => applyTheme(sel.value, true));
  const grid = $("theme-presets");
  for (const t of THEMES) {
    const card = document.createElement("div");
    card.className = "theme-card";
    card.dataset.theme = t;
    card.innerHTML = `<b>${esc(t)}</b>`;
    const sw = document.createElement("div");
    sw.className = "sw";
    for (const c of THEME_SWATCHES[t]) {
      const i = document.createElement("i");
      i.style.background = c;
      sw.appendChild(i);
    }
    card.appendChild(sw);
    card.addEventListener("click", async () => {
      applyTheme(t, true);
      // admins persist the deployment default (reference
      // CustomizationPanel saves theme to settings)
      if (state.role === "admin") {
        try { await api("PUT", "/api/settings", { theme: t }); }
        catch (e) { /* non-admin or validation error */ }
      }
    });
    grid.appendChild(card);
  }
}
