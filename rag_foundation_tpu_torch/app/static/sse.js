/* SSE frame parser — the transliteration of the executable spec in
 * rag_foundation_tpu/utils/sse.py (kept in lockstep; the Python twin is
 * contract-tested against recorded streams because this image has no JS
 * runtime — tests/test_sse_contract.py). Mirrors the reference
 * frontend's useSseRuntime.ts:114-313 wire handling:
 *   - events separated by a blank line ("\n\n"; CRLF tolerated)
 *   - only "data: " lines carry payloads; ": keepalive" comments and
 *     unknown fields are skipped
 *   - "data: [DONE]" terminates the stream
 *   - payloads are JSON frames: start / text-start / text-delta /
 *     text-end / source-document / error / finish
 * Pure: no DOM, no fetch — feed it decoded text chunks, receive frames.
 */
"use strict";

export class SseParser {
  constructor() {
    this.buffer = "";
    this.done = false;
  }

  /* push(chunk) -> array of parsed frame objects (may be empty).
   * After [DONE], this.done is true and further input is ignored. */
  push(chunk) {
    if (this.done) return [];
    this.buffer += chunk;
    const frames = [];
    let idx;
    while ((idx = this.buffer.search(/\r?\n\r?\n/)) >= 0) {
      const sep = this.buffer.slice(idx).match(/^\r?\n\r?\n/)[0];
      const raw = this.buffer.slice(0, idx);
      this.buffer = this.buffer.slice(idx + sep.length);
      for (const line of raw.split(/\r?\n/)) {
        if (!line.startsWith("data: ")) continue; // comments/fields
        const payload = line.slice(6);
        if (payload === "[DONE]") {
          this.done = true;
          return frames;
        }
        try {
          frames.push(JSON.parse(payload));
        } catch (e) {
          frames.push({ type: "error",
                        message: `malformed frame: ${payload}` });
        }
      }
    }
    return frames;
  }
}

/* Drive a fetch() Response body through the parser; onFrame(frame) per
 * frame. Resolves when [DONE] or EOF arrives. */
export async function consumeSseResponse(resp, onFrame) {
  const reader = resp.body.getReader();
  const decoder = new TextDecoder();
  const parser = new SseParser();
  for (;;) {
    const { value, done } = await reader.read();
    if (done) break;
    for (const f of parser.push(decoder.decode(value, { stream: true }))) {
      onFrame(f);
    }
    if (parser.done) break;
  }
}
