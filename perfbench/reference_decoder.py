"""The plain reference of the answer decoder, in float32.

It imports nothing of the port and takes none of its weights or tables:
it reads the checkpoint file (the same raw file the program loads) and
works out the rest itself. The architecture is the GPT-2 block (Radford
et al. 2019, "Language Models are Unsupervised Multitask Learners"),
pre-LN, as the checkpoint lays it out::

    x = tok_emb[ids] + pos_emb[:s]
    per block:  h = LN1(x);  q, k, v = split(h @ qkv + qkv_b)
                x = x + attn(q, k, v) @ proj + proj_b      (causal, per head,
                                                            scale head_dim^-0.5)
                h = LN2(x);  x = x + gelu_tanh(h @ fc1 + fc1_b) @ fc2 + fc2_b
    logits = LN_f(x) @ tok_emb.T                           (tied embeddings)

with LayerNorm's population variance and eps 1e-6. One full forward over
a whole sequence, teacher-forced: no cache, no batching, no padding, TF32
off (``reference.no_tf32``).

``allowed`` works out the tokens a constrained answer may use: the
prompt's tokens and the pieces of the function words (the app's
grounded-decoding vocabulary, copied below), tokenized here by plain
greedy WordPiece against the checkpoint's own vocabulary, less the
specials (EOS among them: every answer decodes its budget).

``round_fp8`` is the control: every weight matrix rounded to fp8 e4m3
with one scale a matrix (its absolute maximum over 448), the precision
below the bfloat16 the program serves in.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.prompts import SPECIALS

LN_EPS = 1e-6
FP8_MAX = 448.0
WIDTHS = ("vocab_size", "hidden", "layers", "heads", "ffn", "max_len",
          "ans_len")
MATRICES = ("qkv", "proj", "fc1", "fc2")
WORD_RE = re.compile(r"[a-z0-9]+(?:[.,-][a-z0-9]+)*|[^\sa-z0-9]")
UNK_ID = 4
FUNCTION_WORDS = (
    "a an the is are was were be been being do does did done to of in on "
    "at by for with from as and or but not no nor this that these those "
    "it its they their them there here which who whose what when where "
    "why how all any each every both few more most other some such only "
    "own same so than too very can could should would may might will "
    "shall must has have had per about approximately roughly around "
    "under over above between within after before during up down out "
    "into onto across against also then once again further while if "
    "because until unless through yes one two three four five six seven "
    "eight nine ten i could not find relevant information selected "
    "stores answer question . , : ; ! ? % ( ) ' \" -").split()


def widths(path: str) -> dict[str, int]:
    """The architecture a checkpoint states."""
    with np.load(path) as z:
        return {w: int(z[f"__cfg_{w}"]) for w in WIDTHS}


def round_fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` through fp8 e4m3 at one scale (its absolute maximum over
    448), back in f32."""
    scale = w.abs().max().clamp_min(1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class ReferenceDecoder:
    """The checkpoint's parameters in f32 on ``device``; ``fp8`` rounds
    the weight matrices and the embeddings first (the control)."""

    def __init__(self, path: str, device, fp8: bool = False):
        self.cfg = widths(path)
        dev = torch.device(device)
        with np.load(path) as z:
            def leaf(key):
                t = torch.from_numpy(np.asarray(z[key], np.float32)).to(dev)
                return t
            self.vocab = json.loads(bytes(z["__vocab_json"]).decode())
            self.tok_emb = leaf("['tok_emb']")
            self.pos_emb = leaf("['pos_emb']")
            self.ln_f = (leaf("['ln_f']['g']"), leaf("['ln_f']['b']"))
            self.blocks = []
            for i in range(self.cfg["layers"]):
                pre = f"['blocks'][{i}]"
                blk = {name: leaf(f"{pre}['{name}']") for name in
                       MATRICES + tuple(m + "_b" for m in MATRICES)}
                for ln in ("ln1", "ln2"):
                    blk[ln] = (leaf(f"{pre}['{ln}']['g']"),
                               leaf(f"{pre}['{ln}']['b']"))
                self.blocks.append(blk)
        if fp8:
            self.tok_emb = round_fp8(self.tok_emb)
            self.pos_emb = round_fp8(self.pos_emb)
            for blk in self.blocks:
                for name in MATRICES:
                    blk[name] = round_fp8(blk[name])
        self.device = dev

    def _ln(self, x, gb):
        return F.layer_norm(x, (x.shape[-1],), gb[0], gb[1], eps=LN_EPS)

    @torch.no_grad()
    def logits(self, ids: np.ndarray) -> torch.Tensor:
        """``[s, vocab]`` f32: the next-token logits at every position of
        the sequence ``ids [s]``."""
        cfg = self.cfg
        s = len(ids)
        heads, hd = cfg["heads"], cfg["hidden"] // cfg["heads"]
        x = self.tok_emb[torch.as_tensor(ids, device=self.device)] \
            + self.pos_emb[:s]
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=self.device).tril()
        for blk in self.blocks:
            h = self._ln(x, blk["ln1"])
            q, k, v = (h @ blk["qkv"] + blk["qkv_b"]).split(cfg["hidden"],
                                                            dim=-1)
            q, k, v = (t.view(s, heads, hd).transpose(0, 1)
                       for t in (q, k, v))
            scores = (q @ k.transpose(1, 2)) * hd ** -0.5
            p = torch.softmax(scores.masked_fill(~causal, float("-inf")),
                              dim=-1)
            a = (p @ v).transpose(0, 1).reshape(s, cfg["hidden"])
            x = x + a @ blk["proj"] + blk["proj_b"]
            h = self._ln(x, blk["ln2"])
            x = x + F.gelu(h @ blk["fc1"] + blk["fc1_b"],
                           approximate="tanh") @ blk["fc2"] + blk["fc2_b"]
        return self._ln(x, self.ln_f) @ self.tok_emb.T

    def word_pieces(self, word: str) -> list[int]:
        """Greedy longest-match WordPiece of one word (``##`` marks a
        piece inside a word); a character with no piece is UNK."""
        out, i = [], 0
        while i < len(word):
            for j in range(len(word), i, -1):
                piece = self.vocab.get(word[i:j] if i == 0
                                       else "##" + word[i:j])
                if piece is not None:
                    out.append(piece)
                    i = j
                    break
            else:
                out.append(UNK_ID)
                i += 1
        return out

    def allowed(self, prompt: np.ndarray, constrained: bool
                ) -> torch.Tensor:
        """``[vocab]`` bool: the tokens an answer to ``prompt`` may use.
        Constrained: the prompt's tokens and the function words' pieces;
        otherwise every token. Never the specials (EOS among them)."""
        v = self.cfg["vocab_size"]
        if not constrained:
            mask = torch.ones(v, dtype=torch.bool, device=self.device)
        else:
            ids = {int(t) for t in prompt}
            for w in FUNCTION_WORDS:
                for word in WORD_RE.findall(w.lower()):
                    ids.update(self.word_pieces(word))
            mask = torch.zeros(v, dtype=torch.bool, device=self.device)
            mask[sorted(i for i in ids if 0 <= i < v)] = True
        mask[:SPECIALS] = False
        return mask
