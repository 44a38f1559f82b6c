"""Evidence-conditioned generative decoder: the answer composer.

Counterpart of ``rag_foundation_tpu/models/decoder.py``: a decoder-only
prefix-LM (GPT-style causal transformer, pre-LN, tied input/output
embeddings) that turns ``[BOS] question [SEP] evidence… [SEP]`` into a
grounded answer, token by token. It is the model behind the app's
``ENGINE_GENERATOR=generative`` tier, served by the engine's
``generate_stream``.

Parameters are a plain dict with the JAX tree's names and layouts
(``tok_emb``, ``pos_emb``, ``ln_f``, ``blocks[i]`` with ``qkv [h, 3h]``
etc.; the encoder's tree, ``models/encoder.py``), so a JAX checkpoint
loads as it is and ``params_from_jax`` carries a JAX parameter tree
across. Functions take tensors on one device; entry points take the
device, the card unless the caller asks for the CPU.

Numerics follow the JAX function: parameters and activations in the
config's dtype (bf16 by default), layernorm statistics in f32 (population
variance, eps 1e-6), every product accumulated in f32 with its bias added
in f32 before one rounding to the working dtype (``_dot``), the
tanh-approximate GELU (``jax.nn.gelu``'s default), and attention written
out as JAX writes it: f32 scores times ``head_dim ** -0.5``, masked with
-1e30, an f32 softmax, the probabilities cast to the value dtype and P.V
accumulated in f32. No attention library call stands in for it, so its
numbers follow JAX's.

Training differentiates through autograd with JAX's rounding: each
product's operand gradients are the f32 cotangent times the other operand
widened to f32, rounded once to the operand's dtype, and a bias's
gradient is the cotangent summed in f32, rounded to the bias's dtype
(``_F32Product``, the transpose rule of a ``dot_general`` with
``preferred_element_type=f32``). The other casts (the layernorms' f32
statistics, the working-dtype roundings) differentiate as ``Tensor.to``
does, as JAX's ``convert_element_type`` does. The backward products run
in f32 on both devices.

Serving runs one prefill over the right-padded prefix, then
``decode_block``: ``k_steps`` greedy steps against a static-shape KV
cache, as a Python loop with the position a host integer, so nothing in
a block waits on the card; the block's ids are read once. The cache is
written in place (JAX returns a new one). ``torch.argmax`` returns the
first maximal index, as ``jnp.argmax`` does, so a tie picks the same
token in both packages.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rag_foundation_tpu_torch.models import encoder as _enc
from rag_foundation_tpu_torch.models.gen_tokenizer import (BOS_ID, EOS_ID,
                                                           PAD_ID, SEP_ID,
                                                           UNK_ID,
                                                           GenTokenizer)
from rag_foundation_tpu_torch.utils.device import resolve_device


class DecoderConfig(NamedTuple):
    vocab_size: int = 8192
    hidden: int = 384
    layers: int = 6
    heads: int = 6
    ffn: int = 1536
    max_len: int = 512        # prefix + answer budget (KV cache size)
    ans_len: int = 96         # serve-time answer budget
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def prefix_len(self) -> int:
        return self.max_len - self.ans_len

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


_CFG_FIELDS = ("vocab_size", "hidden", "layers", "heads", "ffn",
               "max_len", "ans_len")


def init_params(generator: torch.Generator, cfg: DecoderConfig) -> dict:
    """Decoder parameters on ``generator``'s device: the encoder's tree
    and draws (a normal truncated to ±2σ times ``fan_in ** -0.5``; biases
    0, layernorm gains 1), as the JAX decoder's ``init_params`` makes
    them. Other draws than ``jax.random``'s for the same seed."""
    return _enc.init_params(generator, cfg)


# a JAX parameter tree (numpy leaves) as the port's dict: the same tree
params_from_jax = _enc.params_from_jax


def _layernorm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    # f32 statistics (population variance), output in the working dtype
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps=1e-6).to(x.dtype)


def _f32_product(a: torch.Tensor, b: torch.Tensor,
                 bias: torch.Tensor | None) -> torch.Tensor:
    """``a @ b (+ bias)`` over ``[m, k] x [k, n]`` or ``[B, m, k] x [B, k,
    n]``, accumulated and returned in f32 (JAX's ``dot_general`` with
    ``preferred_element_type=f32``), the bias added in f32. On the card
    one cuBLAS call with an f32 output; on the CPU the operands widened to
    f32 first, which gives the same exact products."""
    if a.is_cuda:
        if a.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        if bias is None:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.addmm(bias.float(), a, b, out_dtype=torch.float32)
    y = (torch.mm if a.dim() == 2 else torch.bmm)(a.float(), b.float())
    return y if bias is None else y + bias.float()


class _F32Product(torch.autograd.Function):
    """``_f32_product`` with JAX's transpose rule as its backward
    (``jax/_src/lax/lax.py``, ``_dot_general_transpose_lhs``), one code
    for both devices: the f32 cotangent ``g`` times the other operand
    widened to f32, an f32 product, rounded once to the operand's dtype;
    the bias's gradient is ``g`` summed in f32 and rounded to its dtype.
    These backward products run at the card's f32 rate, not its bf16
    tensor-core rate (PyTorch's ``*.dtype`` overloads of
    ``mm``/``addmm``/``bmm`` that the forward uses have no derivative of
    their own)."""

    @staticmethod
    def forward(ctx, a, b, bias):
        ctx.save_for_backward(a, b)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _f32_product(a, b, bias)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = gbias = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        if ctx.needs_input_grad[2]:
            gbias = g.sum(0).to(ctx.bias_dtype)
        return ga, gb, gbias


def _product(a: torch.Tensor, b: torch.Tensor,
             bias: torch.Tensor | None) -> torch.Tensor:
    # serving (no gradient wanted) skips the autograd.Function's own
    # host cost, a few microseconds a call on a launch-bound decode
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, bias)):
        return _F32Product.apply(a, b, bias)
    return _f32_product(a, b, bias)


def _dot(x: torch.Tensor, w: torch.Tensor,
         b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w (+ b)`` over the last axis of ``x``, accumulated and
    returned in f32, the bias added in f32 (``_f32_product``;
    differentiable through ``_F32Product``)."""
    y = _product(x.reshape(-1, x.shape[-1]), w, b)
    return y.view(*x.shape[:-1], w.shape[1])


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` over ``[..., m, k] x [..., k, n]``, accumulated
    and returned in f32 (``_dot``'s rule)."""
    lead = a.shape[:-2]
    y = _product(a.reshape(-1, *a.shape[-2:]),
                 b.reshape(-1, *b.shape[-2:]), None)
    return y.view(*lead, *y.shape[-2:])


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _dot(x, w, b).to(x.dtype)


def _split_heads(t: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    b, s, _ = t.shape
    return t.view(b, s, cfg.heads, cfg.head_dim).transpose(1, 2)


def _qkv(x: torch.Tensor, blk: dict) -> tuple:
    return _dense(x, blk["qkv"], blk["qkv_b"]).chunk(3, dim=-1)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """f32-softmax attention; ``mask`` True = attend."""
    scores = _bmm(q, k.transpose(-1, -2)) * (cfg.head_dim ** -0.5)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return _bmm(probs.to(v.dtype), v).to(v.dtype)


def _ffn(x: torch.Tensor, blk: dict) -> torch.Tensor:
    h = F.gelu(_dot(x, blk["fc1"], blk["fc1_b"]), approximate="tanh")
    return _dense(h.to(x.dtype), blk["fc2"], blk["fc2_b"])


def _stack(params: dict, x: torch.Tensor, mask: torch.Tensor,
           cfg: DecoderConfig, kv=None) -> torch.Tensor:
    """The pre-LN blocks and the final layernorm over ``x [b, s, h]``.
    ``kv(layer, k, v)``, when given, records a layer's keys and values
    ``[b, heads, s, head_dim]`` and returns those to attend over."""
    b, s, _ = x.shape
    for li, blk in enumerate(params["blocks"]):
        h = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"])
        q, k, v = (_split_heads(t, cfg) for t in _qkv(h, blk))
        if kv is not None:
            k, v = kv(li, k, v)
        a = _sdpa(q, k, v, mask, cfg)
        a = a.transpose(1, 2).reshape(b, s, cfg.hidden)
        x = x + _dense(a, blk["proj"], blk["proj_b"])
        h = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
        x = x + _ffn(h, blk)
    return _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def _prefix_mask(ids: torch.Tensor) -> torch.Tensor:
    """``[b, 1, s, s]``: causal, PAD positions masked out as keys."""
    s = ids.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()
    return causal[None, None] & (ids != PAD_ID)[:, None, None, :]


def _embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    s = ids.shape[1]
    return F.embedding(ids.long(), params["tok_emb"]) + params["pos_emb"][:s]


def forward(params: dict, ids: torch.Tensor, cfg: DecoderConfig
            ) -> torch.Tensor:
    """Full-sequence causal forward for training: ``[b, s] -> [b, s, V]``
    f32 logits. PAD positions are masked out as attention keys."""
    x = _stack(params, _embed(params, ids), _prefix_mask(ids), cfg)
    return _dot(x, params["tok_emb"].t())


def lm_loss(params: dict, tokens: torch.Tensor, loss_mask: torch.Tensor,
            cfg: DecoderConfig, *, z_reg: float = 1e-4) -> torch.Tensor:
    """Next-token cross-entropy over masked (answer) positions.
    ``tokens [b, s]``; ``loss_mask [b, s]`` marks positions whose TOKEN
    is a prediction target (the answer span incl. EOS). A small z-loss
    keeps bf16 logits from drifting. A 0-d f32 tensor."""
    logits = forward(params, tokens[:, :-1], cfg)      # predict t+1
    targets = tokens[:, 1:].long()
    mask = loss_mask[:, 1:].float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None])[..., 0] - logz
    n = mask.sum().clamp_min(1.0)
    ce = -(ll * mask).sum() / n
    zl = ((logz ** 2) * mask).sum() / n
    return ce + z_reg * zl


def make_train_step(cfg: DecoderConfig, optimizer, *,
                    max_grad_norm: float | None = None, **loss_kwargs):
    """A ``(params, tokens, loss_mask) -> loss`` step of ``lm_loss(...,
    **loss_kwargs)`` that updates ``params`` in place: the encoder's
    ``make_step`` (clip by global norm, then the optimizer's step in each
    leaf's dtype), the one step of ``scripts/train_decoder.py``'s
    ``lax.scan``."""
    return _enc.make_step(
        lambda params, tokens, loss_mask: lm_loss(
            params, tokens, loss_mask, cfg, **loss_kwargs),
        optimizer, max_grad_norm=max_grad_norm)


# ---------------------------------------------------------------------------
# KV-cache inference

def init_cache(cfg: DecoderConfig, batch: int = 1,
               device: str | torch.device = "cuda") -> dict:
    """Zeroed K/V ``[layers, b, heads, max_len, head_dim]`` in the
    config's dtype, on ``device`` (the card unless the caller asks for the
    CPU)."""
    shape = (cfg.layers, batch, cfg.heads, cfg.max_len, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def prefill(params: dict, ids: torch.Tensor, length: torch.Tensor,
            cfg: DecoderConfig) -> tuple[dict, torch.Tensor]:
    """Run the (right-padded) prefix ``[b, P]`` through the stack,
    recording K/V for every position. Returns (cache, f32 logits at the
    LAST REAL position ``length-1``, shape [b, V])."""
    b, s = ids.shape
    cache = init_cache(cfg, b, ids.device)

    def record(li, k, v):
        cache["k"][li, :, :, :s] = k
        cache["v"][li, :, :, :s] = v
        return k, v

    x = _stack(params, _embed(params, ids), _prefix_mask(ids), cfg, record)
    last = x[torch.arange(b, device=ids.device), length.long() - 1]
    return cache, _dot(last, params["tok_emb"].t())


def _decode_one(params: dict, cache: dict, tok: torch.Tensor, pos: int,
                cfg: DecoderConfig) -> tuple[torch.Tensor, dict]:
    """One token ``tok [b]`` at position ``pos`` (a host int) against the
    cache, which is written in place at ``pos`` (JAX returns a new
    cache). Positions > pos hold stale (pad or previous-generation)
    entries and are masked; sequential overwrite keeps ``j <= pos``
    always valid. Returns (f32 logits [b, V], cache)."""
    x = F.embedding(tok.long(), params["tok_emb"])[:, None] \
        + params["pos_emb"][pos:pos + 1]
    keys = torch.arange(cfg.max_len, device=tok.device)
    mask = (keys <= pos)[None, None, None, :]

    def append(li, k, v):
        cache["k"][li, :, :, pos] = k[:, :, 0]
        cache["v"][li, :, :, pos] = v[:, :, 0]
        return cache["k"][li], cache["v"][li]

    x = _stack(params, x, mask, cfg, append)
    return _dot(x[:, 0], params["tok_emb"].t()), cache


def decode_block(params: dict, cache: dict, last_tok: torch.Tensor,
                 pos: int, *, cfg: DecoderConfig, k_steps: int = 16,
                 bias: torch.Tensor | None = None):
    """Advance ``k_steps`` greedy tokens without waiting on the card.
    ``last_tok [b]`` is the most recent token (prefix tail or previous
    block's last emission); ``pos`` (a host int) is the position the NEXT
    token will occupy, i.e. the current sequence length. After EOS the
    output is pinned to EOS (the host trims). ``bias [vocab] f32`` is
    added to every step's logits: the constrained-grounded-decoding hook
    (-1e9 on tokens outside prompt ∪ function words ∪ EOS; see
    ``TextGenerator.vocab_bias``). The argmax takes the first maximal
    index, as ``jnp.argmax`` does. Returns (ids [b, k_steps] int64,
    cache, pos + k_steps); the cache is the one given, written in
    place."""
    pos = int(pos)
    done = last_tok == EOS_ID
    tok = last_tok
    out = []
    for step in range(k_steps):
        logits, cache = _decode_one(params, cache, tok, pos + step, cfg)
        if bias is not None:
            logits = logits + bias
        tok = torch.argmax(logits, dim=-1).masked_fill(done, EOS_ID)
        done = done | (tok == EOS_ID)
        out.append(tok)
    return torch.stack(out, dim=1), cache, pos + k_steps


# ---------------------------------------------------------------------------
# checkpoints (the JAX npz format: flat keystr -> array + meta)

def save_decoder(params: dict, path: str, cfg: DecoderConfig,
                 tokenizer: GenTokenizer) -> None:
    """Write ``params`` as the JAX decoder's ``save_decoder`` does: one
    array a leaf under its ``keystr`` name, bf16 stored as f32, the
    architecture as ``__cfg_*`` and the vocabulary as ``__vocab_json``
    (``DecoderConfig.dtype`` is not saved: a loaded checkpoint is bf16)."""
    arrays = {}
    for key, t in _enc._leaves(params).items():
        t = t.detach().cpu()
        if t.dtype not in (torch.float32, torch.float64):
            t = t.float()       # np.savez cannot store bfloat16
        arrays[key] = t.numpy()
    for f in _CFG_FIELDS:
        arrays[f"__cfg_{f}"] = np.int64(getattr(cfg, f))
    arrays["__vocab_json"] = np.frombuffer(
        tokenizer.to_json().encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_decoder(path: str, device: str | torch.device = "cuda"
                 ) -> tuple[dict, DecoderConfig, GenTokenizer]:
    """(params, config, tokenizer) of a JAX-format decoder checkpoint, the
    parameters in the config's layout and dtypes on ``device`` (the card
    unless the caller asks for the CPU). Raises, with the JAX loader's
    messages, on an npz with no vocabulary, a missing key or a shape of
    another config."""
    device = resolve_device(device)
    with np.load(path) as z:
        if "__vocab_json" not in z:
            raise ValueError(f"{path} is not a decoder checkpoint "
                             f"(no embedded vocab)")
        cfg = DecoderConfig(**{f: int(z[f"__cfg_{f}"])
                               for f in _CFG_FIELDS})
        tok = GenTokenizer.from_json(bytes(z["__vocab_json"]).decode())
        template = _enc._tree(
            cfg, lambda fan_in, shape: (shape, cfg.tdtype),
            lambda value, shape, dtype: (shape, dtype))

        def leaf(key, spec):
            shape, dtype = spec
            if key not in z:
                raise ValueError(f"checkpoint {path} missing {key}")
            arr = z[key]
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint {path}: {key} has shape {arr.shape}, "
                    f"model wants {shape}")
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=dtype)

        params = _enc._map(template, leaf)
    return params, cfg, tok


def checkpoint_meta(path: str) -> dict:
    """Config summary without loading params (admin/status surface)."""
    with np.load(path) as z:
        meta = {f: int(z[f"__cfg_{f}"]) for f in _CFG_FIELDS
                if f"__cfg_{f}" in z}
        if "__vocab_json" in z:
            meta["vocab_entries"] = len(json.loads(
                bytes(z["__vocab_json"]).decode()))
    return meta


# ---------------------------------------------------------------------------
# serving wrapper

# words a grounded answer may use even when absent from the evidence:
# glue, copulas, quantifier/comparative scaffolding, and the refusal
# vocabulary. Everything else must come from the prompt (constrained
# grounded decoding: the token-level complement of the serve-time
# grounding gate of the app's generative tier). The JAX package's list.
_FUNCTION_WORDS = (
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


class TextGenerator:
    """Greedy streaming generation over a loaded checkpoint, on one
    device (the card unless the caller asks for the CPU).

    One instance per engine process; ``stream()`` is called from RPC
    handler threads. The parameters are only read and the per-call state
    (cache, pos) is local to the call, so no lock is needed; the calls'
    launches interleave on the device's stream.

    ``constrained=True`` (default) masks decode logits to tokens from
    the PROMPT (question + evidence) plus function words and EOS: the
    decoder can only copy grounded content tokens.
    """

    def __init__(self, ckpt_path: str, *, block: int = 16,
                 constrained: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params, self.cfg, self.tokenizer = load_decoder(
            ckpt_path, self.device)
        self.block = int(block)
        self.constrained = bool(constrained)
        self._fn_ids = set()
        for w in _FUNCTION_WORDS:
            self._fn_ids.update(self.tokenizer.encode_text(w))

    def vocab_bias(self, prompt_ids: list[int]) -> np.ndarray:
        """[vocab] f32: 0 for prompt ∪ function ∪ EOS tokens, -1e9
        elsewhere (PAD/BOS/SEP/UNK always banned)."""
        bias = np.full((self.cfg.vocab_size,), -1e9, np.float32)
        allowed = set(prompt_ids) | self._fn_ids | {EOS_ID}
        allowed -= {PAD_ID, BOS_ID, SEP_ID, UNK_ID}
        bias[sorted(allowed)] = 0.0
        return bias

    def prewarm(self) -> None:
        """One prefill and one ``decode_block`` at the serving shapes, so
        that cuBLAS and the allocator are warm before the first chat."""
        cfg = self.cfg
        with torch.inference_mode():
            ids = torch.zeros((1, cfg.prefix_len), dtype=torch.int64,
                              device=self.device)
            one = torch.ones((1,), dtype=torch.int64, device=self.device)
            cache, logits = prefill(self.params, ids, one, cfg)
            decode_block(self.params, cache, torch.argmax(logits, -1), 1,
                         cfg=cfg, k_steps=self.block)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def stream(self, question: str, evidences: list[str],
               *, max_tokens: int | None = None,
               constrained: bool | None = None):
        """Yield detokenized text pieces, one per decode block."""
        cfg, dev = self.cfg, self.device
        ids = self.tokenizer.encode_prompt(question, evidences,
                                           cfg.prefix_len)
        length = len(ids)
        padded = np.full((1, cfg.prefix_len), PAD_ID, np.int64)
        padded[0, :length] = ids
        if constrained is None:
            constrained = self.constrained
        bias_np = self.vocab_bias(ids) if constrained \
            else np.zeros((cfg.vocab_size,), np.float32)
        # device work runs in inference mode, never across a yield (the
        # mode is the calling thread's)
        with torch.inference_mode():
            bias = torch.as_tensor(bias_np, device=dev)
            cache, logits = prefill(
                self.params, torch.as_tensor(padded, device=dev),
                torch.tensor([length], device=dev), cfg)
            # the prefill's own token obeys the same constraint
            # (host-side: the logits are fetched for the argmax anyway)
            first_np = logits.cpu().numpy() + bias_np[None]
        first = int(np.argmax(first_np, axis=-1)[0])
        budget = min(max_tokens or cfg.ans_len,
                     cfg.max_len - length - 1)
        # the prefill already produced token 0; stream it with block 1
        out_ids: list[int] = [first]
        if first == EOS_ID:
            return
        emitted = ""
        text = self.tokenizer.decode(out_ids)
        if text:
            yield text
            emitted = text
        pos = length
        tok = torch.tensor([first], device=dev)
        produced = 1
        # fixed k_steps, as in JAX (a block is its unit of dispatch)
        while produced < budget \
                and length + produced + self.block <= cfg.max_len:
            with torch.inference_mode():
                ids_blk, cache, pos = decode_block(
                    self.params, cache, tok, pos, cfg=cfg,
                    k_steps=self.block, bias=bias)
                blk = ids_blk.cpu().numpy()[0][: budget - produced]
                # the block's last token; a truncated block ends the loop
                tok = ids_blk[:, -1]
            produced += len(blk)
            done = EOS_ID in blk
            out_ids.extend(int(t) for t in blk)
            # re-decode the full id list (## merges can join across
            # block boundaries) and emit the suffix
            text = self.tokenizer.decode(out_ids)
            if len(text) > len(emitted):
                yield text[len(emitted):]
                emitted = text
            if done:
                return
