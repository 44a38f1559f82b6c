"""MiniLM-class sentence encoder: serving and contrastive training.

Counterpart of ``rag_foundation_tpu/models/encoder.py``: its config,
parameters, forward pass, host-facing ``MiniLMEncoder``, checkpoint
functions and the contrastive training step (``contrastive_loss``,
``make_train_step``). Parameters are a plain dict with the JAX tree's
names and layouts (``tok_emb``, ``pos_emb``, ``ln_f``, ``blocks[i]`` with
``qkv [h, 3h]`` etc.), so a JAX checkpoint loads as it is and
``params_from_jax`` carries a JAX parameter tree across.

Numerics follow the JAX function: parameters and activations in the
config's dtype (bf16 by default), layernorm statistics in f32 (eps 1e-6),
matmuls accumulated in f32, the tanh-approximate GELU (``jax.nn.gelu``'s
default), masked mean pooling in f32, then an L2 norm. The bias of a
dense layer is added by ``torch.addmm`` in the working dtype (JAX adds it
to the f32 product before one rounding; bf16 results may differ by a
rounding of the product).

Attention goes through ``ops.flash_attention.flash_attention`` at every
sequence length: the hand-written kernels for CUDA tensors (forward, and
under autograd the two backward kernels), the plain versions for CPU
tensors. Pad tokens get segment 0 and real tokens segment 1, as in the
JAX flash path, so a real token never attends to a pad; a pad query
attends to pads only, where JAX's einsum path lets it see the real
tokens. Pad rows are never pooled, so the embeddings and the gradients
agree.

Training differs from JAX in idiom only: gradients come from
``loss.backward()`` through ``F.embedding``, the ``addmm`` dense layers,
the f32 layernorms and ``FlashAttention``; the optimizer
(``models/optim.py``) updates the parameter tensors in place and holds
its state, where JAX threads a new tree and an ``opt_state``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rag_foundation_tpu_torch.models.optim import (OptimizerFactory,
                                                   clip_by_global_norm_)
from rag_foundation_tpu_torch.models.tokenizer import (PAD_ID,
                                                       TOKENIZER_VERSION,
                                                       Tokenizer)
from rag_foundation_tpu_torch.ops.flash_attention import flash_attention
from rag_foundation_tpu_torch.utils.device import resolve_device


class EncoderConfig(NamedTuple):
    vocab_size: int = 30_522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    ffn: int = 1536
    max_len: int = 128
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _tree(cfg: EncoderConfig, dense, const) -> dict:
    """The parameter tree with JAX's names and layouts:
    ``dense(fan_in, shape)`` makes a weight, ``const(value, shape,
    dtype)`` a bias or a layernorm parameter (f32, as in JAX). Weights are
    made in JAX's order (embeddings, then each block's qkv, proj, fc1,
    fc2)."""
    h, dt = cfg.hidden, cfg.tdtype

    def ln():
        return {"g": const(1.0, (h,), torch.float32),
                "b": const(0.0, (h,), torch.float32)}

    params = {"tok_emb": dense(h, (cfg.vocab_size, h)),
              "pos_emb": dense(h, (cfg.max_len, h)),
              "ln_f": ln(), "blocks": []}
    for _ in range(cfg.layers):
        params["blocks"].append({
            "qkv": dense(h, (h, 3 * h)),
            "qkv_b": const(0.0, (3 * h,), dt),
            "proj": dense(h, (h, h)),
            "proj_b": const(0.0, (h,), dt),
            "ln1": ln(),
            "fc1": dense(h, (h, cfg.ffn)),
            "fc1_b": const(0.0, (cfg.ffn,), dt),
            "fc2": dense(cfg.ffn, (cfg.ffn, h)),
            "fc2_b": const(0.0, (h,), dt),
            "ln2": ln(),
        })
    return params


def _map(tree, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; ``key`` is
    the leaf's path as ``jax.tree_util.keystr`` writes it
    (``"['blocks'][0]['fc1']"``)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _leaves(tree) -> dict:
    """``{key: leaf}`` of every leaf, keyed as ``_map`` keys them."""
    out = {}
    _map(tree, out.__setitem__)
    return out


def init_params(generator: torch.Generator, cfg: EncoderConfig) -> dict:
    """Transformer-encoder parameters on ``generator``'s device: weights
    from a normal truncated to ±2σ, scaled by ``fan_in ** -0.5``; biases
    0, layernorm gains 1. Other draws than ``jax.random``'s for the same
    seed."""
    device = generator.device

    def dense(fan_in, shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (w * fan_in ** -0.5).to(cfg.tdtype)

    def const(value, shape, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return _tree(cfg, dense, const)


def params_from_jax(tree: dict, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``; bf16 arrives
    as ml_dtypes bfloat16). ``dtype`` casts every weight but the
    layernorm parameters (f32, as in JAX); None keeps each array's
    dtype. The card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def leaf(key, arr):
        arr = np.asarray(arr)
        if arr.dtype.kind not in "fiub":     # ml_dtypes bfloat16: exact
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))    # a writable copy
        if dtype is not None and not key.endswith(("['g']", "['b']")):
            t = t.to(dtype)
        return t.to(device)

    return _map(tree, leaf)


def _layernorm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    # f32 statistics regardless of activation dtype
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps=1e-6).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in ``x``'s dtype, f32 accumulation."""
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[1])


Attention = Callable[..., torch.Tensor]


def _attention(x: torch.Tensor, blk: dict, seg: torch.Tensor,
               cfg: EncoderConfig, attention: Attention) -> torch.Tensor:
    b, s, h = x.shape
    qkv = _dense(x, blk["qkv"], blk["qkv_b"])

    def heads(t):
        return t.view(b, s, cfg.heads, cfg.head_dim).transpose(1, 2) \
            .contiguous()

    q, k, v = (heads(t) for t in qkv.split(h, dim=-1))
    out = attention(q, k, v, seg, seg, cfg.head_dim ** -0.5)
    out = out.transpose(1, 2).reshape(b, s, h)
    return _dense(out, blk["proj"], blk["proj_b"])


def _ffn(x: torch.Tensor, blk: dict) -> torch.Tensor:
    h = _dense(x, blk["fc1"], blk["fc1_b"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return _dense(h, blk["fc2"], blk["fc2_b"])


def encode_tokens(params: dict, ids: torch.Tensor, cfg: EncoderConfig,
                  attention: Attention = flash_attention) -> torch.Tensor:
    """``ids [B, S]`` integer -> unit-norm ``[B, hidden] f32`` embeddings.

    ``attention`` is the segment-masked attention; the default is the
    kernel wrapper. ``ops.flash_attention.flash_attention_reference``
    computes the same function in plain PyTorch on any device."""
    mask = ids != PAD_ID
    s = ids.shape[1]
    x = F.embedding(ids.long(), params["tok_emb"]) + params["pos_emb"][:s]
    x = x.to(cfg.tdtype)
    seg = mask.to(torch.int32).contiguous()
    for blk in params["blocks"]:
        x = x + _attention(_layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]),
                           blk, seg, cfg, attention)
        x = x + _ffn(_layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"]), blk)
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    # masked mean pooling, f32
    m = mask[:, :, None].float()
    pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    norm = pooled.norm(dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-9)


# -- contrastive training step (in-batch negatives) --------------------------

def info_nce(q: torch.Tensor, d: torch.Tensor, temperature: float = 0.05,
             symmetric: bool = False) -> torch.Tensor:
    """InfoNCE with in-batch negatives over embeddings ``q, d [B, h]``:
    align query i with doc i against every doc of the batch (logits
    ``[B, B]``). ``symmetric`` adds the doc->query direction. A 0-d f32
    tensor."""
    logits = (q @ d.T) / temperature
    labels = torch.arange(q.shape[0], device=logits.device)
    loss = F.cross_entropy(logits, labels)
    if symmetric:
        loss = 0.5 * (loss + F.cross_entropy(logits.T, labels))
    return loss


def contrastive_loss(params: dict, q_ids: torch.Tensor, d_ids: torch.Tensor,
                     cfg: EncoderConfig, temperature: float = 0.05,
                     symmetric: bool = False,
                     attention: Attention = flash_attention) -> torch.Tensor:
    """``info_nce`` of the encoded queries and docs: query i aligned with
    doc i. A 0-d f32 tensor."""
    return info_nce(encode_tokens(params, q_ids, cfg, attention),
                    encode_tokens(params, d_ids, cfg, attention),
                    temperature, symmetric)


def make_step(loss_fn, optimizer: OptimizerFactory, *,
              max_grad_norm: float | None = None):
    """A ``(params, *batch) -> loss`` step that updates ``params`` in
    place: gradients of ``loss_fn(params, *batch)``, clipped to
    ``max_grad_norm`` by ``clip_by_global_norm_`` when it is given
    (optax's ``chain(clip_by_global_norm, ...)``), then one step of the
    optimizer that ``optimizer`` builds over the leaves at the first call
    and keeps (it holds the state JAX threads as ``opt_state``). The
    optimizer updates each leaf in its own dtype: JAX's ``p +
    u.astype(p.dtype)``. Returns the loss, detached, on the device (no
    host sync)."""
    state: dict = {}

    def step(params: dict, *batch: torch.Tensor) -> torch.Tensor:
        leaves = list(_leaves(params).values())
        if "opt" not in state:
            for p in leaves:
                p.requires_grad_(True)
            state["ids"] = [id(p) for p in leaves]
            state["opt"] = optimizer(leaves)
        elif state["ids"] != [id(p) for p in leaves]:
            raise ValueError("a train step updates the parameters it was "
                             "first called with; make a new step for others")
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *batch)
        loss.backward()
        if max_grad_norm is not None:
            clip_by_global_norm_(leaves, max_grad_norm)
        opt.step()
        return loss.detach()

    return step


def make_train_step(cfg: EncoderConfig, optimizer: OptimizerFactory, *,
                    max_grad_norm: float | None = None, **loss_kwargs):
    """A ``(params, q_ids, d_ids) -> loss`` step (``make_step``) of
    ``contrastive_loss(..., **loss_kwargs)``."""
    return make_step(
        lambda params, q_ids, d_ids: contrastive_loss(
            params, q_ids, d_ids, cfg, **loss_kwargs),
        optimizer, max_grad_norm=max_grad_norm)


# -- host-facing encoder ------------------------------------------------------

class MiniLMEncoder:
    """``encode(list[str]) -> np.ndarray [n, dim]`` on one device.

    Batches are padded to a power of two and sequences trimmed to a
    power-of-two bucket from ``SEQ_BUCKET_FLOOR`` up to ``max_len``, as
    in the JAX encoder (the trailing columns cut are all PAD)."""

    # the JAX encoder's name, kept verbatim: it is part of a store's
    # encoder fingerprint, which both engines write and check
    name = "minilm-jax"
    SEQ_BUCKET_FLOOR = 16

    def __init__(self, dim: int = 384, *, cfg: EncoderConfig | None = None,
                 params: dict | None = None, seed: int = 0,
                 max_len: int = 128, device: str | torch.device = "cuda"):
        self.cfg = cfg or EncoderConfig(hidden=dim, max_len=max_len)
        if self.cfg.hidden != dim:
            raise ValueError("dim must match cfg.hidden")
        self.dim = dim
        self.device = resolve_device(device)
        self.tokenizer = Tokenizer(vocab_size=self.cfg.vocab_size)
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed),
                                 self.cfg)
        self.params = _map(params, lambda _, t: t.to(self.device))

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        ids = self.tokenizer.encode_batch(texts, self.cfg.max_len)
        n = ids.shape[0]
        bucket = 1
        while bucket < n:
            bucket *= 2
        if bucket != n:
            ids = np.pad(ids, ((0, bucket - n), (0, 0)))
        longest = int((ids != PAD_ID).sum(axis=1).max())
        seq = self.SEQ_BUCKET_FLOOR
        while seq < longest:
            seq *= 2
        seq = min(seq, self.cfg.max_len)
        with torch.inference_mode():
            out = encode_tokens(self.params, torch.as_tensor(
                ids[:, :seq], device=self.device), self.cfg)
            return out[:n].cpu().numpy()


# -- checkpoints (the JAX npz format) -----------------------------------------

_CFG_FIELDS = ("hidden", "layers", "heads", "ffn", "vocab_size", "max_len")


def save_params(params: dict, path: str,
                cfg: EncoderConfig | None = None) -> None:
    """Write ``params`` as the JAX encoder's ``save_params`` does: one
    array a leaf under its ``keystr`` name, bf16 stored as f32, the
    architecture as ``__cfg_*`` and the tokenizer version."""
    arrays = {}
    for key, t in _leaves(params).items():
        t = t.detach().cpu()
        if t.dtype not in (torch.float32, torch.float64):
            t = t.float()       # np.savez cannot store bfloat16
        arrays[key] = t.numpy()
    if cfg is not None:
        for f in _CFG_FIELDS:
            arrays[f"__cfg_{f}"] = np.int64(getattr(cfg, f))
    arrays["__tok_version"] = np.int64(TOKENIZER_VERSION)
    np.savez_compressed(path, **arrays)


def checkpoint_config(path: str, **overrides) -> EncoderConfig | None:
    """EncoderConfig stored in a checkpoint, or None for config-less
    (pre-metadata) checkpoints."""
    with np.load(path) as z:
        if "__cfg_hidden" not in z:
            return None
        fields = {f: int(z[f"__cfg_{f}"]) for f in _CFG_FIELDS}
    fields.update(overrides)
    return EncoderConfig(**fields)


def load_params(path: str, cfg: EncoderConfig,
                device: str | torch.device = "cuda") -> dict:
    """Parameters of ``cfg``'s layout from a JAX-format checkpoint, cast
    to the layout's dtypes, on ``device`` (the card unless the caller asks
    for the CPU). Raises, as the JAX loader does, on another tokenizer
    version, a missing key or a shape of another config."""
    device = resolve_device(device)
    template = _tree(cfg, lambda fan_in, shape: (shape, cfg.tdtype),
                     lambda value, shape, dtype: (shape, dtype))
    with np.load(path) as z:
        ckpt_tok = int(z["__tok_version"]) if "__tok_version" in z \
            else 1
        if ckpt_tok != TOKENIZER_VERSION:
            raise ValueError(
                f"checkpoint {path} was trained with tokenizer "
                f"v{ckpt_tok}, this build tokenizes v"
                f"{TOKENIZER_VERSION} — embeddings would live in "
                f"incompatible spaces; retrain or pin the matching "
                f"build")

        def leaf(key, spec):
            shape, dtype = spec
            if key not in z:
                raise ValueError(f"checkpoint {path} missing {key}")
            arr = z[key]
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint {path} {key} shape {arr.shape} != "
                    f"expected {shape} — was it trained with a "
                    f"different EncoderConfig? (use checkpoint_config)")
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=dtype)

        return _map(template, leaf)
