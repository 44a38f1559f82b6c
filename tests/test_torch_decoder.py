"""The port's generative decoder (``models/decoder.py``) against the JAX
package's, on the same inputs, on the CPU.

f32: a seeded tiny config with JAX's parameters carried across by
``params_from_jax``: logits, loss, prefill and greedy ids. bf16: the
repository's two checkpoints, each loaded by both packages from the same
file, held within ``BF16_LOGIT_TOL`` and margin-aware greedy agreement.
Then the port against itself (KV-cache decode against the full forward),
checkpoints both ways, and ``TextGenerator``.
"""

import functools
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.models import decoder as jd
from rag_foundation_tpu.models.gen_tokenizer import GenTokenizer as JTok
from rag_foundation_tpu.models.gen_tokenizer import \
    train_gen_vocab as jax_train
from rag_foundation_tpu_torch.models import decoder as td
from rag_foundation_tpu_torch.models.gen_tokenizer import (BOS_ID, EOS_ID,
                                                           PAD_ID, SEP_ID,
                                                           GenTokenizer)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "checkpoints" / "decoder_smoke.npz")
DISTILL = str(ROOT / "checkpoints" / "decoder_distill.npz")

# f32 logits: the same f32 products summed in another order through two
# layers (measured ~2e-6 at this size)
F32_LOGIT_TOL = 1e-4
F32_LOSS_RTOL = 1e-5
# bf16 logits, JAX against the port on the same bf16 weights. Both round
# every activation to bf16 (8 significant bits) after f32 sums taken in
# another order, so a rounding can land one bf16 ulp (2^-8 relative) on
# the other side; such flips in the residual stream, through the layers
# and the tied head, move logits of magnitude up to ~17 by a few
# hundredths (worst seen at full width: 0.071 prefill, 0.075 decode). A
# wrong layer, mask or cache slot moves them by whole units
BF16_LOGIT_TOL = 2.0 ** -3

TEXTS = [
    "The mount slews at 4.5 degrees per second, under nominal load.",
    "Quarterly revenue grew 12% driven by cloud subscriptions.",
    "Operators check the cooling panel every 30 minutes.",
    "A telemetry fault raises an alert within 5 seconds.",
] * 3


@pytest.fixture(scope="module")
def tokenizer():
    return GenTokenizer(jax_train(TEXTS, 400))


def _cfgs(vocab, **kw):
    fields = dict(vocab_size=vocab, hidden=64, layers=2, heads=4, ffn=128,
                  max_len=96, ans_len=40, dtype="float32")
    fields.update(kw)
    return jd.DecoderConfig(**fields), td.DecoderConfig(**fields)


def _both(jcfg, seed=0):
    pj = jd.init_params(jax.random.key(seed), jcfg)
    pt = td.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                            device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def f32_model(tokenizer):
    jcfg, tcfg = _cfgs(tokenizer.vocab_size)
    pj, pt = _both(jcfg)
    return pj, pt, jcfg, tcfg


def _prompt(tokenizer, cfg, question, evidences):
    ids = tokenizer.encode_prompt(question, evidences, cfg.prefix_len)
    padded = np.full((1, cfg.prefix_len), PAD_ID, np.int32)
    padded[0, :len(ids)] = ids
    return ids, padded


def _prefill_both(pj, pt, jcfg, tcfg, padded, length):
    cj, lj = jax.jit(functools.partial(jd.prefill, cfg=jcfg))(
        pj, jnp.asarray(padded), jnp.array([length], jnp.int32))
    with torch.inference_mode():
        ct, lt = td.prefill(pt, torch.as_tensor(padded),
                            torch.tensor([length]), tcfg)
    return cj, np.asarray(lj), ct, lt


# -- f32: JAX's parameters, the same numbers ---------------------------------

def test_config_properties():
    j, t = jd.DecoderConfig(), td.DecoderConfig()
    assert tuple(t) == tuple(j) and t._fields == j._fields
    assert (t.head_dim, t.prefix_len) == (j.head_dim, j.prefix_len) == \
        (64, 416)
    assert t.tdtype == torch.bfloat16
    assert t._replace(dtype="float32").tdtype == torch.float32


def test_forward_logits_f32(f32_model):
    pj, pt, jcfg, tcfg = f32_model
    rng = np.random.default_rng(0)
    ids = rng.integers(5, jcfg.vocab_size, size=(3, 40)).astype(np.int32)
    ids[1, 30:] = PAD_ID              # right padding, masked as keys
    ids[2, :3] = (BOS_ID, 7, SEP_ID)
    want = np.asarray(jd.forward(pj, jnp.asarray(ids), jcfg))
    with torch.inference_mode():
        got = td.forward(pt, torch.as_tensor(ids), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_LOGIT_TOL)


@pytest.mark.parametrize("z_reg", [1e-4, 0.0, 0.3])
def test_lm_loss_f32(f32_model, z_reg):
    pj, pt, jcfg, tcfg = f32_model
    rng = np.random.default_rng(1)
    toks = rng.integers(5, jcfg.vocab_size, size=(4, 33)).astype(np.int32)
    mask = rng.random((4, 33)) < 0.4
    want = float(jd.lm_loss(pj, jnp.asarray(toks), jnp.asarray(mask), jcfg,
                            z_reg=z_reg))
    with torch.inference_mode():
        got = td.lm_loss(pt, torch.as_tensor(toks), torch.as_tensor(mask),
                         tcfg, z_reg=z_reg)
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=F32_LOSS_RTOL)


def test_prefill_cache_and_logits_f32(tokenizer, f32_model):
    pj, pt, jcfg, tcfg = f32_model
    ids, padded = _prompt(tokenizer, jcfg, "how fast does the mount slew?",
                          TEXTS[:3])
    cj, lj, ct, lt = _prefill_both(pj, pt, jcfg, tcfg, padded, len(ids))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=F32_LOGIT_TOL)
    for name in ("k", "v"):
        assert tuple(ct[name].shape) == cj[name].shape == (
            2, 1, 4, 96, 16)
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   rtol=0, atol=F32_LOGIT_TOL)


def _bias(vocab, seed):
    """A constrained-decoding-like bias: -1e9 on a random half."""
    b = np.zeros((vocab,), np.float32)
    b[np.random.default_rng(seed).random(vocab) < 0.5] = -1e9
    b[EOS_ID] = -1e9      # the answer runs the whole block
    return b


@pytest.mark.parametrize("biased", [False, True])
def test_decode_block_ids_f32(tokenizer, f32_model, biased):
    """Greedy ids over 48 steps (three blocks of 16) are identical."""
    pj, pt, jcfg, tcfg = f32_model
    ids, padded = _prompt(tokenizer, jcfg, "what does the cooling panel do?",
                          TEXTS[2:4])
    length = len(ids)
    cj, lj, ct, lt = _prefill_both(pj, pt, jcfg, tcfg, padded, length)
    bias = _bias(jcfg.vocab_size, 3) if biased else None
    tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
    tok_t = torch.argmax(lt, -1)
    assert int(tok_j[0]) == int(tok_t[0])
    pos_j, pos_t = jnp.int32(length), length
    got_j, got_t = [], []
    with torch.inference_mode():
        for _ in range(3):
            bj, cj, pos_j = jd.decode_block(
                pj, cj, tok_j, pos_j, cfg=jcfg, k_steps=16,
                bias=None if bias is None else jnp.asarray(bias))
            bt, ct, pos_t = td.decode_block(
                pt, ct, tok_t, pos_t, cfg=tcfg, k_steps=16,
                bias=None if bias is None else torch.as_tensor(bias))
            got_j += np.asarray(bj)[0].tolist()
            got_t += bt[0].tolist()
            tok_j, tok_t = bj[:, -1], bt[:, -1]
    assert pos_t == int(pos_j) == length + 48
    assert got_t == got_j
    if biased:
        allowed = set(np.flatnonzero(bias == 0).tolist())
        assert set(got_t) <= allowed


def _eos_gaps(pt, tcfg, ct, tok, pos, steps):
    """(greedy ids, per-step max-logit minus EOS-logit) of the port's
    unbiased decode from a copy of the cache."""
    cache = {k: v.clone() for k, v in ct.items()}
    ids, gaps = [], []
    with torch.inference_mode():
        for s in range(steps):
            logits, cache = td._decode_one(pt, cache, tok, pos + s, tcfg)
            tok = torch.argmax(logits, -1)
            ids.append(int(tok[0]))
            gaps.append(float(logits[0].max() - logits[0, EOS_ID]))
    return ids, gaps


def test_decode_block_eos_bias_ends_inside_a_block_f32(tokenizer, f32_model):
    """A bias that favours EOS by more than its logit gap at step ``s``
    (and less than every earlier gap) ends the answer at step ``s`` of a
    block: both packages emit EOS there and pin it after."""
    pj, pt, jcfg, tcfg = f32_model
    k_steps = 16
    for question in ("how fast?", "what grew?", "who checks the panel?",
                     "when does a fault alert?"):
        ids, padded = _prompt(tokenizer, jcfg, question, TEXTS[:2])
        length = len(ids)
        cj, lj, ct, lt = _prefill_both(pj, pt, jcfg, tcfg, padded, length)
        greedy, gaps = _eos_gaps(pt, tcfg, ct, torch.argmax(lt, -1), length,
                                 k_steps)
        if EOS_ID in greedy:
            continue
        # a step whose gap lies 0.2 below every earlier one
        stop = next((s for s in range(2, k_steps - 2)
                     if gaps[s] < min(gaps[:s]) - 0.2), None)
        if stop is not None:
            break
    else:
        pytest.fail("no prompt gives an EOS gap that ends a block inside")
    bias = np.zeros((jcfg.vocab_size,), np.float32)
    bias[EOS_ID] = (gaps[stop] + min(gaps[:stop])) / 2
    bj, _, _ = jd.decode_block(pj, cj, jnp.argmax(lj, -1).astype(jnp.int32),
                               jnp.int32(length), cfg=jcfg, k_steps=k_steps,
                               bias=jnp.asarray(bias))
    with torch.inference_mode():
        bt, _, _ = td.decode_block(pt, ct, torch.argmax(lt, -1), length,
                                   cfg=tcfg, k_steps=k_steps,
                                   bias=torch.as_tensor(bias))
    got = bt[0].tolist()
    assert got == np.asarray(bj)[0].tolist()
    assert got[:stop] == greedy[:stop]
    assert got[stop:] == [EOS_ID] * (k_steps - stop)


# -- bf16: the repository's checkpoints, loaded by both packages -------------

@functools.lru_cache(maxsize=None)
def _loaded(path):
    pj, jcfg, jtok = jd.load_decoder(path)
    pt, tcfg, ttok = td.load_decoder(path, device="cpu")
    return pj, jcfg, jtok, pt, tcfg, ttok


def _teacher_forced(pj, jcfg, cj, pt, tcfg, ct, seq, length):
    """Per-step f32 logits of both packages' ``_decode_one`` fed the same
    ids ``seq`` from position ``length`` on."""
    step_j = jax.jit(functools.partial(jd._decode_one, cfg=jcfg))
    lj, lt = [], []
    with torch.inference_mode():
        for s, tok in enumerate(seq):
            out_j, cj = step_j(pj, cj, jnp.asarray([tok], jnp.int32),
                               jnp.int32(length + s))
            out_t, ct = td._decode_one(pt, ct, torch.tensor([tok]),
                                       length + s, tcfg)
            lj.append(np.asarray(out_j)[0])
            lt.append(out_t[0].numpy())
    return np.stack(lj), np.stack(lt)


@pytest.mark.parametrize("path,n_prompts,blocks", [
    (SMOKE, 3, 3), (DISTILL, 1, 3)], ids=["decoder_smoke", "decoder_distill"])
def test_bf16_checkpoint_prefill_and_greedy_margin_aware(path, n_prompts,
                                                         blocks):
    """Prefill logits within BF16_LOGIT_TOL; teacher-forced on JAX's
    greedy ids (EOS banned, so the answer runs ``blocks`` blocks), the
    port's argmax equals JAX's on every step where JAX's top-1/top-2
    margin exceeds twice that tolerance. Steps below it are counted."""
    pj, jcfg, jtok, pt, tcfg, ttok = _loaded(path)
    assert tcfg == td.DecoderConfig(**jcfg._asdict())
    assert ttok.vocab == jtok.vocab
    bias = np.zeros((jcfg.vocab_size,), np.float32)
    bias[EOS_ID] = -1e9
    worst, asserted, below = 0.0, 0, 0
    for i in range(n_prompts):
        ev = [" ".join(TEXTS[i:i + 4]) + f" Project {i} is ZEBRA{7 * i}."]
        ids, padded = _prompt(ttok, tcfg, f"what is project {i}?", ev * 6)
        length = len(ids)
        cj, lj, ct, lt = _prefill_both(pj, pt, jcfg, tcfg, padded, length)
        worst = max(worst, float(np.abs(lt.numpy() - lj).max()))
        np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                                   atol=BF16_LOGIT_TOL)
        first = int(np.argmax(lj[0] + bias))
        blk, _, _ = jd.decode_block(
            pj, jax.tree_util.tree_map(jnp.copy, cj),
            jnp.array([first], jnp.int32), jnp.int32(length), cfg=jcfg,
            k_steps=16 * blocks, bias=jnp.asarray(bias))
        seq = [first] + np.asarray(blk)[0].tolist()
        fj, ft = _teacher_forced(pj, jcfg, cj, pt, tcfg, ct, seq[:-1],
                                 length)
        worst = max(worst, float(np.abs(ft - fj).max()))
        np.testing.assert_allclose(ft, fj, rtol=0, atol=BF16_LOGIT_TOL)
        for s in range(len(seq) - 1):
            top2 = np.sort(fj[s] + bias)[-2:]
            assert int(np.argmax(fj[s] + bias)) == seq[s + 1]
            if top2[1] - top2[0] > 2 * BF16_LOGIT_TOL:
                asserted += 1
                assert int(np.argmax(ft[s] + bias)) == seq[s + 1], s
            else:
                below += 1
    print(f"{Path(path).name}: worst logit difference {worst:.4f}; "
          f"{asserted} steps asserted, {below} below the margin")
    assert asserted >= (len(seq) - 1) * n_prompts // 2


# -- the port against itself (tests/test_decoder.py's mechanics) --------------

@pytest.fixture(scope="module")
def tiny_bf16(tokenizer):
    cfg = td.DecoderConfig(vocab_size=tokenizer.vocab_size, hidden=32,
                           layers=2, heads=2, ffn=64, max_len=64, ans_len=16)
    return td.init_params(torch.Generator().manual_seed(0), cfg), cfg


def test_init_params_layout(tiny_bf16):
    params, cfg = tiny_bf16
    assert params["tok_emb"].shape == (cfg.vocab_size, 32)
    assert params["pos_emb"].shape == (64, 32)
    blk = params["blocks"][1]
    assert blk["qkv"].shape == (32, 96) and blk["qkv"].dtype == torch.bfloat16
    assert blk["ln1"]["g"].dtype == torch.float32
    assert float(blk["fc2"].float().abs().max()) <= 2 * 64 ** -0.5 + 1e-6


def test_kv_cache_matches_full_forward(tokenizer, tiny_bf16):
    """prefill + decode_block greedy == step-by-step full-forward greedy:
    the determinism sanitizer for the serving decode path."""
    params, cfg = tiny_bf16
    ids = [BOS_ID] + tokenizer.encode_text("how fast")[:10] + [SEP_ID]
    length = len(ids)
    padded = torch.full((1, cfg.prefix_len), PAD_ID)
    padded[0, :length] = torch.tensor(ids)
    with torch.inference_mode():
        cache, plog = td.prefill(params, padded, torch.tensor([length]), cfg)
        full = td.forward(params, torch.tensor([ids]), cfg)
        np.testing.assert_allclose(plog.numpy(), full[:, -1].numpy(),
                                   atol=3e-2, rtol=3e-2)
        blk, _, pos = td.decode_block(params, cache, torch.argmax(plog, -1),
                                      length, cfg=cfg, k_steps=5)
        assert pos == length + 5
        cur = list(ids) + [int(torch.argmax(plog, -1)[0])]
        for want in blk[0].tolist():
            nxt = int(torch.argmax(td.forward(
                params, torch.tensor([cur]), cfg)[0, -1]))
            assert nxt == want
            cur.append(nxt)


def test_decode_pins_eos(tiny_bf16):
    params, cfg = tiny_bf16
    with torch.inference_mode():
        blk, _, _ = td.decode_block(params, td.init_cache(cfg, device="cpu"),
                                    torch.tensor([EOS_ID]), 3, cfg=cfg,
                                    k_steps=4)
    assert blk[0].tolist() == [EOS_ID] * 4


@pytest.mark.parametrize("tie", [(5, 9), (9, 5), (0, 7)])
def test_argmax_picks_the_first_of_a_tie(tiny_bf16, tie):
    """torch.argmax and jnp.argmax both return the first maximal index: a
    bias that makes two tokens tie over everything picks the lower id."""
    params, cfg = tiny_bf16
    bias = np.full((cfg.vocab_size,), -1e9, np.float32)
    bias[list(tie)] = 0.0
    with torch.inference_mode():
        cache = td.init_cache(cfg, device="cpu")
        logits, _ = td._decode_one(params, cache, torch.tensor([7]), 0, cfg)
    # give both tokens the same biased logit
    bias[tie[0]] = float(logits[0, tie[1]] - logits[0, tie[0]])
    with torch.inference_mode():
        row = logits[0] + torch.as_tensor(bias)
        assert float(row[tie[0]]) == float(row[tie[1]])
    assert int(torch.argmax(row)) == min(tie)
    assert int(jnp.argmax(jnp.asarray(row.numpy()))) == min(tie)


# -- checkpoints, both ways ---------------------------------------------------

def _jax_keys(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in flat}


def test_checkpoint_jax_to_port_and_back(tmp_path, tokenizer):
    jcfg, _ = _cfgs(tokenizer.vocab_size, dtype="bfloat16")
    pj = jd.init_params(jax.random.key(3), jcfg)
    jtok = JTok(tokenizer.vocab)
    a = str(tmp_path / "jax.npz")
    jd.save_decoder(pj, a, jcfg, jtok)
    pt, tcfg, ttok = td.load_decoder(a, device="cpu")
    assert tuple(tcfg) == tuple(jcfg) and ttok.vocab == jtok.vocab
    assert td.checkpoint_meta(a) == jd.checkpoint_meta(a)
    from rag_foundation_tpu_torch.models.encoder import _leaves
    want = _jax_keys(pj)
    got = _leaves(pt)
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].float().numpy(), arr)
        assert got[key].dtype == (torch.float32 if key.endswith(
            ("['g']", "['b']")) else torch.bfloat16)
    # the port writes it back; JAX loads the port's file
    b = str(tmp_path / "port.npz")
    td.save_decoder(pt, b, tcfg, ttok)
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key])
            assert za[key].dtype == zb[key].dtype
    pj2, jcfg2, jtok2 = jd.load_decoder(b)
    assert jcfg2 == jcfg and jtok2.vocab == jtok.vocab
    assert td.checkpoint_meta(b) == jd.checkpoint_meta(b) == \
        jd.checkpoint_meta(a)
    for key, arr in _jax_keys(pj2).items():
        np.testing.assert_array_equal(arr, want[key])


def test_load_rejects_non_decoder_npz(tmp_path):
    p = str(tmp_path / "junk.npz")
    np.savez(p, a=np.zeros(3))
    with pytest.raises(ValueError, match="not a decoder checkpoint"):
        td.load_decoder(p, device="cpu")


def _edited(tmp_path, drop=None, reshape=None):
    with np.load(SMOKE) as z:
        arrays = {k: z[k] for k in z.files}
    if drop:
        del arrays[drop]
    if reshape:
        arrays[reshape] = arrays[reshape][:-1]
    p = str(tmp_path / "edited.npz")
    np.savez(p, **arrays)
    return p


def test_load_rejects_a_missing_key(tmp_path):
    key = "['blocks'][1]['fc2_b']"
    p = _edited(tmp_path, drop=key)
    with pytest.raises(ValueError, match=r"missing \['blocks'\]\[1\]") as e:
        td.load_decoder(p, device="cpu")
    with pytest.raises(ValueError) as j:
        jd.load_decoder(p)
    assert str(e.value) == str(j.value)


def test_load_rejects_a_wrong_shape(tmp_path):
    p = _edited(tmp_path, reshape="['pos_emb']")
    with pytest.raises(ValueError, match="model wants") as e:
        td.load_decoder(p, device="cpu")
    with pytest.raises(ValueError) as j:
        jd.load_decoder(p)
    assert str(e.value) == str(j.value)


# -- TextGenerator -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory, tokenizer, tiny_bf16):
    params, cfg = tiny_bf16
    p = str(tmp_path_factory.mktemp("dec") / "dec.npz")
    td.save_decoder(params, p, cfg, tokenizer)
    return p


def test_vocab_bias_equals_jax():
    jgen = jd.TextGenerator(SMOKE, block=4)
    tgen = td.TextGenerator(SMOKE, block=4, device="cpu")
    assert tgen._fn_ids == jgen._fn_ids
    for q, ev in (("how fast does the mount slew?", TEXTS[:2]),
                  ("", []), ("é ü 4.5 zzzqqq", TEXTS)):
        ids = tgen.tokenizer.encode_prompt(q, ev, tgen.cfg.prefix_len)
        got, want = tgen.vocab_bias(ids), jgen.vocab_bias(ids)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_text_generator_deterministic(tiny_ckpt):
    gen = td.TextGenerator(tiny_ckpt, block=4, device="cpu")
    out1 = "".join(gen.stream("how fast?", ["the mount slews at 4.5"]))
    out2 = "".join(gen.stream("how fast?", ["the mount slews at 4.5"]))
    assert out1 == out2


def test_constrained_decoding_only_emits_grounded_tokens(tiny_ckpt):
    """Every generated id comes from the prompt, the function-word
    allowlist or EOS (re-encoding the output stays in the allowed set)."""
    gen = td.TextGenerator(tiny_ckpt, block=4, constrained=True,
                           device="cpu")
    gen.prewarm()
    q, ev = "how fast does the mount slew?", "the mount slews at 4.5"
    prompt_ids = set(gen.tokenizer.encode_prompt(q, [ev],
                                                 gen.cfg.prefix_len))
    allowed = prompt_ids | gen._fn_ids | {EOS_ID}
    out = "".join(gen.stream(q, [ev]))
    for i in gen.tokenizer.encode_text(out):
        assert i in allowed, (i, gen.tokenizer._id2piece[i], out)
    assert out == "".join(gen.stream(q, [ev]))
    # the unconstrained path still runs, and max_tokens caps the answer
    "".join(gen.stream(q, [ev], constrained=False))
    short = "".join(gen.stream(q, [ev], max_tokens=2, constrained=False))
    assert len(gen.tokenizer.encode_text(short)) <= 2


def test_concurrent_streams_give_the_sequential_texts():
    """More threads than cores, the interpreter switching often: the
    streams share the parameters and nothing else."""
    import os
    import sys
    gen = td.TextGenerator(SMOKE, block=8, device="cpu")
    questions = [f"how long does maintenance of the {w} unit take?"
                 for w in ("cooling", "optics", "power", "sensor")]
    ev = ["Maintenance of the cooling unit takes 12 hours on average. "
          "Operators must check the optics panel every 30 minutes."]
    want = ["".join(gen.stream(q, ev, constrained=False))
            for q in questions]
    n = 2 * (os.cpu_count() or 4)
    got = [None] * n

    def run(i):
        got[i] = "".join(gen.stream(questions[i % 4], ev, constrained=False))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == [want[i % 4] for i in range(n)]


def test_text_generator_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        td.TextGenerator(SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA"):
        td.load_decoder(SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA"):
        td.init_cache(td.DecoderConfig())
