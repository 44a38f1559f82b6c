"""The port's decoder trainer (``tools/train_decoder.py``, the gradients
of ``models/decoder.lm_loss`` and its optimizer chain) against
``scripts/train_decoder.py`` and the JAX decoder, on the CPU.

- The host side (triples, vocabulary, token arrays): bit for bit the
  script's, on ``smoke_corpus(0)`` and on chunks of the quality docs.
- ``lm_loss`` and its gradients against ``jax.value_and_grad(lm_loss)``
  on a small config (vocab 300, hidden 64, 2 layers, 4 heads, ffn 128,
  max_len 48) with JAX's parameters carried across by
  ``params_from_jax``. f32: the loss within 1e-5 relative and every
  gradient within rtol 1e-4 plus 1e-4 of its leaf's largest magnitude
  (f32 sums in another order; observed 1.1e-6 of the largest). bf16: the
  two round at other places (a product's sum in another order can land
  one bf16 ulp, 2^-8 relative, on the other side; the layernorm's f32
  statistics are computed by another formula), a relative 2^-8 a rounding
  carried through two layers: the loss within 2e-3 and every leaf's
  gradient at cosine >= 0.999 with its largest element within 2^-4 of
  the leaf's largest magnitude (observed: the loss 4.1e-5 apart, cosine
  0.99993, 1.6% of the largest).
- Three steps of the script's chain (``clip_by_global_norm(1.0)``,
  ``adamw(warmup_cosine_decay_schedule(...), weight_decay=0.01)``, the
  update added in each parameter's dtype) against optax, in f32, with the
  global norm above 1 so that clipping acts: losses within 3e-6 and
  parameters within 1e-4, a tenth of one step at lr 1e-3. torch's AdamW
  decays the weights before the Adam step where optax adds the decay to
  the update, and Adam divides each gradient by its own running size, so
  a gradient near its rounding error moves its step by more than it
  moves the gradient. The key third of ``qkv_b`` is left out: adding a
  constant to a row's scores leaves its softmax unchanged, so that
  bias's gradient is exactly 0 in exact arithmetic and rounding noise in
  f32, which Adam turns into steps of +-lr in either package.
- ``python -m rag_foundation_tpu_torch.tools.train_decoder --smoke
  --device cpu`` cut to 3 steps and 300 triples: a checkpoint shaped
  like ``checkpoints/decoder_smoke.npz`` that JAX's ``load_decoder`` and
  ``TextGenerator`` load and stream from, and the script's result line.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_foundation_tpu.models import decoder as jd
from rag_foundation_tpu.models.gen_tokenizer import GenTokenizer as JTok
from rag_foundation_tpu.models.gen_tokenizer import \
    train_gen_vocab as jax_vocab
from rag_foundation_tpu_torch.models import decoder as td
from rag_foundation_tpu_torch.models import encoder as tenc
from rag_foundation_tpu_torch.models import optim
from rag_foundation_tpu_torch.models.gen_tokenizer import GenTokenizer
from rag_foundation_tpu_torch.models.gen_tokenizer import \
    train_gen_vocab as port_vocab
from rag_foundation_tpu_torch.tools import train_decoder as ttd

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "checkpoints" / "decoder_smoke.npz"
SMALL = dict(vocab_size=300, hidden=64, layers=2, heads=4, ffn=128,
             max_len=48, ans_len=16)
F32_LOSS_RTOL, F32_GRAD_RTOL, F32_GRAD_ATOL = 1e-5, 1e-4, 1e-4
BF16_LOSS_TOL, BF16_MIN_COS, BF16_GRAD_ATOL = 2e-3, 0.999, 2.0 ** -4
STEP_LOSS_TOL, STEP_PARAM_TOL = 3e-6, 1e-4
RESULT_KEYS = {"mode", "steps", "batch", "params_m", "triples", "ckpt",
               "train_s", "answerable_f1", "cloze_f1", "other_f1",
               "grounded_rate", "refusal_acc", "n_answerable", "n_refusal",
               "eval_s"}


def _script():
    """``scripts/train_decoder.py`` as a module (it imports JAX only
    inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "train_decoder_script", ROOT / "scripts" / "train_decoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()


def _quality_chunks(tmp_path) -> list[str]:
    """The quality docs as a corpus, cut by ``load_chunks``."""
    path = tmp_path / "quality.jsonl"
    with open(path, "w") as f:
        for doc in sorted((ROOT / "benchmarks" / "quality" / "docs")
                          .glob("*.md")):
            f.write(json.dumps({"text": doc.read_text()}) + "\n")
    return ttd.load_chunks(str(path))


# -- the host side, bit for bit ---------------------------------------------

@pytest.mark.parametrize("corpus,n,seed", [("smoke", 300, 0),
                                           ("quality", 60, 3)])
def test_triples_and_tokens_bit_identical_to_the_script(
        corpus, n, seed, tmp_path, monkeypatch):
    chunks = ttd.smoke_corpus(0) if corpus == "smoke" \
        else _quality_chunks(tmp_path)
    if corpus == "smoke":
        assert chunks == SCRIPT.smoke_corpus(0)
        assert (ttd.SMOKE_SENTENCES, ttd.SMOKE_NOUNS, ttd.SMOKE_UNITS) == \
            (SCRIPT.SMOKE_SENTENCES, SCRIPT.SMOKE_NOUNS, SCRIPT.SMOKE_UNITS)
    else:
        assert len(chunks) >= 15
    # record the cloze fallbacks: a cloze answer the cascade missed,
    # replaced by the removed span
    missed = []

    def token_f1(pred, gold):
        f1 = SCRIPT.token_f1(pred, gold)
        if f1 < 0.5:
            missed.append(gold)
        return f1

    monkeypatch.setattr(ttd, "token_f1", token_f1)
    port = ttd.build_triples(chunks, n, seed=seed)
    monkeypatch.undo()
    assert port == SCRIPT.build_triples(chunks, n, seed=seed)
    assert len(port) == n
    assert any(t["refusal"] for t in port)
    assert any(t["cloze"] and t["ans"] in missed for t in port)

    texts = chunks[:200] + [ttd.REFUSAL_TEXT] * 50
    vocab = port_vocab(texts, 2048)
    assert vocab == jax_vocab(texts, 2048)
    for max_len, prefix in ((192, 144), (96, 64)):
        got = ttd.tokenize_triples(GenTokenizer(vocab), port,
                                   max_len=max_len, prefix_len=prefix,
                                   log=lambda m: None)
        want = SCRIPT.tokenize_triples(JTok(vocab), port, max_len=max_len,
                                       prefix_len=prefix)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# -- lm_loss and its gradients against jax.value_and_grad ---------------------

def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    s = SMALL["max_len"]
    toks = rng.integers(5, SMALL["vocab_size"], size=(b, s)).astype(np.int32)
    toks[1, 30:] = 0                      # a PAD tail, masked as keys
    mask = np.zeros((b, s), np.int8)
    mask[:, 20:40] = 1
    mask[1, 30:] = 0
    return toks, mask


def _models(dtype, seed=0):
    jcfg = jd.DecoderConfig(**SMALL, dtype=dtype)
    tcfg = td.DecoderConfig(**SMALL, dtype=dtype)
    pj = jd.init_params(jax.random.key(seed), jcfg)
    pt = td.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                            device="cpu")
    return pj, pt, jcfg, tcfg


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _both_grads(dtype, seed=0):
    pj, pt, jcfg, tcfg = _models(dtype, seed)
    toks, mask = _batch(seed)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, m: jd.lm_loss(p, t, m, jcfg)))(
        pj, jnp.asarray(toks), jnp.asarray(mask))
    leaves = tenc._leaves(pt)
    for t in leaves.values():
        t.requires_grad_(True)
    port = td.lm_loss(pt, torch.from_numpy(toks), torch.from_numpy(mask),
                      tcfg)
    port.backward()
    for key, t in leaves.items():
        assert t.grad.dtype == t.dtype, key
    return (float(loss), _jax_leaves(grads), float(port.detach()),
            {k: t.grad.float().numpy() for k, t in leaves.items()})


def test_lm_loss_grads_f32_match_jax():
    loss, grads, port_loss, port_grads = _both_grads("float32")
    assert port_loss == pytest.approx(loss, rel=F32_LOSS_RTOL)
    assert port_grads.keys() == grads.keys()
    for key, want in grads.items():
        got = port_grads[key]
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(
            got, want, rtol=F32_GRAD_RTOL,
            atol=F32_GRAD_ATOL * float(np.abs(want).max()), err_msg=key)
    # lm_loss feeds max_len - 1 positions: pos_emb's last row gets no
    # gradient in either package
    assert not grads["['pos_emb']"][-1].any()
    assert not port_grads["['pos_emb']"][-1].any()
    assert grads["['pos_emb']"][:-1].any()


def test_lm_loss_grads_bf16_match_jax():
    loss, grads, port_loss, port_grads = _both_grads("bfloat16", seed=1)
    assert abs(port_loss - loss) <= BF16_LOSS_TOL
    for key, want in grads.items():
        got = port_grads[key]
        assert np.isfinite(got).all(), key
        scale = float(np.abs(want).max())
        if scale == 0.0:
            assert not got.any(), key
            continue
        g, w = got.ravel().astype(np.float64), want.ravel().astype(
            np.float64)
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= BF16_MIN_COS, (key, cos)
        assert np.abs(got - want).max() <= BF16_GRAD_ATOL * scale, key


def test_serving_records_no_graph():
    """Inference mode runs the same products without saving anything."""
    _, pt, _, tcfg = _models("bfloat16")
    for t in tenc._leaves(pt).values():
        t.requires_grad_(True)
    toks, _ = _batch()
    with torch.inference_mode():
        logits = td.forward(pt, torch.from_numpy(toks), tcfg)
    assert logits.dtype == torch.float32 and not logits.requires_grad


# -- the optimizer chain against optax ----------------------------------------

def test_three_steps_of_the_scripts_chain_match_optax():
    pj, pt, jcfg, tcfg = _models("float32", seed=2)
    lr, steps = 1e-3, 20                  # the script's schedule at 20 steps
    warmup = min(200, steps // 10)

    def sched(lib):
        return lib.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                                end_value=lr * 0.05)

    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(sched(optax), weight_decay=0.01))
    tstep = td.make_train_step(tcfg, optim.adamw(sched(optim),
                                                 weight_decay=0.01),
                               max_grad_norm=1.0)

    @jax.jit
    def jstep(params, opt_state, toks, mask):          # the script's
        loss, grads = jax.value_and_grad(jd.lm_loss)(params, toks, mask,
                                                     jcfg)
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(
            lambda p, u: p + u.astype(p.dtype), params, updates)
        return params, opt_state, loss, optax.global_norm(grads)

    params, opt_state, norms = pj, jopt.init(pj), []
    for i in range(3):
        toks, mask = _batch(10 + i)
        params, opt_state, loss, norm = jstep(
            params, opt_state, jnp.asarray(toks), jnp.asarray(mask))
        port_loss = tstep(pt, torch.from_numpy(toks),
                          torch.from_numpy(mask))
        assert port_loss.shape == () and not port_loss.requires_grad
        assert abs(float(port_loss) - float(loss)) <= STEP_LOSS_TOL
        norms.append(float(norm))
    assert max(norms) > 1.0, norms        # clipping acted
    h = SMALL["hidden"]
    moved = 0
    for key, want in _jax_leaves(params).items():
        got = tenc._leaves(pt)[key].detach().numpy()
        before = _jax_leaves(pj)[key]
        moved += not np.array_equal(want, before)
        if key.endswith("['qkv_b']"):        # the key bias: see the top
            got, want = np.delete(got, np.s_[h:2 * h]), \
                np.delete(want, np.s_[h:2 * h])
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_PARAM_TOL,
                                   err_msg=key)
    assert moved == len(_jax_leaves(params))


# -- the tool -----------------------------------------------------------------

def test_smoke_run_writes_a_checkpoint_jax_serves(tmp_path, capsys):
    out = str(tmp_path / "decoder_smoke_port.npz")
    ttd.main(["--smoke", "--device", "cpu", "--steps", "3",
              "--steps-per-call", "2", "--n-examples", "300", "--eval-n",
              "4", "--out", out])
    captured = capsys.readouterr()
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert set(result) == RESULT_KEYS
    assert (result["mode"], result["steps"], result["batch"],
            result["triples"], result["ckpt"]) == ("smoke", 3, 32, 300, out)
    for line in ("400 chunks (backend: cpu)", "step 2/3: loss",
                 "step 3/3: loss", "trained 3 steps in", f"saved {out}",
                 "eval: {"):
        assert line in captured.err, line
    # decoder_smoke.npz's keys, and its shapes at its vocabulary size
    with np.load(out) as got, np.load(SMOKE) as want:
        assert set(got.files) == set(want.files)
        assert int(got["__cfg_vocab_size"]) == int(want["__cfg_vocab_size"])
        for key in want.files:
            assert got[key].shape == want[key].shape, key
            if key.startswith("__"):
                assert np.array_equal(got[key], want[key]), key
    # JAX loads and serves it
    _, cfg, _ = jd.load_decoder(out)
    assert jd.checkpoint_meta(out) == jd.checkpoint_meta(str(SMOKE))
    gen = jd.TextGenerator(out, block=16)
    text = "".join(gen.stream("How often is the cooling panel checked?",
                              ["Operators must check the cooling panel "
                               "every 30 minutes."], max_tokens=8))
    assert isinstance(text, str)
    # what was saved is the port's trained model, read back by the port
    port = td.TextGenerator(out, block=16, device="cpu")
    assert port.cfg == td.DecoderConfig(**{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden", "layers", "heads", "ffn", "max_len",
        "ans_len")})


def test_train_returns_the_run(tmp_path):
    out = str(tmp_path / "run.npz")
    args = ttd.parse_args(["--smoke", "--device", "cpu", "--steps", "2",
                           "--n-examples", "200", "--eval-n", "2",
                           "--out", out])
    run = ttd.train(args, log=lambda m: None)
    assert run["losses"].shape == (2,) and np.isfinite(run["losses"]).all()
    assert run["cfg"].vocab_size == 347 and run["summary"]["ckpt"] == out
    assert run["tokens"].shape[1] == run["cfg"].max_len == 192
    assert set(run["seconds"]) == {"vocab", "triples", "tokenize", "train",
                                   "eval"}
    saved, _, _ = td.load_decoder(out, device="cpu")
    for key, t in tenc._leaves(run["params"]).items():
        assert torch.equal(tenc._leaves(saved)[key], t.detach()), key
    # the device batch draws come from a torch.Generator seeded seed + 1:
    # the same seed gives the same losses
    again = ttd.train(ttd.parse_args(
        ["--smoke", "--device", "cpu", "--steps", "2", "--n-examples",
         "200", "--eval-n", "2", "--out", str(tmp_path / "again.npz")]),
        log=lambda m: None)
    assert np.array_equal(again["losses"], run["losses"])


def test_default_device_is_the_card():
    assert ttd.parse_args(["--smoke"]).device == "cuda"
    with pytest.raises(SystemExit):
        ttd.parse_args([])                  # no corpus, no --smoke
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ttd.train(ttd.parse_args(["--smoke", "--steps", "1"]))
