"""The port's encoder training path against the JAX package's, on the CPU.

Both packages get the same parameters (a JAX init carried across with
``params_from_jax(..., device="cpu")``) and the same token ids, in a small
config: vocab 512, hidden 64, 2 layers, 4 heads, ffn 128, max_len 128.
Tolerances:

- f32 loss and gradients: 1e-5 of the largest gradient of a leaf, 3e-6
  on the loss (f32 sums in another order, the logits then scaled by
  1/temperature = 20: about 20 ulps of a loss near 1.4; observed 1.1e-6
  and 1.8e-6 relative on the gradients).
- Three optimizer steps (``optax.adamw(1e-3)``, and the trainer's recipe
  ``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay))``):
  losses within 3e-6; parameters within 1e-4, a tenth of one step of lr
  1e-3 (Adam divides each gradient by its own running size, so a
  gradient near its rounding error moves the step by more than it moves
  the gradient; observed 1.6e-5). The key third of ``qkv_b`` is left out:
  adding a constant to a row's scores leaves its softmax unchanged, so
  that bias's gradient is exactly 0 in exact arithmetic and rounding noise
  in f32, which Adam turns into steps of +-lr in either package.
- bf16 loss and gradients: the two round at other places (the JAX einsum
  path rounds the attention weights to bf16, the port's plain attention
  keeps them in f32; dense biases are added before or after a rounding),
  a relative 2^-9 a layer: the loss within 2e-2 and every leaf's
  gradient at cosine >= 0.99 with a norm within 5%.
- Schedules and clipping: 1e-6 relative (optax computes in f32).
- The ICT arrays: bit for bit.
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
from jax.experimental.pallas import tpu as pltpu

from rag_foundation_tpu.models import encoder as jenc
from rag_foundation_tpu.models.tokenizer import Tokenizer
from rag_foundation_tpu_torch.models import encoder as tenc
from rag_foundation_tpu_torch.models import optim
from rag_foundation_tpu_torch.models.tokenizer import Tokenizer as TTokenizer
from rag_foundation_tpu_torch.tools import train_encoder as ttrain

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128,
             max_len=128)
QUERIES = ["what changed about revenue", "summary of churn", "penguins",
           "x", "status report on kernel latency", "api limits"]
DOCS = ["the report covers revenue growth in detail",
        "churn improved significantly per the latest review",
        "penguins live in antarctica on the sea ice", "y",
        "notes about tpu kernel latency from the retrospective",
        "rate limits of the api and its quotas"]
F32_GRAD_TOL, F32_LOSS_TOL = 1e-5, 3e-6
STEP_LOSS_TOL, STEP_PARAM_TOL = 3e-6, 1e-4
BF16_LOSS_TOL, BF16_MIN_COS, BF16_NORM_TOL = 2e-2, 0.99, 0.05


def _cfgs(dtype="float32"):
    kw = dict(SMALL, dtype=dtype)
    return jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)


def _ids(q_len=32, d_len=64):
    tok = Tokenizer(vocab_size=SMALL["vocab_size"])
    return tok.encode_batch(QUERIES, q_len), tok.encode_batch(DOCS, d_len)


def _port_params(jp):
    return tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_loss_and_grads(jp, qi, di, jcfg, symmetric):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, q, d: jenc.contrastive_loss(p, q, d, jcfg, 0.05,
                                              symmetric)))(
        jp, jnp.asarray(qi), jnp.asarray(di))
    return float(loss), _jax_leaves(grads)


def _port_loss_and_grads(tp, qi, di, tcfg, symmetric):
    leaves = tenc._leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tenc.contrastive_loss(tp, torch.from_numpy(qi),
                                 torch.from_numpy(di), tcfg, 0.05, symmetric)
    loss.backward()
    return float(loss.detach()), {k: t.grad.float().numpy() for k, t in
                         leaves.items()}


def _assert_grads_close(port, ref):
    assert port.keys() == ref.keys()
    for key, want in ref.items():
        got = port[key]
        assert np.isfinite(got).all(), key
        tol = F32_GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("symmetric", [False, True])
def test_contrastive_loss_and_grads_match_jax_einsum_path(symmetric):
    jcfg, tcfg = _cfgs()
    jp = jenc.init_params(jax.random.key(0), jcfg)
    qi, di = _ids()
    loss, grads = _jax_loss_and_grads(jp, qi, di, jcfg, symmetric)
    port_loss, port_grads = _port_loss_and_grads(_port_params(jp), qi, di,
                                                 tcfg, symmetric)
    assert abs(port_loss - loss) <= F32_LOSS_TOL
    _assert_grads_close(port_grads, grads)


def test_contrastive_loss_grads_match_jax_flash_path(monkeypatch):
    """JAX with the library's Pallas flash attention forced (its forward
    and both backward kernels in TPU interpret mode, jit) against the
    port's ``FlashAttention`` on CPU tensors: S=128, head dim 16."""
    jcfg, tcfg = _cfgs()
    jp = jenc.init_params(jax.random.key(1), jcfg)
    qi, di = _ids(128, 128)
    monkeypatch.setattr(jenc, "_use_flash", lambda cfg, s: True)
    with pltpu.force_tpu_interpret_mode():
        loss, grads = _jax_loss_and_grads(jp, qi, di, jcfg, True)
    port_loss, port_grads = _port_loss_and_grads(_port_params(jp), qi, di,
                                                  tcfg, True)
    assert abs(port_loss - loss) <= F32_LOSS_TOL
    _assert_grads_close(port_grads, grads)


def _recipe(lib):
    sched = lib.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 10,
                                             end_value=5e-5)
    return lib.adamw(sched)


@pytest.mark.parametrize("recipe", ["adamw", "clip+warmup_cosine"])
def test_three_train_steps_match_optax(recipe):
    jcfg, tcfg = _cfgs()
    jp = jenc.init_params(jax.random.key(2), jcfg)
    qi, di = _ids()
    if recipe == "adamw":
        jopt, topt, clip = optax.adamw(1e-3), optim.adamw(1e-3), None
    else:
        jopt = optax.chain(optax.clip_by_global_norm(1.0), _recipe(optax))
        topt, clip = _recipe(optim), 1.0
    jstep = jax.jit(jenc.make_train_step(jcfg, jopt))
    tstep = tenc.make_train_step(tcfg, topt, max_grad_norm=clip)
    tp, opt_state, params = _port_params(jp), jopt.init(jp), jp
    for _ in range(3):
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(qi),
                                        jnp.asarray(di))
        port_loss = tstep(tp, torch.from_numpy(qi), torch.from_numpy(di))
        assert port_loss.shape == () and not port_loss.requires_grad
        assert abs(float(port_loss) - float(loss)) <= STEP_LOSS_TOL
    h = SMALL["hidden"]
    for key, want in _jax_leaves(params).items():
        got = tenc._leaves(tp)[key].detach().numpy()
        assert got.dtype == want.dtype, key
        if key.endswith("['qkv_b']"):        # the key bias: see the top
            got, want = np.delete(got, np.s_[h:2 * h]), \
                np.delete(want, np.s_[h:2 * h])
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_PARAM_TOL,
                                   err_msg=key)


def test_train_step_keeps_the_parameters_it_was_built_over():
    jcfg, tcfg = _cfgs()
    jp = jenc.init_params(jax.random.key(4), jcfg)
    qi, di = (torch.from_numpy(x) for x in _ids())
    step = tenc.make_train_step(tcfg, optim.adam(1e-3))
    tp = _port_params(jp)
    before = tp["ln_f"]["b"].clone()
    step(tp, qi, di)
    assert all(t.requires_grad for t in tenc._leaves(tp).values())
    assert not torch.equal(tp["ln_f"]["b"], before)
    with pytest.raises(ValueError, match="first called with"):
        step(_port_params(jp), qi, di)


def test_bf16_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jenc.init_params(jax.random.key(3), jcfg)
    qi, di = _ids()
    loss, grads = _jax_loss_and_grads(jp, qi, di, jcfg, True)
    tp = _port_params(jp)
    assert tp["tok_emb"].dtype == torch.bfloat16
    port_loss, port_grads = _port_loss_and_grads(tp, qi, di, tcfg, True)
    assert abs(port_loss - loss) <= BF16_LOSS_TOL
    for key, want in grads.items():
        got = port_grads[key].ravel().astype(np.float64)
        want = want.ravel().astype(np.float64)
        assert tenc._leaves(tp)[key].grad.dtype == \
            tenc._leaves(tp)[key].dtype, key
        if not want.any():
            continue
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= BF16_MIN_COS, (key, cos)
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) \
            <= BF16_NORM_TOL, key


@pytest.mark.parametrize("warmup,decay,end", [(3, 12, 5e-5), (0, 7, 0.0),
                                               (5, 6, 1e-4)])
def test_warmup_cosine_decay_schedule_matches_optax(warmup, decay, end):
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, decay,
                                             end_value=end)
    port = optim.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, decay,
                                              end_value=end)
    for count in range(decay + 4):
        np.testing.assert_allclose(port(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(int(scale * 100))
    grads = {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
             "b": (rng.standard_normal((11,)) * scale).astype(np.float32)}
    ref, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    params = [torch.zeros(v.shape, requires_grad=True) for v in
              grads.values()]
    for p, g in zip(params, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    norm = optim.clip_by_global_norm_(params, 1.0)
    want_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in grads.values()))
    np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
    for p, key in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=0)


def test_optimizers_take_optax_defaults():
    w = [torch.zeros(3, requires_grad=True)]
    opt = optim.adamw(1e-3)(w)
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4 and group["lr"] == 1e-3
    plain = optim.adam(2e-3)(w)
    assert isinstance(plain, torch.optim.Adam)
    assert plain.param_groups[0]["weight_decay"] == 0
    # a schedule: the n-th update (from 0) uses schedule(n)
    seen = []
    sched = optim.adamw(lambda n: 0.1 * (n + 1))(w)
    for _ in range(3):
        seen.append(sched.param_groups[0]["lr"])
        w[0].grad = torch.ones(3)
        sched.step()
    assert seen == [0.1, 0.2, 0.30000000000000004]


def _script():
    """``scripts/train_encoder.py`` as a module (it imports JAX only
    inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "train_encoder_script", ROOT / "scripts" / "train_encoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Enc:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer


def _corpus(tmp_path) -> str:
    """A jsonl of prose passages: the repository's own documents."""
    path = tmp_path / "corpus.jsonl"
    with open(path, "w") as f:
        for doc in sorted((ROOT / "docs").glob("*.md"))[:4] + [
                ROOT / "README.md"]:
            for para in doc.read_text().split("\n\n"):
                if len(para.split()) >= 30:
                    f.write(json.dumps({"text": para}) + "\n")
    return str(path)


def test_ict_arrays_bit_identical_to_the_script(tmp_path):
    script = _script()
    path = _corpus(tmp_path)
    chunks = ttrain.load_chunks(path, max_chunks=300)
    assert chunks == script.load_chunks(path, max_chunks=300)
    assert len(chunks) >= 50
    syn = {"the": [["a", 0.9]], "encoder": [["embedder", 0.8],
                                             ["model", 0.7]],
           "index": [["catalog", 0.6]], "store": [["bucket", 0.5]]}
    for s, p in ((None, 0.0), (syn, 0.5)):
        for fn in ("keyword_query", "sentence_query"):
            a, b = np.random.default_rng(5), np.random.default_rng(5)
            assert [getattr(ttrain, fn)(a, c, s, p) for c in chunks] == \
                [getattr(script, fn)(b, c, s, p) for c in chunks]
        port = ttrain.build_ict_arrays(
            _Enc(TTokenizer()), chunks, q_len=32, d_len=128, seed=3,
            syn=s, sub_p=p, log=lambda m: None)
        ref = script.build_ict_arrays(
            _Enc(Tokenizer()), chunks, q_len=32, d_len=128, seed=3, syn=s,
            sub_p=p, log=lambda m: None)
        for a, b in zip(port, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    assert ttrain.make_pairs(rng_a, 40) == script.make_pairs(rng_b, 40)
    assert (ttrain.TOPICS, ttrain.TEMPLATES_Q, ttrain.TEMPLATES_D) == \
        (script.TOPICS, script.TEMPLATES_Q, script.TEMPLATES_D)


# the tools' tests run MiniLM-L6 at hidden 96 (12 heads of 8): writing a
# compressed checkpoint of the full 384 takes about 20 s on this CPU
TOOL_CFG = dict(hidden=96)


def test_synthetic_mode_checkpoint_loads_in_jax(tmp_path, capsys):
    out = str(tmp_path / "synthetic.npz")
    ttrain.main(["--steps", "2", "--batch", "8", "--device", "cpu",
                 "--dim", "96", "--out", out])
    captured = capsys.readouterr()
    result = captured.out.strip().splitlines()[-1]
    assert result.startswith("RESULT acc_before=") and \
        result.endswith(f"ckpt={out}")
    assert "step 0: loss" in captured.err and "step 1: loss" in captured.err
    jcfg = jenc.checkpoint_config(out)
    tcfg = tenc.EncoderConfig(**TOOL_CFG, max_len=32)
    assert jcfg == jenc.EncoderConfig(**TOOL_CFG, max_len=32)
    jp = jenc.load_params(out, jcfg)
    tp = tenc.load_params(out, tcfg, device="cpu")
    ids = Tokenizer().encode_batch(QUERIES + DOCS, 32)
    ref = jenc.encode_tokens_jit(jp, jnp.asarray(ids), jcfg)
    port = tenc.encode_tokens(tp, torch.from_numpy(ids), tcfg)
    port, ref = port.numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(port).all()
    # bf16: the encoder tests' bf16 bounds
    assert np.abs(port - ref).max() <= 8e-3
    assert (port * ref).sum(axis=1).min() >= 0.9995


def test_ict_mode_trains_and_saves_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "ict.npz")
    args = ttrain.parse_args([
        "--corpus", _corpus(tmp_path), "--max-chunks", "120", "--steps",
        "4", "--batch", "8", "--q-len", "16", "--d-len", "64",
        "--steps-per-call", "2", "--hard-neg", "--device", "cpu",
        "--eval-n", "16", "--dim", "96", "--out", out])
    run = ttrain.train_ict(args)
    err = capsys.readouterr().err
    assert "step 2/4: loss" in err and "step 4/4: loss" in err
    assert run["losses"].shape == (4,) and np.isfinite(run["losses"]).all()
    summary = run["summary"]
    assert set(summary) == {"mode", "steps", "batch", "chunks", "eval_n",
                            "minilm", "hash", "ckpt", "train_s"}
    assert summary["eval_n"] == 12 and summary["ckpt"] == out
    cfg = jenc.checkpoint_config(out)
    assert cfg.max_len == 64
    # what was saved is what was trained
    saved = tenc._leaves(tenc.load_params(out, tenc.EncoderConfig(
        **TOOL_CFG, max_len=64), device="cpu"))
    for key, t in tenc._leaves(run["encoder"].params).items():
        assert torch.equal(saved[key], t.detach()), key


def test_default_device_is_the_card():
    assert ttrain.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ttrain.train_synthetic(ttrain.parse_args(["--steps", "1"]))
