"""The generation cells on the CPU, on the smoke decoder
(``checkpoints/decoder_smoke.npz``): the prompt generator, the budget
rule, the plain reference against the decoder, a whole run, the fp8
control and runs whose timed path is broken underneath, which must not
come out correct, and a generation cell added by files alone."""

import json

import numpy as np
import pytest
import torch

from perfbench import compare, control, generate, harness, roofline
from perfbench.prompts import (BOS_ID, EOS_ID, SEP_ID, SPECIALS, Prompts,
                               answer_tokens)
from perfbench.reference_decoder import ReferenceDecoder
from perfbench.tests.conftest import REPO, SMOKE, TINY_PROMPTS, make_tiny
from perfbench.tests.test_perfbench_harness import last_line, run

CELL = "decoder_distill.rag1"
GEN_E2E = {"gen_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}
SPEC = dict(json.loads((REPO / "perfbench" / "traffic" / "rag1.json")
                       .read_text()), **TINY_PROMPTS)


def test_every_seed_gets_the_same_lengths_in_its_own_order():
    a, b = Prompts(SPEC, 347, 1), Prompts(SPEC, 347, 2)
    assert sorted(map(len, a.pool)) == sorted(map(len, b.pool))
    assert [len(a.prompt(i)) for i in range(8)] != \
        [len(b.prompt(i)) for i in range(8)]
    lengths = sorted(map(len, a.pool))
    assert lengths[0] == 48 and lengths[-1] == 144
    again = Prompts(SPEC, 347, 1)
    assert all((x == y).all() for x, y in zip(a.pool, again.pool))


def test_a_prompt_is_laid_out_as_the_decoders():
    p = Prompts(dict(SPEC, evidences=3), 347, 5)
    for ids in p.pool:
        assert ids[0] == BOS_ID and ids[-1] == SEP_ID
        seps = np.flatnonzero(ids == SEP_ID)
        assert len(seps) == 4 and 4 <= seps[0] - 1 <= 12
        # the passages split what the question leaves within one token
        parts = np.diff(seps) - 1
        assert parts.min() >= 1 and parts.max() - parts.min() <= 1
        body = np.delete(ids, np.r_[0, seps])
        assert (body >= SPECIALS).all() and (body < 347).all()


def served_directly(gen, prompt: np.ndarray, max_tokens: int) -> list[int]:
    """The greedy answer of ``decoder.prefill`` and ``decode_block`` with
    the generator's bias (EOS banned), block by block, for ``prompt``."""
    from rag_foundation_tpu_torch.models import decoder
    cfg = gen.cfg
    bias = gen.vocab_bias(prompt.tolist())
    padded = np.zeros((1, cfg.prefix_len), np.int64)
    padded[0, :len(prompt)] = prompt
    with torch.inference_mode():
        cache, logits = decoder.prefill(
            gen.params, torch.as_tensor(padded),
            torch.tensor([len(prompt)]), cfg)
        out = [int(np.argmax(logits.numpy()[0] + bias))]
        tok, pos = torch.tensor(out), len(prompt)
        budget = answer_tokens(len(prompt), max_tokens, cfg.ans_len,
                               cfg.max_len, gen.block)
        while len(out) < budget:
            ids, cache, pos = decoder.decode_block(
                gen.params, cache, tok, pos, cfg=cfg, k_steps=gen.block,
                bias=torch.as_tensor(bias))
            out += ids[0].tolist()[: budget - len(out)]
            tok = ids[:, -1]
    return out


def test_the_adapter_serves_the_generators_own_answers():
    """The adapter's hooks (its tokenizer, the prefill's logits kept, EOS
    banned) change nothing of the ids; each answer has the tokens
    ``answer_tokens`` gives, over the whole range of prompt lengths."""
    cfg = json.loads((REPO / "perfbench" / "configs" /
                      "decoder_distill.json").read_text())
    with np.load(REPO / SMOKE) as z:
        cfg.update({k[6:]: int(z[k]) for k in z if k.startswith("__cfg_")})
    cfg.update(checkpoint=SMOKE, gen_block=16)
    system = harness.load_module(REPO / "perfbench" / "systems" /
                                 "decoder.py")
    model = system.load(cfg, REPO, torch.device("cpu"))
    prompts = Prompts(dict(SPEC, pool=8), cfg["vocab_size"], 3)
    feed = generate.Feed(prompts, cfg, float("inf"), cap=8)
    model.serve(feed)
    budgets = {r.budget for r in feed.handed}
    assert len(feed.handed) == 8 and len(budgets) > 1
    for r in feed.handed:
        assert len(r.out) == r.budget and EOS_ID not in r.out
        assert r.out.tolist() == served_directly(model.gen, r.ids,
                                                 r.max_tokens)
        assert [n for _, n in r.marks] == sorted({n for _, n in r.marks})
        assert r.marks[0][1] == 1 and r.marks[-1][1] == r.budget


def test_the_reference_follows_the_decoder_in_float32():
    from rag_foundation_tpu_torch.models import decoder
    params, cfg, _ = decoder.load_decoder(str(REPO / SMOKE), "cpu")
    f32 = cfg._replace(dtype="float32")

    def widen(t):
        if isinstance(t, dict):
            return {k: widen(v) for k, v in t.items()}
        if isinstance(t, list):
            return [widen(v) for v in t]
        return t.float()
    ids = Prompts(SPEC, cfg.vocab_size, 4).pool[-1]
    mine = decoder.forward(widen(params), torch.as_tensor(ids)[None], f32)[0]
    ref = ReferenceDecoder(str(REPO / SMOKE), "cpu").logits(ids)
    assert torch.allclose(ref, mine, atol=1e-4, rtol=1e-4)


def test_the_allowed_tokens_are_the_generators_bias():
    from rag_foundation_tpu_torch.models.decoder import TextGenerator
    gen = TextGenerator(str(REPO / SMOKE), device="cpu")
    ref = ReferenceDecoder(str(REPO / SMOKE), "cpu")
    for ids in Prompts(SPEC, 347, 6).pool[:4]:
        want = torch.as_tensor(gen.vocab_bias(ids.tolist()) == 0)
        want[EOS_ID] = False
        assert torch.equal(ref.allowed(ids, True), want)


def test_prefix_lm_flops_counts_each_position_once():
    cfg = {"hidden": 8, "ffn": 32, "layers": 3, "vocab_size": 100}
    brute = 0
    for p in range(5 + 4 - 1):
        brute += 3 * (2 * 8 * (3 * 8 + 8 + 2 * 32) + 4 * 8 * (p + 1))
    brute += 4 * 2 * 8 * 100
    assert roofline.prefix_lm_flops(cfg, 5, 4) == brute


def test_served_rates_count_all_work_over_all_time():
    reqs = []
    for handed, first, last, done, n in [
            (0.0, 0.1, 1.0, 1.0, 10), (1.0, 1.2, 1.9, 2.0, 8),
            (2.0, 2.1, 3.5, 3.5, 8)]:
        r = generate.Request(np.zeros(4, np.int64), 8, n)
        r.handed, r.done, r.out = handed, done, np.zeros(n, np.int64)
        r.marks = [(first, 1), (last, n)]
        reqs.append(r)
    got = generate.served_rates(reqs, 0.0, 3.0, lambda p, n: 1.0)
    assert got["gen_tok_s"] == 18 / 3.0
    assert got["ttft_p95_ms"] == pytest.approx(
        np.percentile([100.0, 200.0], 95))
    assert got["tpot_p95_ms"] == pytest.approx(
        np.percentile([900.0 / 9, 700.0 / 7], 95))
    assert got["model_flops"] == 2.0 and got["window_s"] == 3.0


def test_a_generation_cell_runs_end_to_end(tiny_root):
    proc = run(tiny_root, "--workload", CELL, "--seed", "2147483777",
               "--seconds", "2", "--trace", "0")
    out = last_line(proc)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == GEN_E2E
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks" and set(out["checks"]) == {
        "logit_gap", "token_deficit", "malformed_requests"}
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {name}" for name in out["checks"]]


def test_a_traced_generation_run(tiny_root):
    out = last_line(run(tiny_root, "--workload", CELL, "--seed", "8",
                        "--seconds", "3", "--trace", "1"))
    assert out["correct"] is True
    # the CPU has no device trace: the idle share reads none
    assert set(out["metrics"]) == {"gen.mfu"}
    assert 0 < out["metrics"]["gen.mfu"]["value"] < 100
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def one_run(root, seed=2147483659):
    args = harness.parse(["--workload", CELL, "--seed", str(seed),
                          "--seconds", "1", "--device", "cpu"])
    return harness.run(args, root, 0.0)


def failed_checks(out):
    return [n for n, c in out["checks"].items()
            if c["value"] == "inf" or c["value"] > c["limit"]]


def test_sound_runs_pass(tiny_root):
    assert one_run(tiny_root)["correct"] is True


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_fp8_control_fails(tiny_root, seed):
    args = harness.parse(["--workload", CELL, "--seed", "1", "--seconds",
                          "1", "--device", "cpu"])
    numbers = control.generation_control(args, tiny_root, seed)
    cfg = harness.load_cell(tiny_root, CELL).cfg
    correct, checks = compare.judge(numbers, cfg["limits"])
    assert not correct
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def altered_token(monkeypatch):
    """Each decode block hands back its third token changed."""
    from rag_foundation_tpu_torch.models import decoder
    real = decoder.decode_block

    def altered(*a, **kw):
        ids, cache, pos = real(*a, **kw)
        ids = ids.clone()
        ids[:, 2] = (ids[:, 2] + 1) % 347
        return ids, cache, pos
    monkeypatch.setattr(decoder, "decode_block", altered)


def state_unchanged(monkeypatch):
    """A decode step attends over the cache but leaves it as it was: the
    answer's own keys and values are never kept."""
    from rag_foundation_tpu_torch.models import decoder
    real = decoder._decode_one

    def stale(params, cache, tok, pos, cfg):
        logits, _ = real(params, {k: v.clone() for k, v in cache.items()},
                         tok, pos, cfg)
        return logits, cache
    monkeypatch.setattr(decoder, "_decode_one", stale)


def half_prompt_left_out(monkeypatch):
    """The prefill reads the first half of the prompt only."""
    from rag_foundation_tpu_torch.models import decoder
    real = decoder.prefill

    def half(params, ids, length, cfg):
        half_len = length // 2
        keep = torch.arange(ids.shape[1])[None] < half_len[:, None]
        return real(params, torch.where(keep, ids, 0), half_len, cfg)
    monkeypatch.setattr(decoder, "prefill", half)


def out_of_vocabulary(monkeypatch):
    """The first token of each decode block is an id past the
    vocabulary."""
    from rag_foundation_tpu_torch.models import decoder
    real = decoder.decode_block

    def past(*a, **kw):
        ids, cache, pos = real(*a, **kw)
        ids = ids.clone()
        ids[:, 0] = 10_000
        return ids, cache, pos
    monkeypatch.setattr(decoder, "decode_block", past)


@pytest.mark.parametrize("fault,caught", [
    (altered_token, "token_deficit"),
    (state_unchanged, "token_deficit"),
    (half_prompt_left_out, "logit_gap"),
    (out_of_vocabulary, "malformed_requests"),
])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault,
                                      caught):
    fault(monkeypatch)
    out = one_run(tiny_root)
    assert out["correct"] is False
    assert caught in failed_checks(out)
    if caught == "malformed_requests":
        assert out["failed"] == out["attempted"] > 0


BATCHED = '''"""A test's batched model: up to ``feed.concurrency`` requests at once,
each step one full forward of the decoder over every slot's sequence
(right-padded), a slot refilled from the feed as its answer ends."""

import torch

from rag_foundation_tpu_torch.models import decoder

SPECIALS = 5


class Served:
    def __init__(self, cfg, root, device):
        self.params, self.cfg, _ = decoder.load_decoder(
            str(root / cfg["checkpoint"]), device)
        self.widths = self.cfg._asdict()
        self.batches = []

    def serve(self, feed):
        slots = []
        while True:
            while len(slots) < feed.concurrency:
                req = feed.take()
                if req is None:
                    break
                slots.append((req, req.ids.tolist(), []))
            if not slots:
                return
            self.batches.append(len(slots))
            seqs = [ids + out for _, ids, out in slots]
            n = max(map(len, seqs))
            x = torch.zeros((len(seqs), n), dtype=torch.int64)
            for i, s in enumerate(seqs):
                x[i, :len(s)] = torch.as_tensor(s)
            with torch.inference_mode():
                logits = decoder.forward(self.params, x, self.cfg)
            last = logits[torch.arange(len(seqs)),
                          torch.as_tensor([len(s) - 1 for s in seqs])]
            choice = last.clone()
            choice[:, :SPECIALS] = float("-inf")
            for (req, ids, out), row, tok in zip(slots, last,
                                                 choice.argmax(dim=1)):
                if not out:
                    req.logits = row.clone()
                out.append(int(tok))
                req.emit(len(out))
            for s in [s for s in slots if len(s[2]) == s[0].budget]:
                feed.finish(s[0], s[2], s[0].logits)
                slots.remove(s)

    def free(self):
        assert max(self.batches) == 4
        del self.params


def load(cfg, root, device):
    return Served(cfg, root, device)
'''

FLOPS = '''def flops(cfg, prompt_len, new_tokens):
    # one full forward of every sequence a step: the count of a test
    return float(cfg["hidden"] * (prompt_len + new_tokens))
'''


def test_a_generation_cell_added_by_files_alone(tmp_path):
    """A batched model at concurrency 4 with its own adapter, traffic,
    operation count and reader: no harness code changes."""
    root = make_tiny(tmp_path)
    data = root / "perfbench"
    cfg = json.loads((data / "configs" / "decoder_distill.json").read_text())
    cfg.update(name="batched", mode="batched_test", constrained=False,
               flops="batched_test")
    (data / "configs" / "batched.json").write_text(json.dumps(cfg))
    (data / "systems" / "batched_test.py").write_text(BATCHED)
    (data / "flops").mkdir()
    (data / "flops" / "batched_test.py").write_text(FLOPS)
    spec = json.loads((data / "traffic" / "rag1.json").read_text())
    (data / "traffic" / "four.json").write_text(json.dumps(
        dict(spec, concurrency=4, pool=32)))
    (data / "metrics" / "gen.window_s.py").write_text(
        'UNIT = "s"\n\n\ndef read(ctx):\n    return ctx.window["window_s"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "batched", "source": "a test",
                             "file": "perfbench/configs/batched.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "batched.four", "config": "batched",
                               "traffic": "four", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "gen.window_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "model", "moves": "gen_tok_s",
        "workloads": ["batched.four"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("batched.four")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = last_line(run(root, "--workload", "batched.four", "--seed", "9",
                        "--seconds", "2", "--trace", "0"))
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == GEN_E2E
    out = last_line(run(root, "--workload", "batched.four", "--seed", "9",
                        "--seconds", "2", "--trace", "1"))
    assert out["correct"] is True
    assert {"gen.window_s", "gen.mfu"} <= set(out["metrics"])
