"""The port's decoder tokenizer against the JAX package's: the same
vocabulary from the same corpus, the same ids, prompts and decoded text,
bit for bit, and one JSON vocabulary format both ways."""

import json
from pathlib import Path

import numpy as np
import pytest

from rag_foundation_tpu.models import gen_tokenizer as jgt
from rag_foundation_tpu_torch.models import gen_tokenizer as tgt

ROOT = Path(__file__).resolve().parents[1]
CORPUS = [
    "The mount slews at 4.5 degrees per second, under nominal load.",
    "Quarterly revenue grew 12% driven by cloud subscriptions.",
    "Operators check the cooling panel every 30 minutes.",
    "A telemetry fault raises an alert within 5 seconds.",
    "The v5e-8 slice holds 3,000 vectors; see (appendix) [b].",
] * 3
TEXTS = CORPUS[:5] + [
    "Project Kalomi's codename is ZEBRA42 -- budget: 913k (year-over-year).",
    "Ünïcödé naïve café — résumé, 日本語 and текст",
    "8.4 3,000 v5e-8 1.2.3 a-b-c x,y ... !? ''",
    "supercalifragilisticexpialidocious " * 3,
    "",
    "   \t\n  ",
]


@pytest.fixture(scope="module")
def vocabs():
    return (jgt.train_gen_vocab(CORPUS, 400),
            tgt.train_gen_vocab(CORPUS, 400))


def test_constants_equal():
    assert (tgt.PAD_ID, tgt.BOS_ID, tgt.SEP_ID, tgt.EOS_ID, tgt.UNK_ID) == (
        jgt.PAD_ID, jgt.BOS_ID, jgt.SEP_ID, jgt.EOS_ID, jgt.UNK_ID)
    assert tgt.WORD_RE.pattern == jgt.WORD_RE.pattern
    assert tgt._SPECIALS == jgt._SPECIALS


@pytest.mark.parametrize("size,min_pair", [(400, 2), (120, 2), (400, 1)])
def test_train_gen_vocab_equal(size, min_pair):
    assert tgt.train_gen_vocab(CORPUS, size, min_pair_count=min_pair) == \
        jgt.train_gen_vocab(CORPUS, size, min_pair_count=min_pair)


# prose with many ties among pair counts and runs of one letter (a pair
# of a piece with itself, merged left to right)
DOCS = [p.read_text() for p in sorted(
    (ROOT / "benchmarks" / "quality" / "docs").glob("*.md"))] + [
    "zzzz zzzzz zzzzzz mmmmmmm aaa aaaa baaab " * 4, "ssss sss ss s " * 3]


@pytest.mark.parametrize("size,min_pair", [(300, 2), (1200, 2), (5000, 2),
                                           (2000, 1)])
def test_train_gen_vocab_equal_merge_for_merge_on_prose(size, min_pair):
    """The port's incremental trainer against the JAX package's recount
    of every pair: the same pieces with the same ids, in the same order,
    up to where the merges run out (``min_pair_count``)."""
    want = jgt.train_gen_vocab(DOCS, size, min_pair_count=min_pair)
    got = tgt.train_gen_vocab(DOCS, size, min_pair_count=min_pair)
    assert list(got.items()) == list(want.items())
    if size == 300:
        assert len(got) == size           # it fills
    if size == 5000:
        assert len(got) < size            # it runs out of pairs


@pytest.mark.parametrize("text", TEXTS)
def test_ids_and_decode_bit_identical(vocabs, text):
    j, t = (jgt.GenTokenizer(vocabs[0]), tgt.GenTokenizer(vocabs[1]))
    ids = t.encode_text(text)
    assert ids == j.encode_text(text)
    assert t.decode(ids) == j.decode(ids)
    # specials, EOS cut-off, out-of-range ids and a numpy array decode alike
    mixed = np.array([tgt.BOS_ID] + ids + [tgt.SEP_ID, 10_000, -1,
                                           tgt.EOS_ID] + ids)
    assert t.decode(mixed) == j.decode(mixed)


@pytest.mark.parametrize("max_len", [16, 48, 64, 416])
@pytest.mark.parametrize("n_ev", [0, 1, 3, 9])
def test_encode_prompt_layout_and_truncation(vocabs, max_len, n_ev):
    j, t = (jgt.GenTokenizer(vocabs[0]), tgt.GenTokenizer(vocabs[1]))
    long_ev = " ".join(CORPUS)
    evs = [long_ev if i % 2 else TEXTS[i % len(TEXTS)] for i in range(n_ev)]
    q = "How fast does the mount slew, at 4.5 degrees or more?"
    got = t.encode_prompt(q, evs, max_len)
    assert got == j.encode_prompt(q, evs, max_len)
    assert got[0] == tgt.BOS_ID and len(got) <= max_len


def test_json_round_trips_both_ways(vocabs):
    j, t = (jgt.GenTokenizer(vocabs[0]), tgt.GenTokenizer(vocabs[1]))
    assert t.to_json() == j.to_json()
    assert tgt.GenTokenizer.from_json(j.to_json()).vocab == j.vocab
    assert jgt.GenTokenizer.from_json(t.to_json()).vocab == t.vocab


def test_checkpoint_vocab_loads_alike():
    """The vocabulary embedded in the full-width checkpoint."""
    with np.load(ROOT / "checkpoints" / "decoder_distill.npz") as z:
        raw = bytes(z["__vocab_json"]).decode()
    j, t = jgt.GenTokenizer.from_json(raw), tgt.GenTokenizer.from_json(raw)
    assert t.vocab == j.vocab and t.vocab_size == j.vocab_size == 8192
    assert json.loads(t.to_json()) == json.loads(raw)
    assert tgt.GenTokenizer.from_json(j.to_json()).vocab == j.vocab
    for text in TEXTS:
        ids = t.encode_text(text)
        assert ids == j.encode_text(text)
        assert t.decode(ids) == j.decode(ids)
    assert t._id2piece == j._id2piece
