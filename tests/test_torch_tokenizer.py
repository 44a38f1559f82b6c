"""The port's tokenizer against the JAX package's: the same ids, bit for
bit, with the hashed vocabulary and with a trained WordPiece vocab."""

import numpy as np
import pytest

from rag_foundation_tpu.models import tokenizer as jtok
from rag_foundation_tpu.models.vocab import train_wordpiece as jax_train
from rag_foundation_tpu_torch.models import tokenizer as ttok
from rag_foundation_tpu_torch.models.vocab import (tokenize_wordpiece,
                                                   train_wordpiece)

TEXTS = [
    "Hello, TPU world!",
    "The codename for project Kalomi is ZEBRA42; its budget: 913k.",
    "revenue grew 12% (year-over-year) -- see §4.2 & appendix [b]...",
    "a" * 100 + " " + "supercalifragilisticexpialidocious antidisestablish",
    "running jumped quickly teachers nationalisation movements",
    "Ünïcödé naïve café — résumé",
    "日本語のテキストと English mixed 中文 текст на русском",
    "",
    "   \t\n  ",
    "x",
]


def test_constants_equal():
    assert ttok.TOKENIZER_VERSION == jtok.TOKENIZER_VERSION == 2
    assert (ttok.PAD_ID, ttok.CLS_ID, ttok.SEP_ID) == (
        jtok.PAD_ID, jtok.CLS_ID, jtok.SEP_ID)


@pytest.mark.parametrize("vocab_size,max_len", [(30_522, 128), (512, 16),
                                                (1000, 512)])
def test_hashed_ids_bit_identical(vocab_size, max_len):
    a = jtok.Tokenizer(vocab_size=vocab_size).encode_batch(TEXTS, max_len)
    b = ttok.Tokenizer(vocab_size=vocab_size).encode_batch(TEXTS, max_len)
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_wordpiece_vocab_ids_bit_identical():
    corpus = [f"the {w}s of project {w} were {w}ing steadily"
              for w in ("build", "test", "deploy", "measure", "port")] * 3
    vocab = train_wordpiece(corpus, vocab_size=120)
    assert vocab == jax_train(corpus, vocab_size=120)
    texts = TEXTS + corpus[:5] + ["unseen words like zyxwv still hash"]
    a = jtok.Tokenizer(vocab_size=512, vocab=vocab).encode_batch(texts, 64)
    b = ttok.Tokenizer(vocab_size=512, vocab=vocab).encode_batch(texts, 64)
    np.testing.assert_array_equal(a, b)
    assert tokenize_wordpiece("zyxwv", vocab) is None


def test_vocab_past_the_table_raises():
    with pytest.raises(ValueError, match="embedding table"):
        ttok.Tokenizer(vocab_size=4, vocab={"[PAD]": 0, "big": 9})
