"""Edge-case coverage: the unpacked counting fallback (vocab > 2^14),
unicode/control-byte round-trips, empty inputs, special tokens."""

import jax.numpy as jnp
import numpy as np
import pytest

from shredword_tpu import Tokenizer
from shredword_tpu.models.bpe import BPETrainer
from shredword_tpu.ops import bpe_ops


def test_unpacked_counting_matches_packed():
    """The 2-key sort path (used when ids >= 2^14 make packing
    impossible) must agree with the packed path."""
    rng = np.random.RandomState(3)
    n_words = 200
    lens = rng.randint(2, 10, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 111, len(word_id)).astype(np.int32)
    wcount = rng.randint(1, 40, n_words).astype(np.int32)[word_id]
    cap = 4096
    state = bpe_ops.make_state(tokens, word_id, wcount, cap)
    for minf in (1, 2, 10):
        a1, b1, c1 = bpe_ops.best_pair(state, jnp.int32(-1),
                                       jnp.int32(minf), packed=True)
        a2, b2, c2 = bpe_ops.best_pair(state, jnp.int32(-1),
                                       jnp.int32(minf), packed=False)
        assert (int(a1), int(b1), int(c1)) == (int(a2), int(b2), int(c2))


def test_unpacked_train_loop_matches_packed():
    rng = np.random.RandomState(11)
    n_words = 150
    lens = rng.randint(2, 9, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 105, len(word_id)).astype(np.int32)
    wcount = rng.randint(1, 30, n_words).astype(np.int32)[word_id]

    def run(packed):
        state = bpe_ops.make_state(tokens, word_id, wcount, 2048)
        ts = bpe_ops.train_init(state, 20)
        ts = bpe_ops.train_loop(ts, jnp.int32(-1), jnp.int32(2),
                                target_merges=20, max_steps=24,
                                packed=packed)
        n = int(ts.n_merges)
        return np.asarray(ts.merges)[:n]

    np.testing.assert_array_equal(run(True), run(False))


@pytest.fixture(scope="module")
def tok(tmp_path_factory, request):
    corpus = request.getfixturevalue("small_corpus_file")
    return Tokenizer.train(corpus, vocab_size=300, min_pair_freq=2,
                           backend="cpu")


def test_empty_and_whitespace(tok):
    assert tok.encode("") == []
    assert tok.decode([]) == ""
    s = "   \t\n  "
    assert tok.decode(tok.encode(s)) == s


def test_unicode_roundtrip(tok):
    s = "naïve café — ☃ 日本語 🙂 \x00\x01 mixed"
    assert tok.decode(tok.encode(s)) == s


def test_all_bytes_roundtrip(tok):
    ids = tok.encode_ordinary(bytes(range(256)).decode("latin-1"))
    # latin-1 text maps to multi-byte utf-8; decode_bytes must return
    # the exact utf-8 of the input
    raw = bytes(range(256)).decode("latin-1").encode("utf-8")
    assert tok.decode_bytes(ids) == raw


def test_special_tokens_roundtrip(tok):
    tok.register_special_tokens({"<|eos|>": 900, "<|pad|>": 901})
    ids = tok.encode("a<|eos|>b<|pad|>", allowed_special="all")
    assert 900 in ids and 901 in ids
    assert tok.decode(ids) == "a<|eos|>b<|pad|>"
    with pytest.raises(ValueError):
        tok.encode("x<|eos|>", allowed_special="none_raise")


def test_context_manager_and_multi_corpus(tmp_path):
    c1 = tmp_path / "a.txt"
    c2 = tmp_path / "b.txt"
    c1.write_text("alpha beta alpha beta\n" * 20)
    c2.write_text("beta gamma beta gamma\n" * 20)
    with BPETrainer(target_vocab_size=280, unk_id=-1, min_pair_freq=2,
                    backend="device") as t:
        t.load_corpora([str(c1), str(c2)])
        n = t.train()
        assert n > 0
        # both corpora contributed: tokens from each file's unique word
        vocab_bytes = b"|".join(
            __import__("shredword_tpu").serialization.token_strings(
                t.merges))
        assert b"alpha" in vocab_bytes or b"alph" in vocab_bytes
        assert b"gamma" in vocab_bytes or b"gamm" in vocab_bytes
    assert t._corpus is None  # context exit destroyed native state


def test_single_char_corpus(tmp_path):
    """Single-character corpora legitimately produce 0 merges
    (coverage floor keeps one char; no pairs within 1-byte words)."""
    p = tmp_path / "one.txt"
    p.write_text("a a a a a a\n" * 50)
    t = BPETrainer(target_vocab_size=300, unk_id=-1, min_pair_freq=2,
                   backend="device")
    t.load_corpus(str(p))
    assert t.train() == 0


def test_long_word_falls_back_to_flat_engine(tmp_path):
    p = tmp_path / "long.txt"
    p.write_text(("x" * 200 + " ") * 40 + "ab ab ab ab\n" * 30)
    t = BPETrainer(target_vocab_size=280, unk_id=-1, min_pair_freq=2,
                   backend="device", engine="auto")
    t.load_corpus(str(p))
    n = t.train()
    assert n > 0  # the 200-byte word forces the flat engine; still works

def test_threaded_encode_text_thread_invariance(tmp_path):
    """The threaded whole-text native encode must be bit-identical to
    the single-thread pass for any thread count and split position
    (ranges split only at whitespace-run boundaries)."""
    import numpy as np

    from shredword_tpu.runtime.native import NativeEncoder

    merges = np.array([[104, 101], [256, 108], [257, 108], [258, 111],
                       [32, 32], [260, 260]], np.int32)  # hello + ws runs
    enc = NativeEncoder(merges)
    texts = [
        b"hello world " * 200_000,            # memo-heavy, many runs
        b"ab" * 300_000,                      # single giant run, no ws
        b"   \t\n  " * 150_000,               # whitespace-only runs
        "héllo wörld ✓ ".encode() * 120_000,  # multi-byte utf-8
        b"",
        b"x",
    ]
    for data in texts:
        base = enc.encode_text(data, nthreads=1)
        for nt in (2, 3, 7):
            np.testing.assert_array_equal(
                base, enc.encode_text(data, nthreads=nt))
    enc.free()
