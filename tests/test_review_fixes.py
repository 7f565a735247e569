"""Regression tests for defects found in review: max-length-word
backward pass, prune termination, marker-prefixed seeding, v1 format
robustness, encode error types, special-id collisions, lossy convert."""

import numpy as np
import pytest

from shredword_tpu import Tokenizer, serialization
from shredword_tpu.errors import EncodeError, SerializationError
from shredword_tpu.models.unigram import UnigramTokenizer, UnigramTrainer
from shredword_tpu.ops import unigram_ops
from shredword_tpu.runtime import native


def test_forward_backward_word_of_length_L():
    """Words of exactly max_word_len length: the device backward pass
    must seed beta[L] = 0 (regression: counts were mostly zero)."""
    words = [b"abcd"]
    L, K = 4, 2
    pieces = [b"a", b"b", b"c", b"d", b"ab", b"cd"]
    logp = np.log(np.ones(len(pieces)) / len(pieces))
    table = native.piece_table(words, pieces, L, K)
    wlen = np.array([4], np.int32)
    wc = np.ones(1, np.float32)
    c_dev, ll_dev = unigram_ops.forward_backward(
        table, wlen, wc, logp, len(pieces), backend="device")
    c_cpu, ll_cpu = unigram_ops.forward_backward(
        table, wlen, wc, logp, len(pieces), backend="cpu")
    assert c_cpu.sum() > 0.5  # the lattice is segmentable
    np.testing.assert_allclose(c_dev, c_cpu, rtol=1e-4, atol=1e-5)
    assert abs(ll_dev - ll_cpu) < 1e-4


def test_unigram_prune_terminates_below_required(tmp_path):
    """target below the number of required single bytes must stop with
    a warning, not loop forever."""
    p = tmp_path / "c.txt"
    p.write_text("abcdefghij klmnopqrst uvwxyz0123 456789\n" * 20)
    t = UnigramTrainer(target_vocab_size=10, seed_size=100,
                       max_word_len=16, num_em_rounds=1, backend="cpu")
    t.load_corpus(str(p))
    n = t.train()       # must return (not hang); keeps required singles
    assert n >= 10


def test_seed_includes_marker_prefixed_pieces(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("hello hello hello world world\n" * 10)
    t = UnigramTrainer(target_vocab_size=60, seed_size=500,
                       max_word_len=16, num_em_rounds=1, backend="cpu")
    t.load_corpus(str(p))
    t.train()
    marker = "▁".encode()
    assert any(pc.startswith(marker) and len(pc) > 3 for pc in t.pieces), \
        "no marker-prefixed word pieces were learned"


def test_unigram_encode_oov_raises_encode_error(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("abc abc abc\n" * 10)
    t = UnigramTrainer(target_vocab_size=20, seed_size=100,
                       max_word_len=8, max_piece_len=8,
                       num_em_rounds=1, backend="cpu")
    t.load_corpus(str(p))
    t.train()
    tok = UnigramTokenizer(t.pieces, t.log_probs)
    with pytest.raises(EncodeError):
        tok.encode("café")


def test_v1_specials_with_spaces_roundtrip(tmp_path):
    merges = np.array([[97, 98]], np.int32)
    p = str(tmp_path / "m.v1.model")
    serialization.write_model_v1(p, merges,
                                 special_tokens={"<|my tok|>": 300})
    m, pat, special = serialization.read_model_v1(p)
    assert special == {"<|my tok|>": 300}
    with pytest.raises(SerializationError):
        serialization.write_model_v1(p, merges,
                                     special_tokens={"bad\ntok": 300})
    with pytest.raises(SerializationError):
        serialization.write_model_v1(p, merges, pattern="a\nb")


def test_convert_refuses_lossy(tmp_path):
    src = str(tmp_path / "m.v1.model")
    serialization.write_model_v1(src, np.array([[97, 98]], np.int32),
                                 pattern="gpt",
                                 special_tokens={"<eos>": 300})
    with pytest.raises(SerializationError):
        serialization.convert(src, str(tmp_path / "m.model"))
    # lossless direction still works
    serialization.convert(src, str(tmp_path / "m2.v1.model"))


def test_special_id_collision_rejected_at_load(tmp_path):
    p = str(tmp_path / "m.v1.model")
    serialization.write_model_v1(p, np.array([[97, 98]], np.int32),
                                 special_tokens={"<unk>": 200})
    with pytest.raises(EncodeError):
        Tokenizer.load(p)


def test_build_vocab_matches_tokenizer_vocab(tmp_path, request):
    corpus = request.getfixturevalue("small_corpus_file")
    from shredword_tpu import build_vocab
    tok = Tokenizer.train(corpus, vocab_size=300, min_pair_freq=2,
                          backend="cpu")
    assert tok.vocab == build_vocab(tok.merges, tok.special_tokens)
