"""Unigram subsystem tests: normalizer parity, seed enumeration,
lattice forward-backward vs a transparent numpy oracle, EM training,
Viterbi round-trip."""

import math

import numpy as np
import pytest

from shredword_tpu.models.unigram import (UnigramTokenizer, UnigramTrainer,
                                          _prep_words)
from shredword_tpu.ops import unigram_ops
from shredword_tpu.runtime import native

MARKER = "▁".encode()


# ---------------------------------------------------------------------
# normalizer (reference normalize_line semantics, normalize.cpp:24-59)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("raw,expected", [
    (b"Hello World", "hello▁world".encode()),
    (b"  leading", b"leading"),
    (b"trailing   ", b"trailing"),
    (b"A\tB\r C", "a▁b▁c".encode()),
    (b"", b""),
    (b"   ", b""),
    (b"MiXeD CaSe", "mixed▁case".encode()),
])
def test_normalize_line_semantics(raw, expected):
    assert native.normalize(raw) == expected


def test_normalize_multiline():
    out = native.normalize(b"One Two\nThree  Four\n")
    assert out == "one▁two\nthree▁four\n".encode()


def test_normalize_parity_with_reference_binary(tmp_path):
    """Byte-compare against the compiled reference normalize_line."""
    import ctypes
    import os
    import subprocess
    src = "/root/reference/shredword/csrc/bpe/normalize.cpp"
    if not os.path.exists(src):
        pytest.skip("reference tree unavailable")
    so = tmp_path / "refnorm.so"
    r = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(so), src,
         "-I", os.path.dirname(src)], capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"reference normalize build failed: {r.stderr[:200]}")
    ref = ctypes.CDLL(str(so))
    ref.normalize_line.restype = ctypes.c_int
    cases = [b"Hello  World", b"  A B  ", b"\tTabs\tHere\t", b"x",
             b"CAPS lower 123 !@#", b"", b" ", b"a  b   c    d"]
    for raw in cases:
        buf = ctypes.create_string_buffer(4 * len(raw) + 16)
        n = ref.normalize_line(raw, buf, len(buf))
        assert native.normalize(raw) == buf.raw[:n]


# ---------------------------------------------------------------------
# seed vocabulary (reference add_subwords semantics)
# ---------------------------------------------------------------------

def test_seed_vocab_matches_bruteforce():
    line = native.normalize(b"abab  cd Abab")
    sv = native.SeedVocab()
    sv.add(line, max_len=15)
    pieces, counts = sv.export(10_000)
    got = dict(zip(pieces, counts.tolist()))
    # brute force with the reference's rules: skip positions that START
    # with the marker, substrings may span markers, lengths 1..15
    exp: dict[bytes, int] = {}
    i = 0
    while i < len(line):
        if line[i:i + 3] == MARKER:
            i += 3
            continue
        for l in range(1, min(15, len(line) - i) + 1):
            s = line[i:i + l]
            exp[s] = exp.get(s, 0) + 1
        i += 1
    assert got == exp


def test_seed_vocab_weight_extension():
    sv = native.SeedVocab()
    sv.add(b"ab", weight=3)
    pieces, counts = sv.export(10)
    assert dict(zip(pieces, counts.tolist())) == {b"a": 3, b"b": 3, b"ab": 3}


# ---------------------------------------------------------------------
# lattice forward-backward vs numpy oracle
# ---------------------------------------------------------------------

def _numpy_fb(words, wcounts, pieces, logp, L, K):
    index = {p: i for i, p in enumerate(pieces)}
    counts = np.zeros(len(pieces))
    ll = 0.0
    for w, wc in zip(words, wcounts):
        n = len(w)
        alpha = np.full(n + 1, -np.inf)
        alpha[0] = 0.0
        for j in range(1, n + 1):
            terms = []
            for l in range(1, min(K, j) + 1):
                pid = index.get(w[j - l:j])
                if pid is not None and np.isfinite(alpha[j - l]):
                    terms.append(alpha[j - l] + logp[pid])
            if terms:
                m = max(terms)
                alpha[j] = m + math.log(sum(math.exp(t - m) for t in terms))
        beta = np.full(n + 1, -np.inf)
        beta[n] = 0.0
        for j in range(n - 1, -1, -1):
            terms = []
            for l in range(1, min(K, n - j) + 1):
                pid = index.get(w[j:j + l])
                if pid is not None and np.isfinite(beta[j + l]):
                    terms.append(logp[pid] + beta[j + l])
            if terms:
                m = max(terms)
                beta[j] = m + math.log(sum(math.exp(t - m) for t in terms))
        if not np.isfinite(alpha[n]):
            continue
        ll += wc * alpha[n]
        for j in range(n):
            for l in range(1, min(K, n - j) + 1):
                pid = index.get(w[j:j + l])
                if pid is not None:
                    counts[pid] += wc * math.exp(
                        alpha[j] + logp[pid] + beta[j + l] - alpha[n])
    return counts, ll


def test_forward_backward_matches_numpy():
    words = [b"abc", b"ab", b"aabb", b"b"]
    wcounts = np.array([2, 5, 1, 7], np.float32)
    pieces = [b"a", b"b", b"c", b"ab", b"bc", b"aab"]
    logp = np.log(np.array([.3, .3, .1, .15, .1, .05]))
    L, K = 6, 3
    table = native.piece_table(words, pieces, L, K)
    wlen = np.array([len(w) for w in words], np.int32)
    counts, ll = unigram_ops.forward_backward(
        table, wlen, wcounts, logp, len(pieces))
    exp_counts, exp_ll = _numpy_fb(words, wcounts, pieces, logp, L, K)
    np.testing.assert_allclose(counts, exp_counts, rtol=1e-4, atol=1e-4)
    assert abs(ll - exp_ll) < 1e-3


def test_forward_backward_numpy_fallback_matches_device():
    words = [b"abc", b"ab", b"aabb", b"b", b"zq"]
    wcounts = np.array([2, 5, 1, 7, 4], np.float32)
    pieces = [b"a", b"b", b"c", b"ab", b"bc", b"aab", b"z", b"q"]
    logp = np.log(np.ones(len(pieces)) / len(pieces))
    L, K = 6, 3
    table = native.piece_table(words, pieces, L, K)
    wlen = np.array([len(w) for w in words], np.int32)
    c_dev, ll_dev = unigram_ops.forward_backward(
        table, wlen, wcounts, logp, len(pieces), backend="device")
    c_cpu, ll_cpu = unigram_ops.forward_backward(
        table, wlen, wcounts, logp, len(pieces), backend="cpu")
    np.testing.assert_allclose(c_cpu, c_dev, rtol=1e-4, atol=1e-4)
    assert abs(ll_cpu - ll_dev) < 1e-3


def test_viterbi_matches_bruteforce():
    words = [b"abc", b"aab", b"bb"]
    pieces = [b"a", b"b", b"c", b"ab", b"bc"]
    logp = np.log(np.array([.2, .2, .1, .3, .2]))
    L, K = 4, 2
    table = native.piece_table(words, pieces, L, K)
    wlen = np.array([len(w) for w in words], np.int32)
    paths = unigram_ops.viterbi(table, wlen, logp)
    index = {p: i for i, p in enumerate(pieces)}

    def brute(w):
        best = (-np.inf, None)
        def rec(j, acc, score):
            nonlocal best
            if j == len(w):
                if score > best[0]:
                    best = (score, acc)
                return
            for l in range(1, min(K, len(w) - j) + 1):
                pid = index.get(w[j:j + l])
                if pid is not None:
                    rec(j + l, acc + [pid], score + logp[pid])
        rec(0, [], 0.0)
        return best

    for w, path in zip(words, paths):
        score, exp_path = brute(w)
        got_score = sum(logp[i] for i in path)
        assert abs(got_score - score) < 1e-6
        assert b"".join(pieces[i] for i in path) == w


# ---------------------------------------------------------------------
# end-to-end training
# ---------------------------------------------------------------------

def test_unigram_end_to_end(tmp_path):
    corpus = tmp_path / "c.txt"
    text = ("the cat sat on the mat " * 30 + "\n" +
            "a cat and a hat " * 30 + "\n") * 3
    corpus.write_text(text)
    t = UnigramTrainer(target_vocab_size=40, seed_size=500,
                       max_word_len=16, num_em_rounds=2)
    t.load_corpus(str(corpus))
    n = t.train()
    assert n <= 40
    assert all(len(p) == 1 for p in t.pieces if len(p) == 1)  # singles kept
    model = tmp_path / "u.model"
    t.save(str(model))
    tok = UnigramTokenizer.load(str(model))
    ids = tok.encode("the cat sat")
    assert tok.decode(ids) == "the cat sat"
    # marker-prefixed words segment fully
    assert all(isinstance(i, int) and 0 <= i < n for i in ids)


def test_prep_words_dedup():
    words, counts = _prep_words(b"aa bb aa\ncc bb", 16)
    d = dict(zip(words, counts.tolist()))
    assert d == {MARKER + b"aa": 2, MARKER + b"bb": 2, MARKER + b"cc": 1}


def test_unigram_10mb_scale(tmp_path):
    """VERDICT item 7 'done' bar: a >= 10 MB corpus trains with the
    slab-bounded E-step (the [W, L, K] piece table never materializes
    whole), loss-delta pruning reaches the target, and the tokenizer's
    batched device Viterbi matches the host DP."""
    from golden.bigcorpus_gen import make_big_corpus

    path = str(tmp_path / "corpus10m.txt")
    make_big_corpus(path, 10)
    tr = UnigramTrainer(target_vocab_size=4000, seed_size=12000,
                        max_piece_len=8, max_word_len=16,
                        num_em_rounds=1)
    tr.load_corpus(path)
    assert len(tr._words) > 50_000          # genuinely at scale
    n = tr.train()
    assert 256 <= n <= 12000

    mp = str(tmp_path / "u10.model")
    tr.save(mp)
    tok = UnigramTokenizer.load(mp)
    sample = "the quick brown fox jumps over the lazy dog"
    ids = tok.encode(sample)
    assert ids and tok.decode(ids) == sample
    # batched device Viterbi == per-word host DP
    words = list(tok._memo)[:50]
    for w in words:
        assert tok._memo[w] == tok.encode_word(w), w


# ---------------------------------------------------------------------
# mesh-sharded EM (parallel/unigram.py)
# ---------------------------------------------------------------------

def test_sharded_fb_matches_single_device():
    """psum-reduced sharded forward-backward == single-device FB on the
    same slab (word sharding partitions the sum exactly; float32 psum
    vs the single-device scatter may differ only in add order)."""
    from shredword_tpu import parallel
    from shredword_tpu.parallel import unigram as par_uni

    words = [MARKER + w for w in
             (b"abab", b"bcb", b"aabb", b"c", b"abc", b"ccc", b"ba")]
    pieces = sorted({w[i:j] for w in words
                     for i in range(len(w))
                     for j in range(i + 1, min(i + 4, len(w)) + 1)})
    L, K = 8, 4
    table = native.piece_table(words, pieces, L, K)
    wlen = np.asarray([len(w) for w in words], np.int32)
    wcount = np.asarray([3, 1, 2, 5, 1, 1, 2], np.float32)
    logp = np.log(np.full(len(pieces), 1.0 / len(pieces)))

    dt = unigram_ops.make_device_table(table, wlen, wcount)
    want_c, want_ll = unigram_ops.forward_backward_resident(
        dt, logp.astype(np.float32), len(pieces))

    mesh = parallel.make_mesh(4)
    sdt = par_uni.make_sharded_table(mesh, table, wlen, wcount)
    got_c, got_ll = par_uni.sharded_forward_backward(
        sdt, logp.astype(np.float32), len(pieces), mesh=mesh)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)
    assert abs(got_ll - want_ll) < 1e-3

    # prune remap preserves sharded-vs-single agreement
    keep = np.ones(len(pieces), bool)
    keep[[i for i, p in enumerate(pieces) if len(p) > 1][::2]] = False
    perm = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
    n2 = int(keep.sum())
    lp2 = logp[keep].astype(np.float32)
    dt2 = unigram_ops.remap_device_table(dt, perm)
    sdt2 = par_uni.remap_sharded_table(sdt, perm)
    want2, _ = unigram_ops.forward_backward_resident(dt2, lp2, n2)
    got2, _ = par_uni.sharded_forward_backward(sdt2, lp2, n2, mesh=mesh)
    np.testing.assert_allclose(got2, want2, rtol=1e-5, atol=1e-5)


def test_sharded_unigram_trainer_end_to_end(tmp_path, monkeypatch):
    """UnigramTrainer(mesh=...) trains through the sharded EM path and
    produces the same piece set as the single-device DEVICE trainer
    (same float32 lattice math; the cpu backend's float64 FB can flip
    prune-order ties and is compared elsewhere)."""
    from shredword_tpu import parallel

    corpus = tmp_path / "c.txt"
    text = ("the cat sat on the mat " * 30 + "\n" +
            "a cat and a hat " * 30 + "\n") * 3
    corpus.write_text(text)

    from shredword_tpu import device
    monkeypatch.setattr(device, "is_accelerator", lambda: True)
    t1 = UnigramTrainer(target_vocab_size=40, seed_size=500,
                        max_word_len=16, num_em_rounds=2)
    t1.load_corpus(str(corpus))
    n1 = t1.train()

    mesh = parallel.make_mesh(4)
    t2 = UnigramTrainer(target_vocab_size=40, seed_size=500,
                        max_word_len=16, num_em_rounds=2, mesh=mesh)
    t2.load_corpus(str(corpus))
    n2 = t2.train()
    assert n2 == n1
    assert t2.pieces == t1.pieces
    np.testing.assert_allclose(t2.log_probs, t1.log_probs,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------
# native marker-word dedup (the encode fast path)
# ---------------------------------------------------------------------

def test_marker_word_dedup_matches_python_split():
    """shred_marker_word_dedup reproduces the Python
    split-lines/split-markers word stream exactly (incl. dedup order,
    partial marker bytes treated as content, empty segments skipped)."""
    texts = [
        "hello world hello",
        "a  b\n\nc a",
        "",
        "   ",
        "one\ntwo three\ntwo",
        "x" * 100 + " y " + "x" * 100,
        "café naïve café",     # multibyte content
    ]
    for text in texts:
        norm = native.normalize(text.encode())
        inverse, uoff, ulen = native.marker_word_dedup(norm)
        nb = bytes(norm)
        # oracle: the Python loop the native pass replaces
        want = []
        for line in nb.split(b"\n"):
            for raw in line.split(MARKER):
                if raw:
                    want.append(MARKER + raw)
        got = [MARKER + nb[o:o + l]
               for o, l in zip(uoff.tolist(), ulen.tolist())]
        stream = [got[i] for i in inverse.tolist()]
        assert stream == want, text
        assert len(got) == len(dict.fromkeys(want))  # dense unique ids


def test_unigram_encode_array_matches_encode(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat on the mat \n" * 50)
    t = UnigramTrainer(target_vocab_size=30, seed_size=200,
                       max_word_len=16, backend="cpu")
    t.load_corpus(str(corpus))
    t.train()
    t.save(str(tmp_path / "u.model"))
    tok = UnigramTokenizer.load(str(tmp_path / "u.model"))
    text = "the cat sat on the mat the cat"
    ids_a = tok.encode_array(text)
    assert tok.encode(text) == ids_a.tolist()
    assert tok.decode(ids_a) == text


def test_sharded_unigram_non_pow2_shards(tmp_path):
    """Non-power-of-two shard counts must not trip the sharding
    divisibility rule (W pads to a multiple of the shard count), and an
    explicit mesh overrides backend='cpu' (review findings r4)."""
    from shredword_tpu import parallel
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat on the mat \n" * 40)

    t3 = UnigramTrainer(target_vocab_size=30, seed_size=200,
                        max_word_len=16, mesh=parallel.make_mesh(3))
    t3.load_corpus(str(corpus))
    assert t3.train() == 30

    t4 = UnigramTrainer(target_vocab_size=30, seed_size=200,
                        max_word_len=16, backend="cpu",
                        mesh=parallel.make_mesh(4))
    t4.load_corpus(str(corpus))
    assert t4.train() == 30
    assert t4._slabs is not None          # the sharded EM actually ran


def test_unigram_encode_batch_contract(tmp_path):
    """encode_batch returns list[list[int]] (the BPE Tokenizer
    contract); encode_batch_arrays returns int32 numpy arrays."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat on the mat \n" * 40)
    t = UnigramTrainer(target_vocab_size=30, seed_size=200,
                       max_word_len=16, backend="cpu")
    t.load_corpus(str(corpus))
    t.train()
    t.save(str(tmp_path / "u.model"))
    tok = UnigramTokenizer.load(str(tmp_path / "u.model"))
    lists = tok.encode_batch(["the cat", "sat"])
    arrays = tok.encode_batch_arrays(["the cat", "sat"])
    assert all(isinstance(x, list) for x in lists)
    assert all(isinstance(i, int) for x in lists for i in x)
    assert all(isinstance(a, np.ndarray) for a in arrays)
    assert [a.tolist() for a in arrays] == lists
