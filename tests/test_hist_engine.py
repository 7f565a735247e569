"""Differential tests: the table engine (ops/bpe_hist.py, plain XLA on
CPU here) vs the flat-stream engine (bpe_ops) and the numpy oracle —
the merge sequences must be bit-identical (all implement greedy
lex-tie-break BPE with exact counts)."""

import jax.numpy as jnp
import numpy as np
import pytest

from shredword_tpu.ops import bpe_hist, bpe_ops
from test_tpu_trainer import numpy_bpe


def _flat_train(tokens, word_id, wcount, target, unk, minf):
    cap = max(1024, 1 << int(np.ceil(np.log2(max(len(tokens), 2)))))
    state = bpe_ops.make_state(tokens, word_id, wcount, cap)
    ts = bpe_ops.train_init(state, max(target, 1))
    ts = bpe_ops.train_loop(ts, jnp.int32(unk), jnp.int32(minf),
                            target_merges=target, max_steps=target + 4)
    n = int(ts.n_merges)
    length = int(ts.corpus.length)
    return (np.asarray(ts.merges)[:n], np.asarray(ts.merge_freqs)[:n],
            np.asarray(ts.corpus.tokens)[:length],
            np.asarray(ts.corpus.word_id)[:length])


def _rand_corpus(seed, n_words=300, alpha=6, max_len=12):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    wcount = rng.randint(1, 60, n_words).astype(np.int32)[word_id]
    return tokens, word_id, wcount


def _wc_word(word_id, wcount):
    return wcount[np.searchsorted(word_id, np.arange(word_id[-1] + 1))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_hist_engine_matches_flat(seed):
    tokens, word_id, wcount = _rand_corpus(seed)
    target, unk, minf = 40, -1, 2
    out = bpe_hist.hist_train(
        tokens, word_id, _wc_word(word_id, wcount),
        target_merges=target, unk_id=unk, min_pair_freq=minf)
    assert out is not None
    merges_h, freqs_h, ftok_h, fwid_h = out
    merges_f, freqs_f, ftok_f, fwid_f = _flat_train(
        tokens, word_id, wcount, target, unk, minf)
    np.testing.assert_array_equal(merges_h, merges_f)
    np.testing.assert_array_equal(freqs_h, freqs_f)
    np.testing.assert_array_equal(ftok_h, ftok_f)
    np.testing.assert_array_equal(fwid_h, fwid_f)


@pytest.mark.parametrize("seed", [0, 1])
def test_hist_engine_matches_numpy_oracle(seed):
    tokens, word_id, wcount = _rand_corpus(seed, n_words=120, alpha=5,
                                           max_len=9)
    wcw = _wc_word(word_id, wcount)
    words = np.split(tokens, np.cumsum(np.bincount(word_id))[:-1])
    want_m, want_f, _ = numpy_bpe(words, wcw.tolist(), -1, 2, 30)
    merges, freqs, _, _ = bpe_hist.hist_train(
        tokens, word_id, wcw, target_merges=30, min_pair_freq=2)
    np.testing.assert_array_equal(merges, np.array(want_m, np.int32))
    np.testing.assert_array_equal(freqs, np.array(want_f))


def test_hist_engine_overlap_runs():
    # 'aaaa'-style runs exercise the greedy overlap rule + deltas
    words = [b"aaaa", b"aaa", b"aa", b"baab", b"aabb"]
    counts = [7, 5, 3, 2, 9]
    tokens = np.concatenate(
        [np.frombuffer(w, np.uint8).astype(np.int32) for w in words])
    word_id = np.repeat(np.arange(len(words), dtype=np.int32),
                        [len(w) for w in words])
    wc_word = np.asarray(counts, np.int32)
    wcount = wc_word[word_id]
    out = bpe_hist.hist_train(tokens, word_id, wc_word, target_merges=10,
                              unk_id=-1, min_pair_freq=2)
    merges_h, freqs_h, ftok_h, fwid_h = out
    merges_f, freqs_f, ftok_f, fwid_f = _flat_train(
        tokens, word_id, wcount, 10, -1, 2)
    np.testing.assert_array_equal(merges_h, merges_f)
    np.testing.assert_array_equal(freqs_h, freqs_f)
    np.testing.assert_array_equal(ftok_h, ftok_f)


def test_hist_engine_with_unk():
    _check_unk(99)


@pytest.mark.parametrize("unk", [97, 300])
def test_hist_engine_unk_ids(unk):
    """unk colliding with a live byte, and unk beyond the byte range."""
    _check_unk(unk)


def _check_unk(unk):
    tokens, word_id, wcount = _rand_corpus(7, n_words=120, alpha=5)
    tokens = np.where(tokens == 99, unk, tokens)    # one symbol is unk
    wc_word = _wc_word(word_id, wcount)
    out = bpe_hist.hist_train(tokens, word_id, wc_word, target_merges=20,
                              unk_id=unk, min_pair_freq=2)
    merges_h, freqs_h, _, _ = out
    merges_f, freqs_f, _, _ = _flat_train(
        tokens, word_id, wcount, 20, unk, 2)
    np.testing.assert_array_equal(merges_h, merges_f)
    np.testing.assert_array_equal(freqs_h, freqs_f)
    assert not ((merges_h == unk).any())


def test_layout_fallback_for_long_words():
    tokens = np.arange(100, dtype=np.int32) % 26 + 97
    word_id = np.zeros(100, np.int32)  # one 100-byte word
    out = bpe_hist.hist_train(tokens, word_id, np.ones(1, np.int32),
                              target_merges=4, max_word_len=64)
    assert out is None


@pytest.mark.parametrize("target", [bpe_hist.MAX_V - 256 + 1, 40000])
def test_vocab_beyond_envelope_declines(target):
    tokens, word_id, wcount = _rand_corpus(0, n_words=20)
    assert bpe_hist.hist_train(tokens, word_id, _wc_word(word_id, wcount),
                               target_merges=target) is None


def test_fused_chunked_driving_matches_single_call():
    """A dispatch cadence smaller than the target must not change
    results nor overshoot the target."""
    _check_chunked(7)


@pytest.mark.parametrize("steps", [1, 13])
def test_chunked_driving_cadences(steps):
    _check_chunked(steps)


def _check_chunked(steps):
    tokens, word_id, wcount = _rand_corpus(8, n_words=600, alpha=8)
    wcw = _wc_word(word_id, wcount)
    one = bpe_hist.hist_train(tokens, word_id, wcw, target_merges=40,
                              unk_id=-1, min_pair_freq=2)
    seen = []
    chunked = bpe_hist.hist_train(
        tokens, word_id, wcw, target_merges=40, unk_id=-1,
        min_pair_freq=2, max_steps_per_call=steps,
        progress_cb=lambda m, f: seen.append(len(m)), _cache={})
    assert len(chunked[0]) <= 40
    assert seen == sorted(seen) and seen[-1] == len(chunked[0])
    for a, b in zip(one, chunked):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n_prev", [5, 17])
def test_resume_continues_the_merge_sequence(n_prev):
    """Resume: the caller replays n_prev merges into the corpus; new
    ids continue at 256 + n_prev and only new merges come back, equal
    to the tail of an uninterrupted run."""
    tokens, word_id, wcount = _rand_corpus(3, n_words=400, alpha=7)
    wcw = _wc_word(word_id, wcount)
    full_m, full_f, full_t, full_w = bpe_hist.hist_train(
        tokens, word_id, wcw, target_merges=40)
    _, _, mid_t, mid_w = bpe_hist.hist_train(
        tokens, word_id, wcw, target_merges=n_prev)
    merges, freqs, ftok, fwid = bpe_hist.hist_train(
        mid_t, mid_w, wcw, target_merges=40, n_prev_merges=n_prev)
    np.testing.assert_array_equal(merges, full_m[n_prev:])
    np.testing.assert_array_equal(freqs, full_f[n_prev:])
    np.testing.assert_array_equal(ftok, full_t)
    np.testing.assert_array_equal(fwid, full_w)


def test_fused_exhaustion_and_lazy_final():
    """min_pair_freq too high -> zero merges; lazy_final defers the
    corpus extraction behind a callable."""
    _check_exhaustion(10**9)


@pytest.mark.parametrize("minf", [2, 3])
def test_exhaustion_before_target(minf):
    """A small corpus exhausts before a large target."""
    _check_exhaustion(minf)


def _check_exhaustion(minf):
    tokens, word_id, wcount = _rand_corpus(9, n_words=30, max_len=4)
    wcw = _wc_word(word_id, wcount)
    merges, freqs, final_fn = bpe_hist.hist_train(
        tokens, word_id, wcw, target_merges=500, unk_id=-1,
        min_pair_freq=minf, lazy_final=True)
    eager = bpe_hist.hist_train(tokens, word_id, wcw, target_merges=500,
                                unk_id=-1, min_pair_freq=minf)
    want = _flat_train(tokens, word_id, wcount, 500, -1, minf)
    assert len(merges) == len(want[0]) < 500
    if minf >= 10**9:
        assert len(merges) == 0
    np.testing.assert_array_equal(merges, eager[0])
    np.testing.assert_array_equal(merges, want[0])
    ftok, fwid = final_fn()
    np.testing.assert_array_equal(ftok, eager[2])
    np.testing.assert_array_equal(fwid, eager[3])
    np.testing.assert_array_equal(ftok, want[2])


@pytest.mark.parametrize("n_shards", [1, 4])
def test_layout_columns_are_words(n_shards):
    tokens, word_id, wcount = _rand_corpus(4, n_words=333)
    wcw = _wc_word(word_id, wcount)
    c = bpe_hist.build_layout(tokens, word_id, wcw, n_shards=n_shards)
    L, W = c.tw.shape
    assert W % (128 * n_shards) == 0 and W >= 333
    assert L >= 12 and L & (L - 1) == 0
    cols = (c.tw >= 0).T
    np.testing.assert_array_equal(c.tw.T[cols], tokens)
    np.testing.assert_array_equal(cols.sum(1)[:333], np.bincount(word_id))
    np.testing.assert_array_equal(c.wcount[0, :333], wcw)
    assert not c.wcount[0, 333:].any() and not cols[333:].any()
