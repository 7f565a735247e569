"""The table engine beyond vocab 4096 (the range the removed giant
engine served): differential conformance vs the flat engine,
envelope/decline behavior, and engine="giant"/"hist" selection.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from shredword_tpu.ops import bpe_hist, bpe_ops


def gen_corpus(seed, n_words=60, vmax=250, maxlen=9):
    rng = np.random.default_rng(seed)
    toks, wid, wcnt = [], [], []
    for w in range(n_words):
        ln = int(rng.integers(1, maxlen))
        toks.extend(rng.integers(0, vmax, ln).tolist())
        wid.extend([w] * ln)
        wcnt.append(int(rng.integers(1, 50)))
    return (np.array(toks, np.int32), np.array(wid, np.int32),
            np.array(wcnt, np.int32))


def flat_reference(tokens, word_id, wcount_per_word, target, unk, minf):
    wc_pos = wcount_per_word[word_id]
    cap = 1 << int(np.ceil(np.log2(max(len(tokens), 2))))
    state = bpe_ops.make_state(tokens, word_id, wc_pos, cap)
    ts = bpe_ops.train_init(state, target)
    ts = bpe_ops.train_loop(ts, jnp.int32(unk), jnp.int32(minf),
                            target_merges=target, max_steps=target + 4,
                            packed=False)
    n = int(ts.n_merges)
    return (np.asarray(ts.merges)[:n], np.asarray(ts.merge_freqs)[:n],
            np.asarray(ts.corpus.tokens)[:int(ts.corpus.length)],
            np.asarray(ts.corpus.word_id)[:int(ts.corpus.length)])


@pytest.mark.parametrize("seed,target,unk,minf", [
    (0, 40, -1, 2),
    (2, 30, 7, 2),       # unk collides with a live byte id
    (4, 50, -1, 1),
])
def test_giant_matches_flat(seed, target, unk, minf):
    tokens, wid, wcnt = gen_corpus(seed)
    got = bpe_hist.hist_train(
        tokens, wid, wcnt, target_merges=target, unk_id=unk,
        min_pair_freq=minf, max_steps_per_call=32)
    assert got is not None
    gm, gf, gt, gw = got
    rm, rf, rt, rw = flat_reference(tokens, wid, wcnt, target, unk, minf)
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(gf, rf)
    np.testing.assert_array_equal(gt, rt)    # final corpus, original order
    np.testing.assert_array_equal(gw, rw)


def test_giant_lazy_final_and_multicall():
    tokens, wid, wcnt = gen_corpus(1, n_words=50)
    got = bpe_hist.hist_train(
        tokens, wid, wcnt, target_merges=48, unk_id=-1, min_pair_freq=1,
        max_steps_per_call=7,                  # forces continuation calls
        lazy_final=True)
    assert got is not None
    gm, gf, final_fn = got
    rm, rf, rt, rw = flat_reference(tokens, wid, wcnt, 48, -1, 1)
    np.testing.assert_array_equal(gm, rm)
    gt, gw = final_fn()
    np.testing.assert_array_equal(gt, rt)
    np.testing.assert_array_equal(gw, rw)


def test_giant_big_vocab_layout():
    # vocab > 4096; the corpus exhausts long before the target, which
    # also checks termination
    tokens, wid, wcnt = gen_corpus(5, n_words=40, maxlen=6)
    target = 5000 - 256          # v = 5120 > 4096
    got = bpe_hist.hist_train(
        tokens, wid, wcnt, target_merges=target, unk_id=-1,
        min_pair_freq=1, max_steps_per_call=64)
    assert got is not None
    gm, gf, gt, gw = got
    rm, rf, rt, rw = flat_reference(tokens, wid, wcnt, target, -1, 1)
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(gt, rt)


def test_giant_declines_out_of_envelope():
    tokens, wid, wcnt = gen_corpus(0, n_words=10)
    # a 100-token word exceeds max_word_len
    long_tokens = np.concatenate([tokens, np.ones(100, np.int32)])
    long_wid = np.concatenate([wid, np.full(100, wid[-1] + 1, np.int32)])
    long_wcnt = np.concatenate([wcnt, np.ones(1, np.int32)])
    assert bpe_hist.hist_train(long_tokens, long_wid, long_wcnt,
                               target_merges=10) is None
    # vocab beyond the single-device table
    assert bpe_hist.hist_train(tokens, wid, wcnt,
                               target_merges=40000) is None


def test_hist_train_routes_to_giant_beyond_4096():
    """hist_train itself serves vocab beyond 4096 (once the giant
    engine's range) and matches the flat engine there."""
    tokens, wid, wcnt = gen_corpus(6, n_words=40, maxlen=6)
    target = 4864 - 256
    out = bpe_hist.hist_train(tokens, wid, wcnt, target_merges=target,
                              unk_id=-1, min_pair_freq=1,
                              max_steps_per_call=64)
    assert out is not None
    gm, gf, gt, gw = out
    rm, rf, rt, rw = flat_reference(tokens, wid, wcnt, target, -1, 1)
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(gt, rt)


@pytest.mark.parametrize("engine", ["giant", "hist"])
def test_engine_names_select_table_engine(engine, monkeypatch):
    """engine='giant' and engine='hist' both select the table engine,
    beyond vocab 4096 too, and it matches the flat engine."""
    from shredword_tpu.models.bpe import BPETrainer
    calls = []
    orig = bpe_hist.hist_train

    def spy(*a, **k):
        calls.append(k["target_merges"])
        return orig(*a, **k)

    monkeypatch.setattr(bpe_hist, "hist_train", spy)
    data = b"".join(bytes([97 + i % 7, 98 + i % 5, 99 + i % 3, 32])
                    for i in range(600)) + b"\n"
    t = BPETrainer(target_vocab_size=4864, unk_id=-1,
                   character_coverage=1.0, min_pair_freq=1,
                   engine=engine)
    t.load_corpus_bytes(data)
    n = t.train()
    assert calls == [4864 - 256]
    f = BPETrainer(target_vocab_size=4864, unk_id=-1,
                   character_coverage=1.0, min_pair_freq=1, engine="flat")
    f.load_corpus_bytes(data)
    assert f.train() == n
    np.testing.assert_array_equal(t.merges, f.merges)
    np.testing.assert_array_equal(t.token_frequencies(),
                                  f.token_frequencies())
