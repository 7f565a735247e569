"""Sharded-training tests on an 8-virtual-device CPU mesh.

The sharded trainer must produce the exact merge sequence of the
single-device trainer (same lex tie-break, integer counts ->
bit-deterministic psum-equivalent reduction).
"""

import numpy as np
import pytest

import jax


def _flat_arrays(path, coverage, unk_id):
    from shredword_tpu.runtime.native import NativeCorpus
    c = NativeCorpus.from_file(path)
    arrays = c.arrays()
    keep, _, _ = c.coverage(coverage)
    tokens = arrays.word_bytes.astype(np.int32)
    tokens[~keep[arrays.word_bytes]] = unk_id
    lengths = np.diff(arrays.offsets)
    word_id = np.repeat(np.arange(arrays.n_words, dtype=np.int32), lengths)
    wcount = arrays.counts.astype(np.int32)[word_id]
    return tokens, word_id, wcount


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_matches_single_device(zipf_corpus_file, n_shards):
    from shredword_tpu import parallel
    from shredword_tpu.models.bpe import BPETrainer

    assert len(jax.devices()) >= n_shards, "conftest must force 8 devices"

    t = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device")
    t.load_corpus(zipf_corpus_file)
    n = t.train()
    assert n > 0

    tokens, word_id, wcount = _flat_arrays(zipf_corpus_file, 0.9995, -1)
    mesh = parallel.make_mesh(n_shards)
    merges, freqs = parallel.sharded_train(
        tokens, word_id, wcount, mesh=mesh, target_merges=330 - 256,
        unk_id=-1, min_pair_freq=5)

    assert len(merges) == n
    np.testing.assert_array_equal(merges, t.merges)
    np.testing.assert_array_equal(freqs, t.merge_freqs.astype(np.int32))


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_hist_matches_single_device(zipf_corpus_file, n_shards):
    from shredword_tpu import parallel
    from shredword_tpu.models.bpe import BPETrainer

    t = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device")
    t.load_corpus(zipf_corpus_file)
    n = t.train()

    tokens, word_id, wcount = _flat_arrays(zipf_corpus_file, 0.9995, -1)
    wc_word = wcount[np.searchsorted(word_id, np.arange(word_id[-1] + 1))]
    mesh = parallel.make_mesh(n_shards)
    out = parallel.sharded_hist_train(
        tokens, word_id, wc_word, mesh=mesh, target_merges=330 - 256,
        unk_id=-1, min_pair_freq=5)
    assert out is not None
    merges, freqs = out
    assert len(merges) == n
    np.testing.assert_array_equal(merges, t.merges)
    np.testing.assert_array_equal(freqs, t.merge_freqs.astype(np.int32))


def test_shard_corpus_word_boundaries():
    from shredword_tpu.parallel import shard_corpus
    rng = np.random.RandomState(0)
    n_words = 57
    lens = rng.randint(1, 9, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(0, 256, len(word_id)).astype(np.int32)
    wcount = np.ones(len(word_id), np.int32)
    sc = shard_corpus(tokens, word_id, wcount, 4)
    # no word split across shards; concatenation reproduces the stream
    seen = []
    for d in range(4):
        L = int(sc.lengths[d])
        wid = np.asarray(sc.word_id[d])[:L]
        if L:
            # boundary check: first word of this shard doesn't continue
            # the previous shard's last word
            if seen:
                assert wid[0] != seen[-1]
            seen.extend(wid.tolist())
    assert seen == word_id.tolist()


def test_bpetrainer_mesh_wiring(zipf_corpus_file):
    """The PUBLIC API reaches the sharded path: BPETrainer(mesh=...) /
    shards=N trains data-parallel and stays bit-identical to
    single-device training, including save() output."""
    from shredword_tpu import parallel
    from shredword_tpu.models.bpe import BPETrainer

    single = BPETrainer(target_vocab_size=330, unk_id=-1,
                        character_coverage=0.9995, min_pair_freq=5,
                        backend="device")
    single.load_corpus(zipf_corpus_file)
    n = single.train()
    assert n > 0

    mesh = parallel.make_mesh(4)
    t = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", mesh=mesh)
    t.load_corpus(zipf_corpus_file)
    assert t.train() == n
    np.testing.assert_array_equal(t.merges, single.merges)
    # final-corpus replay path: token frequencies match too
    np.testing.assert_array_equal(t.token_frequencies(),
                                  single.token_frequencies())

    t2 = BPETrainer(target_vocab_size=330, unk_id=-1,
                    character_coverage=0.9995, min_pair_freq=5,
                    backend="device", shards=2)
    t2.load_corpus(zipf_corpus_file)
    assert t2.train() == n
    np.testing.assert_array_equal(t2.merges, single.merges)


def test_bpetrainer_shards_flat_fallback(zipf_corpus_file, monkeypatch):
    """When both table engines decline, the sharded flat engine is
    reached through the same public entry point."""
    from shredword_tpu.models.bpe import BPETrainer
    from shredword_tpu import parallel

    single = BPETrainer(target_vocab_size=2400, unk_id=-1,
                        character_coverage=0.9995, min_pair_freq=5,
                        backend="device", engine="flat")
    single.load_corpus(zipf_corpus_file)
    n = single.train()
    assert n > 0

    monkeypatch.setattr(parallel, "sharded_giant_train",
                        lambda *a, **k: None)
    t = BPETrainer(target_vocab_size=2400, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", shards=2)
    t.load_corpus(zipf_corpus_file)
    assert t.train() == n
    np.testing.assert_array_equal(t.merges, single.merges)


def test_sharded_giant_matches_single_device():
    """Table-row-sharded giant engine (vocab beyond one device's
    table): bit-identical merges to the single-device table engine,
    invariant to shard count."""
    from shredword_tpu.ops import bpe_hist
    from shredword_tpu.parallel import make_mesh, sharded_giant_train

    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 104, int(rng.integers(2, 8))).tolist())
             for _ in range(300)]
    counts = rng.integers(1, 60, len(words)).astype(np.int32)
    toks = np.concatenate([np.frombuffer(w, np.uint8).astype(np.int32)
                           for w in words])
    wid = np.repeat(np.arange(len(words), dtype=np.int32),
                    [len(w) for w in words])

    m_ref, f_ref, _ = bpe_hist.hist_train(
        toks, wid, counts, target_merges=32, min_pair_freq=2,
        lazy_final=True)

    for n_shards in (2, 8):
        m, f = sharded_giant_train(
            toks, wid, counts, mesh=make_mesh(n_shards),
            target_merges=32, min_pair_freq=2, max_steps_per_call=16)
        assert m.tolist() == m_ref.tolist()
        assert f.tolist() == f_ref.tolist()


def test_bpetrainer_shards_giant_engine(zipf_corpus_file):
    """Vocab beyond the replicated-table cap (4096) routes to the
    row-sharded giant engine through the public entry point and stays
    bit-identical to single-device flat training."""
    from shredword_tpu.models.bpe import BPETrainer

    single = BPETrainer(target_vocab_size=4500, unk_id=-1,
                        character_coverage=0.9995, min_pair_freq=5,
                        backend="device", engine="flat")
    single.load_corpus(zipf_corpus_file)
    n = single.train()
    assert n > 0

    t = BPETrainer(target_vocab_size=4500, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", shards=4)
    t.load_corpus(zipf_corpus_file)
    assert t.train() == n
    np.testing.assert_array_equal(t.merges, single.merges)


def test_sharded_hist_vocab_4096_matches_single(zipf_corpus_file):
    """The sharded hist engine's cap matches the single-device engine
    (v = 4096): vocab in (2048, 4096] trains on the replicated-table
    psum path, bit-identical to single-device flat training and
    shard-count-invariant (VERDICT r3 weak #6)."""
    from shredword_tpu import parallel
    from shredword_tpu.models.bpe import BPETrainer

    single = BPETrainer(target_vocab_size=4096, unk_id=-1,
                        character_coverage=0.9995, min_pair_freq=5,
                        backend="device", engine="flat")
    single.load_corpus(zipf_corpus_file)
    n = single.train()
    assert n > 0

    tokens, word_id, wcount = single._token_arrays()
    wc_word = np.minimum(single._arrays.counts,
                         np.iinfo(np.int32).max).astype(np.int32)
    for n_shards in (2, 4):
        out = parallel.sharded_hist_train(
            tokens, word_id, wc_word, mesh=parallel.make_mesh(n_shards),
            target_merges=4096 - 256, min_pair_freq=5)
        assert out is not None, "v=4096 must fit the sharded hist engine"
        merges, freqs = out
        np.testing.assert_array_equal(merges, single.merges)
        np.testing.assert_array_equal(freqs, single.merge_freqs)
