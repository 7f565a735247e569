"""Sharded checkpoint resume (r4 verdict item 6): interrupted-then-
resumed SHARDED training equals uninterrupted sharded training (which
itself is bit-identical to single-device, tests/test_parallel.py).

The resume path is engine-agnostic: _replay_for_resume replays the
learned merges host-side with the native encoder, then the sharded
loops seed their merge counter at n_prev (new ids continue at
256 + n_prev)."""

import numpy as np
import pytest

from shredword_tpu.models.bpe import BPETrainer


def _train(zcorpus, *, shards=0, max_merges=None, prev=None, **kw):
    t = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", shards=shards, **kw)
    t.load_corpus(zcorpus)
    if prev is not None:
        assert t.load_checkpoint(prev) > 0
    t.train(max_merges)
    return t


def test_sharded_resume_matches_uninterrupted(zipf_corpus_file, tmp_path):
    full = _train(zipf_corpus_file, shards=4)
    n = len(full.merges)
    assert n > 12

    half = _train(zipf_corpus_file, shards=4, max_merges=12)
    assert len(half.merges) == 12
    cp = str(tmp_path / "s.ckpt")
    half.save_checkpoint(cp)

    resumed = _train(zipf_corpus_file, shards=4, prev=cp)
    np.testing.assert_array_equal(resumed.merges, full.merges)
    np.testing.assert_array_equal(resumed.merge_freqs, full.merge_freqs)
    np.testing.assert_array_equal(resumed.token_frequencies(),
                                  full.token_frequencies())


def test_single_device_checkpoint_resumes_sharded(zipf_corpus_file,
                                                  tmp_path):
    """A checkpoint written by a single-device run resumes on the mesh
    (and vice versa) — the checkpoint format carries only merges."""
    full = _train(zipf_corpus_file, shards=4)

    single_half = _train(zipf_corpus_file, shards=0, max_merges=10)
    cp = str(tmp_path / "x.ckpt")
    single_half.save_checkpoint(cp)

    resumed = _train(zipf_corpus_file, shards=4, prev=cp)
    np.testing.assert_array_equal(resumed.merges, full.merges)

    # and back: sharded checkpoint -> single-device resume
    sharded_half = _train(zipf_corpus_file, shards=4, max_merges=10)
    cp2 = str(tmp_path / "y.ckpt")
    sharded_half.save_checkpoint(cp2)
    resumed1 = _train(zipf_corpus_file, shards=0, prev=cp2)
    np.testing.assert_array_equal(resumed1.merges, full.merges)


def test_sharded_flat_engine_resume(zipf_corpus_file, tmp_path):
    """Force the flat sharded path (vocab beyond the giant cap is not
    testable at this scale, so drive sharded_train directly) — resume
    seeds the merge counter and returns only new merges."""
    from shredword_tpu.parallel import make_mesh, sharded_train
    from shredword_tpu.runtime import native

    t = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5)
    t.load_corpus(zipf_corpus_file)
    tokens, word_id, wcount = t._token_arrays()
    mesh = make_mesh(4)
    m_full, f_full = sharded_train(
        tokens, word_id, wcount, mesh=mesh, target_merges=60,
        unk_id=-1, min_pair_freq=5)
    assert len(m_full) > 12

    # replay the first 12 merges host-side, then resume
    lengths = np.bincount(word_id)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    enc = native.NativeEncoder(m_full[:12])
    tokens2, off2 = enc.apply_merges(tokens, offsets)
    enc.free()
    word_id2 = np.repeat(np.arange(len(lengths), dtype=np.int32),
                         np.diff(off2))
    counts = np.minimum(t._arrays.counts,
                        np.iinfo(np.int32).max).astype(np.int32)
    wcount2 = counts[word_id2]
    m_new, f_new = sharded_train(
        tokens2, word_id2, wcount2, mesh=mesh, target_merges=60,
        unk_id=-1, min_pair_freq=5, n_prev_merges=12)
    np.testing.assert_array_equal(
        np.concatenate([m_full[:12], m_new]), m_full)
    np.testing.assert_array_equal(
        np.concatenate([f_full[:12], f_new]), f_full)
