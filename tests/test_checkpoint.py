"""Checkpoint/resume: interrupted training must converge to exactly the
same merge table as uninterrupted training (replay + re-count resume,
mirroring the reference's bpe_init resumability, bpe.cpp:171-185)."""

import numpy as np
import pytest

from shredword_tpu import checkpoint as ckpt
from shredword_tpu.errors import SerializationError
from shredword_tpu.models.bpe import BPETrainer


@pytest.fixture(scope="module")
def corpus(request):
    return request.getfixturevalue("small_corpus_file")


def _train_full(corpus, **kw):
    t = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                   backend="device", **kw)
    t.load_corpus(corpus)
    t.train()
    return t


def test_resume_matches_uninterrupted(corpus, tmp_path):
    full = _train_full(corpus)

    part = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                      backend="device")
    part.load_corpus(corpus)
    n1 = part.train(max_merges=10)
    assert n1 == 10
    cp = str(tmp_path / "train.ckpt")
    part.save_checkpoint(cp)
    part.destroy()

    resumed = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                         backend="device")
    resumed.load_corpus(corpus)
    assert resumed.load_checkpoint(cp) == 10
    resumed.train()
    np.testing.assert_array_equal(resumed.merges, full.merges)
    np.testing.assert_array_equal(resumed.merge_freqs, full.merge_freqs)
    # final corpus state identical too (token_frequencies uses it)
    np.testing.assert_array_equal(resumed.token_frequencies(),
                                  full.token_frequencies())


def test_auto_checkpoint_written(corpus, tmp_path):
    cp = str(tmp_path / "auto.ckpt")
    t = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                   backend="device", engine="flat", merges_per_device_call=8,
                   checkpoint_path=cp, checkpoint_every=8)
    t.load_corpus(corpus)
    n = t.train()
    assert n > 8
    cfg, merges, freqs = ckpt.load_checkpoint(cp)
    assert len(merges) >= 8
    np.testing.assert_array_equal(merges, t.merges[:len(merges)])


def test_checkpoint_roundtrip(tmp_path):
    from shredword_tpu.config import BPEConfig
    merges = np.array([[97, 98], [256, 99]], np.int32)
    freqs = np.array([41, 17], np.int64)
    p = str(tmp_path / "c.ckpt")
    ckpt.save_checkpoint(p, merges=merges, merge_freqs=freqs,
                         config=BPEConfig())
    cfg, m2, f2 = ckpt.load_checkpoint(p)
    np.testing.assert_array_equal(m2, merges)
    np.testing.assert_array_equal(f2, freqs)
    assert cfg["target_vocab_size"] == 8192


def test_checkpoint_rejects_garbage(tmp_path):
    p = tmp_path / "bad.ckpt"
    p.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00not json hereXXXX")
    with pytest.raises(SerializationError):
        ckpt.load_checkpoint(str(p))


def test_giant_engine_checkpoint_cadence(zipf_corpus_file, tmp_path):
    """engine='giant' honors checkpoint_path/checkpoint_every (it
    previously skipped checkpoints silently) and RESUMES from a
    checkpoint on the same engine (new ids continue at 256 + n_prev),
    converging to the uninterrupted result."""
    import numpy as np
    from shredword_tpu import checkpoint as ckpt
    from shredword_tpu.models.bpe import BPETrainer

    path = str(tmp_path / "g.ckpt")
    t = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", engine="giant",
                   checkpoint_path=path, checkpoint_every=8)
    t.load_corpus(zipf_corpus_file)
    n = t.train()
    _, m, f = ckpt.load_checkpoint(path)
    assert len(m) == n
    np.testing.assert_array_equal(m, t.merges)

    # interrupt after 8 merges, resume on the giant engine itself
    half = BPETrainer(target_vocab_size=330, unk_id=-1,
                      character_coverage=0.9995, min_pair_freq=5,
                      backend="device", engine="giant")
    half.load_corpus(zipf_corpus_file)
    assert half.train(max_merges=8) == 8
    cp2 = str(tmp_path / "g2.ckpt")
    half.save_checkpoint(cp2)

    resumed = BPETrainer(target_vocab_size=330, unk_id=-1,
                         character_coverage=0.9995, min_pair_freq=5,
                         backend="device", engine="giant")
    resumed.load_corpus(zipf_corpus_file)
    assert resumed.load_checkpoint(cp2) == 8
    assert resumed.train() == n - 8
    np.testing.assert_array_equal(resumed.merges, t.merges)
    np.testing.assert_array_equal(resumed.merge_freqs, t.merge_freqs)
    np.testing.assert_array_equal(resumed.token_frequencies(),
                                  t.token_frequencies())


def test_hist_engine_resume_matches_uninterrupted(zipf_corpus_file,
                                                  tmp_path):
    """Resume continues on the HIST engine (not the slow flat path):
    interrupted-then-resumed training equals uninterrupted training,
    and the checkpoint written mid-resume carries the full sequence."""
    import numpy as np
    from shredword_tpu import checkpoint as ckpt
    from shredword_tpu.models.bpe import BPETrainer

    full = BPETrainer(target_vocab_size=330, unk_id=-1,
                      character_coverage=0.9995, min_pair_freq=5,
                      backend="device", engine="hist")
    full.load_corpus(zipf_corpus_file)
    n = full.train()
    assert n > 12

    half = BPETrainer(target_vocab_size=330, unk_id=-1,
                      character_coverage=0.9995, min_pair_freq=5,
                      backend="device", engine="hist")
    half.load_corpus(zipf_corpus_file)
    assert half.train(max_merges=12) == 12
    cp = str(tmp_path / "h.ckpt")
    half.save_checkpoint(cp)

    path2 = str(tmp_path / "h_auto.ckpt")
    resumed = BPETrainer(target_vocab_size=330, unk_id=-1,
                         character_coverage=0.9995, min_pair_freq=5,
                         backend="device", engine="hist",
                         checkpoint_path=path2, checkpoint_every=8)
    resumed.load_corpus(zipf_corpus_file)
    assert resumed.load_checkpoint(cp) == 12
    assert resumed.train() == n - 12
    np.testing.assert_array_equal(resumed.merges, full.merges)
    np.testing.assert_array_equal(resumed.merge_freqs, full.merge_freqs)
    np.testing.assert_array_equal(resumed.token_frequencies(),
                                  full.token_frequencies())
    # the mid-resume checkpoint includes the replayed prefix
    _, m2, _ = ckpt.load_checkpoint(path2)
    np.testing.assert_array_equal(m2, full.merges[:len(m2)])
    assert len(m2) > 12
