"""Engine routing, decided through shredword_tpu.device.

On a CPU-only host (these tests run on CPU) engine='auto' routes to the
flat engine.  On an accelerator auto takes the table engine up to
models.bpe.TABLE_AUTO_MAX_VOCAB.  Explicit engine='hist'/'giant' always
selects the table engine.  The accelerator case is stood in by
monkeypatching device.is_accelerator — the one place routing asks.
"""

import numpy as np
import pytest

from shredword_tpu import device
from shredword_tpu.models import bpe as bpe_model
from shredword_tpu.models.bpe import BPETrainer


CORPUS = b"the quick brown fox jumps over the lazy dog\n" * 50


def _trainer(**kw):
    t = BPETrainer(target_vocab_size=300, unk_id=-1,
                   character_coverage=1.0, min_pair_freq=2,
                   backend="device", **kw)
    t.load_corpus_bytes(CORPUS)
    return t


def _spy_table(monkeypatch):
    from shredword_tpu.ops import bpe_hist
    called = []
    orig = bpe_hist.hist_train

    def spy(*a, **k):
        called.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(bpe_hist, "hist_train", spy)
    return called


def test_auto_avoids_interpret_pallas(monkeypatch):
    """No accelerator: auto takes the flat engine."""
    assert not device.is_accelerator()
    called = _spy_table(monkeypatch)
    t = _trainer()
    assert t.train() > 0
    assert not called


def test_interpret_opt_in_restores_hist(monkeypatch):
    """With an accelerator, auto takes the table engine, and its merges
    equal the flat engine's."""
    monkeypatch.setattr(device, "is_accelerator", lambda: True)
    called = _spy_table(monkeypatch)
    t_table = _trainer()
    n = t_table.train()
    assert n > 0 and called
    t_flat = _trainer(engine="flat")
    assert t_flat.train() == n
    np.testing.assert_array_equal(t_table.merges, t_flat.merges)


def test_explicit_hist_still_honored(monkeypatch):
    called = _spy_table(monkeypatch)
    t = _trainer(engine="hist")
    assert t.train() > 0
    assert called


@pytest.mark.parametrize("accel,engine,vocab,table", [
    (False, "auto", 300, False),
    (True, "auto", 300, True),
    (True, "auto", bpe_model.TABLE_AUTO_MAX_VOCAB, True),
    (True, "auto", bpe_model.TABLE_AUTO_MAX_VOCAB + 1, False),
    (True, "flat", 300, False),
    (False, "flat", 300, False),
    (False, "hist", 300, True),
    (False, "giant", 40000, True),
])
def test_use_table_engine_rule(monkeypatch, accel, engine, vocab, table):
    monkeypatch.setattr(device, "is_accelerator", lambda: accel)
    assert bpe_model._use_table_engine(engine, vocab) is table


def test_explicit_table_engine_outside_envelope_raises():
    from shredword_tpu.errors import TrainingError
    t = BPETrainer(target_vocab_size=300, unk_id=-1,
                   character_coverage=1.0, min_pair_freq=1, engine="giant")
    t.load_corpus_bytes(b"x" * 100 + b" ab ab\n")     # a 100-byte word
    with pytest.raises(TrainingError, match="table engine"):
        t.train()


def test_device_module_reports_jax_platform():
    import jax
    assert device.platform() == jax.default_backend() == "cpu"
    d = device.describe()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_sharded_auto_avoids_interpret_pallas(monkeypatch):
    """The sharded path starts on the replicated-table engine (plain
    XLA on every platform) and matches single-device training."""
    from shredword_tpu import parallel
    calls = []
    orig = parallel.sharded_hist_train

    def spy(*a, **k):
        calls.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(parallel, "sharded_hist_train", spy)
    t = _trainer(shards=2)
    n = t.train()
    assert n > 0 and calls
    single = _trainer()
    assert single.train() == n
    np.testing.assert_array_equal(t.merges, single.merges)
