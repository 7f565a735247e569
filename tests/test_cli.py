"""CLI end-to-end tests (train/encode/decode/convert/info).

The reference has no CLI (SURVEY.md §5 "No CLI"); behavior here is
checked against the library API it wraps.
"""

import numpy as np
import pytest

from shredword_tpu import serialization
from shredword_tpu.cli import main
from shredword_tpu.models.bpe import BPETrainer
from shredword_tpu.tokenizer import Tokenizer


@pytest.fixture(scope="module")
def trained_model(tmp_path_factory, request):
    corpus = request.getfixturevalue("small_corpus_file")
    d = tmp_path_factory.mktemp("cli")
    model, vocab = str(d / "m.model"), str(d / "m.vocab")
    rc = main(["train", "--corpus", corpus, "--model", model,
               "--vocab", vocab, "--vocab-size", "320", "--unk-id", "-1",
               "--min-pair-freq", "2", "--backend", "cpu",
               "--tie-break", "faithful"])
    assert rc == 0
    return corpus, model, vocab


def test_cli_train_matches_library(trained_model, tmp_path):
    corpus, model, vocab = trained_model
    t = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                   backend="cpu", tie_break="faithful")
    t.load_corpus(corpus)
    t.train()
    lib_model = str(tmp_path / "lib.model")
    lib_vocab = str(tmp_path / "lib.vocab")
    t.save(lib_model, lib_vocab)
    t.destroy()
    assert open(model, "rb").read() == open(lib_model, "rb").read()
    assert open(vocab, "rb").read() == open(lib_vocab, "rb").read()


def test_cli_encode_decode_roundtrip(trained_model, tmp_path, capsys):
    _, model, _ = trained_model
    text_in = str(tmp_path / "in.txt")
    ids_out = str(tmp_path / "ids.txt")
    text_out = str(tmp_path / "out.txt")
    payload = "the quick brown fox jumps over the lazy dog\n"
    open(text_in, "w").write(payload)
    assert main(["encode", "--model", model, "--input", text_in,
                 "--output", ids_out]) == 0
    ids = [int(x) for x in open(ids_out).read().split()]
    tok = Tokenizer.load(model)
    assert ids == tok.encode(payload)
    assert main(["decode", "--model", model, "--input", ids_out,
                 "--output", text_out]) == 0
    assert open(text_out).read() == payload


def test_cli_convert_and_info(trained_model, tmp_path, capsys):
    _, model, _ = trained_model
    v1 = str(tmp_path / "m.v1.model")
    assert main(["convert", model, v1]) == 0
    m_bin, _, _ = serialization.read_model_any(model)
    m_v1, _, _ = serialization.read_model_any(v1)
    np.testing.assert_array_equal(m_bin, m_v1)
    assert main(["info", model]) == 0
    out = capsys.readouterr().out
    assert f"merges:   {len(m_bin)}" in out


def test_faithful_tiebreak_tpu_backend_falls_back(trained_model, tmp_path):
    """tie_break='faithful' must work under backend='device' (routes to the
    native faithful engine; selection artifacts are CPU-only)."""
    corpus, model, _ = trained_model
    t = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                   backend="device", tie_break="faithful")
    t.load_corpus(corpus)
    t.train()
    out = str(tmp_path / "f.model")
    t.save(out, str(tmp_path / "f.vocab"))
    t.destroy()
    assert open(out, "rb").read() == open(model, "rb").read()
