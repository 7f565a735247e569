"""Tokenizer tests: encode/decode semantics, backend parity, formats.

The encode oracle is a transparent Python implementation of the minbpe
contract (lowest-rank-first, left-to-right overlap consumption,
base.py:22-36) written inline here.
"""

import numpy as np
import pytest

from shredword_tpu import Tokenizer
from shredword_tpu.errors import DecodeError, EncodeError


def oracle_encode_chunk(data: bytes, merges) -> list[int]:
    ranks = {}
    for m, (a, b) in enumerate(merges):
        ranks.setdefault((int(a), int(b)), m)
    ids = list(data)
    while len(ids) >= 2:
        best = min((ranks.get(p, 1 << 60) for p in zip(ids, ids[1:])),
                   default=1 << 60)
        if best >= 1 << 60:
            break
        a, b = [int(x) for x in merges[best]]
        out, i = [], 0
        while i < len(ids):
            if i + 1 < len(ids) and ids[i] == a and ids[i + 1] == b:
                out.append(256 + best)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        ids = out
    return ids


@pytest.fixture(scope="module")
def trained(tmp_path_factory, zipf_corpus_text):
    p = tmp_path_factory.mktemp("tok") / "corpus.txt"
    p.write_text(zipf_corpus_text)
    return Tokenizer.train(str(p), vocab_size=384, backend="device")


def test_roundtrip_exact(trained):
    text = "the quick brown fox jumps over the lazy dog\n  multi  space\tand tabs"
    for backend in ("cpu", "device"):
        trained.backend = backend
        ids = trained.encode(text)
        assert trained.decode(ids) == text, backend


def test_backend_parity(trained, zipf_corpus_text):
    text = zipf_corpus_text[:5000]
    trained.backend = "cpu"
    cpu_ids = trained.encode(text)
    trained.backend = "device"
    dev_ids = trained.encode(text)
    assert cpu_ids == dev_ids


def test_encode_matches_oracle(trained, zipf_corpus_text):
    from shredword_tpu import pretokenize
    text = zipf_corpus_text[:2000] + " aaaa aaa zzz"
    chunks = pretokenize.whitespace_keep_split(text.encode("utf-8"))
    expected = []
    for c in chunks:
        expected.extend(oracle_encode_chunk(c, trained.merges))
    for backend in ("cpu", "device"):
        trained.backend = backend
        assert trained.encode(text) == expected, backend


def test_overlap_run_encode(trained):
    # force a merge table containing (97,97): 'aaaa' -> [X,X], 'aaa' -> [X,97]
    tok = Tokenizer(merges=np.array([[97, 97]], np.int32))
    for backend in ("cpu", "device"):
        tok.backend = backend
        assert tok.encode("aaaa") == [256, 256], backend
        assert tok.encode("aaa") == [256, 97], backend


def test_special_tokens(trained):
    tok = Tokenizer(merges=trained.merges)
    tok.register_special_tokens({"<|eot|>": 1000, "<|sot|>": 1001})
    text = "<|sot|>hello world<|eot|>"
    with pytest.raises(EncodeError):
        tok.encode(text)  # none_raise default
    ids = tok.encode(text, allowed_special="all")
    assert ids[0] == 1001 and ids[-1] == 1000
    assert tok.decode(ids) == text
    # partial allowance: only eot recognized
    ids2 = tok.encode(text, allowed_special={"<|eot|>"})
    assert ids2[-1] == 1000 and 1001 not in ids2


def test_special_id_collision_rejected(trained):
    tok = Tokenizer(merges=trained.merges)
    with pytest.raises(EncodeError):
        tok.register_special_tokens({"<|bad|>": 10})


def test_regex_pretokenizer_parity():
    """Our regex chunking must reproduce the reference apply_regex
    (base.py:56-58) output on mixed text."""
    import regex as re

    from shredword_tpu import pretokenize
    pattern = re.compile(
        r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}"""
        r"""| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+""")
    text = ("Hello WORLD'S we've 12345 test...  \n\nnew-line\ttabs   "
            "it'll o'clock 世界 🙂 x")
    assert pretokenize.regex_split(text, "gpt") == re.findall(pattern, text)
    assert "".join(pretokenize.regex_split(text, "gpt")) == text


def test_regex_backend_roundtrip(trained):
    tok = Tokenizer(merges=trained.merges, pattern="gpt")
    text = "The  quick brown fox, it'll jump!  \n1234 end"
    for backend in ("cpu", "device"):
        tok.backend = backend
        assert tok.decode(tok.encode(text)) == text, backend


def test_decode_errors(trained):
    tok = Tokenizer(merges=np.zeros((0, 2), np.int32))
    with pytest.raises(DecodeError):
        tok.decode_bytes([999])
    assert tok.decode([999], errors="replace") == "�"
    assert tok.decode_bytes([999], errors="ignore") == b""


def test_save_load_v1_roundtrip(trained, tmp_path):
    tok = Tokenizer(merges=trained.merges, pattern="gpt")
    tok.register_special_tokens({"<|eot|>": 9000})
    mp = str(tmp_path / "t.v1.model")
    tok.save(mp, str(tmp_path / "t.vocab"))
    tok2 = Tokenizer.load(mp)
    np.testing.assert_array_equal(tok2.merges, tok.merges)
    assert tok2.special_tokens == tok.special_tokens
    assert tok2.pattern == tok.pattern
    text = "round trip! <|eot|>"
    assert tok2.encode(text, allowed_special="all") == \
        tok.encode(text, allowed_special="all")


def test_load_binary_model(trained, tmp_path):
    from shredword_tpu import serialization
    mp = str(tmp_path / "t.model")
    serialization.write_model_binary(mp, trained.merges)
    tok = Tokenizer.load(mp)
    np.testing.assert_array_equal(tok.merges, trained.merges)
    text = "binary model load"
    assert tok.decode(tok.encode(text)) == text


def test_decode_vectorized_error_modes():
    from shredword_tpu.tokenizer import Tokenizer
    from shredword_tpu.errors import DecodeError
    import numpy as np
    import pytest
    tok = Tokenizer(merges=np.array([[104, 105]], np.int32))  # "hi"
    assert tok.decode_bytes([104, 105, 256]) == b"hihi"
    assert tok.decode_bytes(np.array([256, 33])) == b"hi!"
    with pytest.raises(DecodeError):
        tok.decode_bytes([256, 999], errors="strict")
    assert tok.decode_bytes([104, 999], errors="ignore") == b"h"
    assert tok.decode_bytes([999], errors="replace").decode() == "�"
    assert tok.decode_bytes([]) == b""
    # round-trip through the full id range
    text = "hello high hills"
    assert tok.decode(tok.encode(text)) == text


def test_encode_batch_tpu_single_dispatch_matches_per_text():
    from shredword_tpu.tokenizer import Tokenizer
    import numpy as np
    rng = np.random.default_rng(3)
    corpus = [" ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 5))
                       for _ in range(20)) for _ in range(8)] + ["", "a"]
    # train a tiny model on the joined text via the public API
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "c.txt")
        with open(p, "w") as f:
            f.write("\n".join(corpus))
        tok = Tokenizer.train(p, vocab_size=300, min_pair_freq=1)
    tok.backend = "device"
    batch = tok.encode_batch(corpus)
    single = [tok.encode(t) for t in corpus]
    assert batch == single


def test_tpu_encode_created_pair_preemption():
    """Merge-ORDER regression: a distant lowest-rank merge can CREATE a
    pair of intermediate rank that preempts an existing local rank
    minimum — so per-round selection must be the column's single
    lowest rank, not "all local minima".  Crafted from the minimal
    counterexample 'fhus': ranks us=0 < (h,US)=1 < fh=2; sequential
    greedy yields [f, h+US]; the unsound round yields [FH, US]."""
    import numpy as np
    from shredword_tpu import Tokenizer

    merges = np.array([[117, 115],        # 'us'      -> 256
                       [104, 256],        # 'h'+US    -> 257
                       [102, 104]],       # 'fh'      -> 258
                      np.int32)
    want = [102, 257]                     # f, h+US
    for backend in ("cpu", "device"):
        tok = Tokenizer(merges=merges, backend=backend)
        assert tok.encode("fhus") == want, backend


def test_tpu_encode_rank_order_fuzz(zipf_corpus_file):
    """Dense cpu-vs-device differential over real-corpus words (merge-ORDER
    coverage at realistic rank depth)."""
    import numpy as np
    from shredword_tpu import Tokenizer

    tok = Tokenizer.train(zipf_corpus_file, vocab_size=600,
                          min_pair_freq=5, character_coverage=0.9995,
                          backend="cpu", tie_break="faithful")
    words = open(zipf_corpus_file).read().split()[:3000]
    rng = np.random.default_rng(0)
    for _ in range(300):
        s = " ".join(rng.choice(words, int(rng.integers(1, 8))))
        tok.backend = "cpu"
        want = tok.encode(s)
        tok.backend = "device"
        assert tok.encode(s) == want, repr(s)
