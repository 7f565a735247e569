"""Regression tests for the round-2 advisor findings (ADVICE.md):

1. csrc/pretok.cpp cls_at must not index the codepoint-class table out
   of range on malformed UTF-8 (OOB heap read fixed by validating
   continuation bytes and clamping cp >= 0x110000).
2. encode_ops must not allocate a dense v*v rank table for big vocabs
   (hash-probe MergeTable path above DENSE_V_MAX, identical output).
4. bpe_hist.hist_train passes an EXPLICIT max_steps_per_call to the
   loop verbatim at any vocab.
"""

import numpy as np
import pytest

from shredword_tpu import pretokenize
from shredword_tpu.ops import bpe_hist, encode_ops


# ---------------------------------------------------------------------
# 1. malformed UTF-8 through the native GPT scanner
# ---------------------------------------------------------------------

MALFORMED = [
    b"\xf7\xbf\xbf\xbf",          # 4-byte lead beyond U+10FFFF (cp 0x1FFFFF)
    b"\xff\xfe\xfd",              # invalid lead bytes
    b"\x80\x81\x82",              # stray continuation bytes
    b"\xe2\x28\xa1",              # bad continuation in 3-byte seq
    b"\xf0\x9f",                  # truncated 4-byte seq at EOF
    b"\xc0\xaf",                  # overlong lead 0xC0
    b"\xf4\x90\x80\x80",          # cp 0x110000 (just past the table)
    b"hello \xf7\xbf\xbf\xbf world",
    b"a" * 5 + b"\xed\xa0\x80" + b"b" * 5,   # surrogate half
]


@pytest.mark.parametrize("data", MALFORMED)
def test_native_scanner_survives_malformed_utf8(data):
    starts = pretokenize.gpt_starts_bytes(data)
    # a valid split: strictly increasing starts beginning at 0, in range
    s = np.asarray(starts)
    assert len(s) >= 1 and s[0] == 0
    assert (np.diff(s) > 0).all()
    assert (s < len(data)).all()


def test_native_scanner_valid_text_unchanged():
    import regex as _re
    pat = _re.compile(pretokenize.PATTERN_GPT)
    s = "we'll buy 123 apples! ... \r\n  héllo wörld 🙂"
    assert pretokenize.gpt_split(s) == pat.findall(s)


# ---------------------------------------------------------------------
# 2. big-vocab encode uses the hash table, identical ids
# ---------------------------------------------------------------------

def test_encode_stream_hash_path_matches_dense():
    rng = np.random.default_rng(7)
    merges = [(97, 98), (256, 99), (100, 101), (257, 258), (259, 97)]
    merges = np.asarray(merges, np.int32)
    chunks = [b"abcde", b"ab", b"deabc", b"zzz", b"abcabcde"]
    flat = np.frombuffer(b"".join(chunks), np.uint8)
    lens = np.array([len(c) for c in chunks], np.int64)

    v_small = 256 + len(merges)          # dense path
    assert v_small <= encode_ops.DENSE_V_MAX
    v_big = encode_ops.DENSE_V_MAX * 2   # forces the hash path
    out_dense = encode_ops.encode_stream(flat, lens, merges, v_small)
    out_hash = encode_ops.encode_stream(flat, lens, merges, v_big)
    for a, b in zip(out_dense, out_hash):
        np.testing.assert_array_equal(a, b)


def test_get_table_selects_hash_above_threshold():
    merges = np.asarray([(97, 98)], np.int32)
    t_small = encode_ops._get_table(merges, 300, None)
    t_big = encode_ops._get_table(merges, encode_ops.DENSE_V_MAX + 1,
                                  None)
    assert not isinstance(t_small, encode_ops.MergeTable)
    assert isinstance(t_big, encode_ops.MergeTable)


# ---------------------------------------------------------------------
# 4. explicit max_steps_per_call reaches the table engine verbatim
# ---------------------------------------------------------------------

def _tiny_corpus():
    words = [b"aaab", b"ab", b"bba"]
    counts = np.array([5, 3, 2], np.int32)
    toks = np.concatenate([np.frombuffer(w, np.uint8).astype(np.int32)
                           for w in words])
    wid = np.repeat(np.arange(len(words), dtype=np.int32),
                    [len(w) for w in words])
    return toks, wid, counts


def test_hist_train_respects_explicit_steps_for_giant(monkeypatch):
    toks, wid, counts = _tiny_corpus()
    seen = []
    orig = bpe_hist.make_train_loop

    def spy(v, *, target_merges, max_steps):
        seen.append(max_steps)
        return orig(v, target_merges=target_merges, max_steps=max_steps)

    monkeypatch.setattr(bpe_hist, "make_train_loop", spy)
    # vocab > 4096: the cadence is the caller's, verbatim
    out = bpe_hist.hist_train(toks, wid, counts, target_merges=5000,
                              max_steps_per_call=64, _cache={})
    assert out is not None
    assert seen == [64]

    # default (None) keeps the engine's own cadence
    bpe_hist.hist_train(toks, wid, counts, target_merges=5000, _cache={})
    assert seen == [64, bpe_hist.STEPS_PER_CALL]


# ---------------------------------------------------------------------
# streaming corpus ingestion (bounded memory, >2 GiB files)
# ---------------------------------------------------------------------

def test_streaming_loader_matches_whole_buffer(tmp_path):
    import numpy as np
    from shredword_tpu.runtime.native import NativeCorpus
    rng = np.random.default_rng(3)
    words = ["w%d" % i for i in range(500)]
    path = tmp_path / "c.txt"
    with open(path, "w") as f:
        for _ in range(300):
            f.write(" ".join(rng.choice(words, 20)) + "\n")
    for fo in (False, True):
        a = NativeCorpus.from_file(str(path), faithful_order=fo).arrays()
        # tiny blocks force many boundary carries (4096 is the floor)
        b = NativeCorpus.from_file(str(path), faithful_order=fo,
                                   block_bytes=4096).arrays()
        np.testing.assert_array_equal(a.word_bytes, b.word_bytes)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.total_raw_bytes == b.total_raw_bytes
        assert a.total_occurrences == b.total_occurrences


def test_streaming_loader_token_bigger_than_block(tmp_path):
    from shredword_tpu.runtime.native import NativeCorpus
    path = tmp_path / "c.txt"
    with open(path, "w") as f:
        f.write("a " + "x" * 200000 + " b b\n")
    a = NativeCorpus.from_file(str(path)).arrays()
    b = NativeCorpus.from_file(str(path), block_bytes=70000).arrays()
    import numpy as np
    np.testing.assert_array_equal(a.word_bytes, b.word_bytes)
    np.testing.assert_array_equal(a.counts, b.counts)


# ---------------------------------------------------------------------
# >2 GiB stream windowing (review finding: must split, not raise)
# ---------------------------------------------------------------------

def test_encode_stream_windows_large_streams(monkeypatch):
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 110, int(rng.integers(1, 12))).tolist())
             for _ in range(4000)]
    flat = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int64)
    merges = np.asarray([(97, 98), (99, 100), (256, 101), (102, 257)],
                        np.int32)
    gbn = np.array([0, 7, 1500, 1501, 4000], np.int64)  # spans windows
    v = 256 + len(merges)
    want = encode_ops.encode_stream(flat, lens, merges, v, gbn)
    monkeypatch.setattr(encode_ops, "STREAM_WINDOW_BYTES", 4096)
    got = encode_ops.encode_stream(flat, lens, merges, v, gbn)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dedup_single_block_cell_cap(monkeypatch):
    """Huge unique sets must fall back to length buckets, not one tall
    block (review finding: unbounded [L, W] single block)."""
    calls = []
    orig = encode_ops._encode_all

    def spy(flat, lens, off, table, v, single_block=False):
        calls.append(single_block)
        return orig(flat, lens, off, table, v, single_block=single_block)

    monkeypatch.setattr(encode_ops, "_encode_all", spy)
    monkeypatch.setattr(encode_ops, "SINGLE_BLOCK_MAX_CELLS", 64)
    monkeypatch.setattr(encode_ops, "DEDUP_MIN_CHUNKS", 8)
    rng = np.random.default_rng(9)
    words = [b"ab", b"cd", b"abcd", b"ab"] * 64
    flat = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int64)
    merges = np.asarray([(97, 98)], np.int32)
    out = encode_ops.encode_stream(flat, lens, merges, 257)
    assert calls == [False]      # dedup ran, but bucketed
    assert len(out[0]) > 0


def test_loader_handles_unseekable_input(tmp_path):
    """ftell < 0 (pipes, /dev/stdin) must route to the streaming loader
    instead of allocating a (size_t)-1 buffer."""
    import os as _os
    import subprocess, sys
    fifo = str(tmp_path / "corpus.fifo")
    _os.mkfifo(fifo)
    code = (
        "from shredword_tpu.runtime.native import NativeCorpus\n"
        f"a = NativeCorpus.from_file({fifo!r}).arrays()\n"
        "assert a.n_words == 3 and a.total_occurrences == 5, a.n_words\n"
        "print('FIFO_OK')\n")
    env = dict(_os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    with open(fifo, "w") as f:
        f.write("x y x y z\n")
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0 and "FIFO_OK" in out, out
