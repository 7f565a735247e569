"""GPT-pattern pre-tokenizer (ops/pretok_ops.py + csrc/pretok.cpp):
differential conformance of BOTH fast paths against the regex module
(BASELINE config 4: "parity vs regex module output").

Run as a script, this module regenerates the shipped codepoint class
table (shredword_tpu/ops/gpt_classes.npz) from the regex module:
``python tests/test_pretok_dfa.py``.
"""

import numpy as np
import pytest
import regex as _re

from shredword_tpu import pretokenize
from shredword_tpu.ops import pretok_ops

PAT = _re.compile(pretokenize.PATTERN_GPT)


def build_class_table() -> np.ndarray:
    """Classify every codepoint with the regex module itself — the
    ground truth the shipped run-length table is generated from."""
    P = pretok_ops
    table = np.zeros(P.MAX_CP, np.int8)
    all_cps = "".join(
        chr(c) for c in range(P.MAX_CP)
        if not (0xD800 <= c <= 0xDFFF))          # surrogates unencodable
    cps = np.frombuffer(all_cps.encode("utf-32-le"), np.uint32)

    def hits(pattern):
        h = np.zeros(len(cps), bool)
        for m in _re.finditer(pattern, all_cps):
            h[m.start():m.end()] = True
        return h

    table[cps[hits(r"\s")]] = P.C_WS
    table[cps[hits(r"\p{N}")]] = P.C_DIGIT
    letter = hits(r"\p{L}")
    table[cps[letter]] = P.C_LETTER
    for pat, cls in ((r"s", P.C_S), (r"d", P.C_D), (r"m", P.C_M),
                     (r"t", P.C_T), (r"l", P.C_L), (r"v", P.C_V),
                     (r"r", P.C_R), (r"e", P.C_E)):
        sel = hits(f"(?i:{pat})") & letter
        table[cps[sel]] = cls
    table[ord(" ")] = P.C_SPACE
    table[ord("\r")] = P.C_CR
    table[ord("\n")] = P.C_LF
    table[ord("'")] = P.C_APO
    return table


def test_shipped_class_table_matches_regex_module():
    np.testing.assert_array_equal(pretok_ops.class_table(),
                                  build_class_table())

CASES = [
    "hello world", "we'll they've it's can't o'clock", "'ll 'Ve 'S",
    " 'll", "\t'll", "''ll", "!'s", "x'lx", "'l", "'sx", "1234567",
    "a1234b", "abc!!def", "!word", "!!word", " !", " !\n\nx", "x\ny",
    "x  \ny", "hi  there", "hi ", "x  ", " \n", " \n \n  a", "a   b",
    "...", "a...b", "héllo wörld", "日本語のテキスト", "ſtop'ſ",
    "tab\there", "mixed 123abc !@# \r\n done", "\r", "\n\n\n",
    "a\r\nb", "!?\r\nx", "  leading", "trailing  ", "'", "''", "' ",
    "don't stop believing", "1'll", "½¾⅓ nums ٣٤٥", "Ａｂｃ", "ǅungla",
    "price: $5.99!", "'re're", " ", "x", "🙂 emoji !", "под вопросом",
]


@pytest.mark.parametrize("s", CASES)
def test_vectorized_matches_regex(s):
    assert pretok_ops.gpt_split_str(s) == PAT.findall(s)


@pytest.mark.parametrize("s", CASES)
def test_native_matches_regex(s):
    assert pretokenize.gpt_split(s) == PAT.findall(s)


def test_fuzz_both_paths():
    rng = np.random.default_rng(5)
    alphabet = list("abcsSDMTLVRE 'AB12890!?.\t\r\n\x0b") + [
        chr(c) for c in (0x85, 0xA0, 0x2028, 0x3000, 0x17F, 0x660,
                         0x4E00, 0x1F600, 0xBC)]
    for _ in range(150):
        s = "".join(rng.choice(alphabet)
                    for _ in range(int(rng.integers(0, 80))))
        want = PAT.findall(s)
        assert pretok_ops.gpt_split_str(s) == want, repr(s)
        if s:
            assert pretokenize.gpt_split(s) == want, repr(s)


def test_regex_split_routes_gpt_to_native():
    # the public chunking entry point must produce identical output
    s = "we'll buy 123 apples!\n  next line"
    assert pretokenize.regex_split(s, "gpt") == PAT.findall(s)
    assert pretokenize.regex_split(s) == PAT.findall(s)


def test_starts_bytes_offsets_are_utf8_boundaries():
    s = "héllo wörld 🙂!"
    data = s.encode()
    starts = pretokenize.gpt_starts_bytes(data)
    bounds = list(starts) + [len(data)]
    chunks = [data[bounds[i]:bounds[i + 1]].decode("utf-8")
              for i in range(len(starts))]   # raises if mid-codepoint
    assert "".join(chunks) == s


def test_chunk_lens_bytes_cover_stream():
    data = "we'll buy 123 apples!\n  next ſ line 🙂".encode()
    lens = pretok_ops.gpt_chunk_lens_bytes(data)
    assert int(lens.sum()) == len(data)


def test_tokenizer_gpt_pattern_encode_matches_regex_chunking():
    from shredword_tpu.tokenizer import Tokenizer
    merges = np.array([[104, 101], [32, 119]], np.int32)   # "he", " w"
    text = "he said we'll win 100 games!\n  heh"
    for backend in ("cpu", "device"):
        tok = Tokenizer(merges=merges, pattern="gpt", backend=backend)
        got = tok.encode(text)
        # oracle: regex chunking + per-chunk cpu encode
        tok2 = Tokenizer(merges=merges, pattern="gpt", backend="cpu")
        chunks = [c.encode() for c in PAT.findall(text)]
        want = tok2._encode_chunks_cpu(chunks).tolist()
        assert got == want, backend
    # round trip
    tok = Tokenizer(merges=merges, pattern="gpt")
    assert tok.decode(tok.encode(text)) == text


@pytest.mark.parametrize("s", CASES)
def test_device_splitter_matches_host(s):
    cp = np.frombuffer(s.encode("utf-32-le"), np.uint32)
    want = pretok_ops.gpt_starts(cp).tolist()
    assert pretok_ops.gpt_starts_device(cp).tolist() == want


def test_device_splitter_fuzz():
    rng = np.random.default_rng(17)
    alphabet = list("abcsSDMTLVRE 'AB12890!?.\t\r\n\x0b") + [
        chr(c) for c in (0x85, 0xA0, 0x2028, 0x3000, 0x17F, 0x660,
                         0x4E00, 0x1F600, 0xBC)]
    for _ in range(120):
        s = "".join(rng.choice(alphabet)
                    for _ in range(int(rng.integers(1, 120))))
        cp = np.frombuffer(s.encode("utf-32-le"), np.uint32)
        want = pretok_ops.gpt_starts(cp).tolist()
        got = pretok_ops.gpt_starts_device(cp).tolist()
        assert got == want, repr(s)


if __name__ == "__main__":
    t = build_class_table()
    starts = np.concatenate([[0], np.nonzero(np.diff(t))[0] + 1])
    np.savez_compressed(pretok_ops.TABLE_PATH,
                        starts=starts.astype(np.int32), classes=t[starts])
    print(f"wrote {len(starts)} runs to {pretok_ops.TABLE_PATH}")
