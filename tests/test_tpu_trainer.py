"""Differential tests of the device (JAX) trainer against independent
oracles.

Oracle 1: a transparent numpy implementation of greedy lex-tie-break BPE
(written here, trivially auditable) — the device trainer must match it
*exactly*, merge for merge.
Oracle 2: the faithful CPU engine — merge frequency sequences must agree
wherever the greedy choice is unique (ties may reorder, never change
counts at the moment of choice... they can later; so we compare only up
to the first equal-frequency tie).
Oracle 3: merge *application* parity — replaying the faithful engine's
merge sequence through the device apply path must reproduce the faithful
engine's final token stream bit-for-bit.
"""

import numpy as np
import pytest

from shredword_tpu.runtime.native import FaithfulTrainer, NativeCorpus


# ---------------------------------------------------------------------------
# numpy oracle: greedy BPE, lexicographic tie-break, exact counts
# ---------------------------------------------------------------------------

def numpy_bpe(words, counts, unk_id, min_pair_freq, target_merges):
    """words: list[list[int]] token lists; returns (merges, freqs)."""
    words = [list(w) for w in words]
    merges, freqs = [], []
    while len(merges) < target_merges:
        stats = {}
        for w, c in zip(words, counts):
            for a, b in zip(w, w[1:]):
                if a == unk_id or b == unk_id:
                    continue
                stats[(a, b)] = stats.get((a, b), 0) + c
        eligible = {p: f for p, f in stats.items() if f >= min_pair_freq}
        if not eligible:
            break
        best = max(eligible.items(), key=lambda kv: (kv[1], [-kv[0][0], -kv[0][1]]))
        (a, b), f = best
        new_id = 256 + len(merges)
        merges.append((a, b))
        freqs.append(f)
        for wi, w in enumerate(words):
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
    return merges, freqs, words


def _corpus_to_words(arrays, keep, unk_id):
    words = []
    for i in range(arrays.n_words):
        w = arrays.word_bytes[arrays.offsets[i]:arrays.offsets[i + 1]]
        words.append([int(c) if keep[c] else unk_id for c in w])
    return words, [int(c) for c in arrays.counts]


@pytest.fixture(scope="module")
def small_setup(tmp_path_factory):
    from golden.corpus_gen import small_corpus
    p = tmp_path_factory.mktemp("c") / "small.txt"
    p.write_text(small_corpus())
    return str(p)


def test_tpu_trainer_matches_numpy_oracle(small_setup):
    from shredword_tpu.models.bpe import BPETrainer

    t = BPETrainer(target_vocab_size=300, unk_id=-1,
                   character_coverage=0.995, min_pair_freq=2,
                   tie_break="lex", backend="device")
    t.load_corpus(small_setup)
    n = t.train()
    assert n > 0

    corpus = NativeCorpus.from_file(small_setup)
    arrays = corpus.arrays()
    keep, _, _ = corpus.coverage(0.995)
    words, counts = _corpus_to_words(arrays, keep, -1)
    merges, freqs, final_words = numpy_bpe(words, counts, -1, 2, 300 - 256)

    assert n == len(merges)
    np.testing.assert_array_equal(t.merges, np.array(merges, np.int32))
    np.testing.assert_array_equal(t.merge_freqs, np.array(freqs))


def test_tpu_trainer_matches_numpy_oracle_zipf(tmp_path):
    from golden.corpus_gen import zipf_corpus

    from shredword_tpu.models.bpe import BPETrainer

    p = tmp_path / "z.txt"
    text = zipf_corpus(n_lines=3000, seed=7)
    p.write_text(text)

    t = BPETrainer(target_vocab_size=400, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   tie_break="lex", backend="device")
    t.load_corpus(str(p))
    n = t.train()

    corpus = NativeCorpus.from_file(str(p))
    arrays = corpus.arrays()
    keep, _, _ = corpus.coverage(0.9995)
    words, counts = _corpus_to_words(arrays, keep, -1)
    merges, freqs, _ = numpy_bpe(words, counts, -1, 5, 400 - 256)

    assert n == len(merges)
    np.testing.assert_array_equal(t.merges, np.array(merges, np.int32))
    np.testing.assert_array_equal(t.merge_freqs, np.array(freqs))


def test_merge_apply_parity_with_faithful_engine(small_setup):
    """Replay the faithful engine's merge sequence through the device
    apply path; final token streams must be identical."""
    import jax.numpy as jnp

    from shredword_tpu.ops import bpe_ops

    corpus = NativeCorpus.from_file(small_setup, faithful_order=True)
    ft = FaithfulTrainer(300, -1, 0.995, 2)
    ft.load(corpus)
    ft.train()
    ref_tokens, ref_wids = ft.tokens()
    merges = ft.merges()

    arrays = corpus.arrays()
    keep, _, _ = corpus.coverage(0.995)
    tokens = arrays.word_bytes.astype(np.int32)
    tokens[~keep[arrays.word_bytes]] = -1
    lengths = np.diff(arrays.offsets)
    word_id = np.repeat(np.arange(arrays.n_words, dtype=np.int32), lengths)
    wcount = arrays.counts.astype(np.int32)[word_id]

    cap = 1 << int(np.ceil(np.log2(max(len(tokens), 2))))
    state = bpe_ops.make_state(tokens, word_id, wcount, cap)
    for m, (a, b) in enumerate(merges):
        state, _ = bpe_ops.apply_merge(state, jnp.int32(a), jnp.int32(b),
                                       jnp.int32(256 + m))
    L = int(state.length)
    np.testing.assert_array_equal(np.asarray(state.tokens)[:L], ref_tokens)
    np.testing.assert_array_equal(np.asarray(state.word_id)[:L], ref_wids)
    ft.free()


def test_overlap_run_semantics():
    """'aaaa' + (a,a): greedy left-to-right -> [X, X]; 'aaa' -> [X, a]."""
    import jax.numpy as jnp

    from shredword_tpu.ops import bpe_ops

    tokens = np.array([97, 97, 97, 97, 97, 97, 97], np.int32)  # aaaa | aaa
    word_id = np.array([0, 0, 0, 0, 1, 1, 1], np.int32)
    wcount = np.ones(7, np.int32)
    state = bpe_ops.make_state(tokens, word_id, wcount, 8)
    state, _ = bpe_ops.apply_merge(state, jnp.int32(97), jnp.int32(97),
                                   jnp.int32(256))
    L = int(state.length)
    np.testing.assert_array_equal(np.asarray(state.tokens)[:L],
                                  [256, 256, 256, 97])
    np.testing.assert_array_equal(np.asarray(state.word_id)[:L], [0, 0, 1, 1])


def test_save_formats_roundtrip(small_setup, tmp_path):
    from shredword_tpu import serialization
    from shredword_tpu.models.bpe import BPETrainer

    t = BPETrainer(target_vocab_size=300, unk_id=-1,
                   character_coverage=0.995, min_pair_freq=2)
    t.load_corpus(small_setup)
    t.train()
    mp, vp = str(tmp_path / "m.model"), str(tmp_path / "v.vocab")
    t.save(mp, vp)
    merges = serialization.read_model_binary(mp)
    np.testing.assert_array_equal(merges, t.merges)

    v1 = str(tmp_path / "m.v1.model")
    serialization.write_model_v1(v1, t.merges, pattern="",
                                 special_tokens={"<|eot|>": 1000})
    m2, pattern, special = serialization.read_model_v1(v1)
    np.testing.assert_array_equal(m2, t.merges)
    assert special == {"<|eot|>": 1000}


def test_engine_giant_selector(zipf_corpus_file):
    """engine='giant' forces the table engine at any vocab and stays
    bit-identical to the flat engine."""
    import numpy as np
    from shredword_tpu.models.bpe import BPETrainer

    a = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", engine="giant")
    a.load_corpus(zipf_corpus_file)
    na = a.train()
    b = BPETrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="device", engine="flat")
    b.load_corpus(zipf_corpus_file)
    assert b.train() == na > 0
    np.testing.assert_array_equal(a.merges, b.merges)
    np.testing.assert_array_equal(a.token_frequencies(),
                                  b.token_frequencies())
