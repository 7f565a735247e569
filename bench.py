"""Benchmark: device BPE training throughput vs the faithful CPU engine.

Prints the device it ran on, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline"}.

Metric: BPE training MB/s (raw corpus bytes / wall-clock of train()).
Baseline: the in-repo faithful engine (byte-identical to the reference
C++ trainer, docs/CONFORMANCE.md) on the same corpus and config on the
host CPU.  Needs an NVIDIA GPU: it exits non-zero when JAX finds none,
and any failed phase fails the run.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

VOCAB = 768
MIN_FREQ = 50
COVERAGE = 0.9999
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench")
CORPUS = os.path.join(WORK, "corpus.txt")
RAW_MB = 16


def make_corpus(path: str, raw_mb: int = RAW_MB, seed: int = 1234) -> None:
    """Deterministic zipf-ish corpus: ~100k distinct words, raw_mb MB."""
    if os.path.exists(path) and os.path.getsize(path) > raw_mb * 10**6 * 0.95:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    n_vocab = 100_000
    # synthetic word shapes: letter bigram chains, lengths 2..14
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lens = rng.randint(2, 15, n_vocab)
    words = ["".join(letters[rng.randint(0, 26, L)]) for L in lens]
    ranks = np.arange(1, n_vocab + 1)
    probs = 1.0 / ranks ** 1.05
    probs /= probs.sum()
    target = raw_mb * 10**6
    with open(path, "w") as f:
        written = 0
        while written < target:
            idx = rng.choice(n_vocab, size=20_000, p=probs)
            chunk_words = [words[i] for i in idx]
            line_len = 0
            parts = []
            for w in chunk_words:
                parts.append(w)
                line_len += len(w) + 1
                if line_len > 80:
                    parts.append("\n")
                    line_len = 0
                else:
                    parts.append(" ")
            s = "".join(parts)
            f.write(s)
            written += len(s)


def measure_faithful_engine() -> tuple[float, int]:
    """Baseline: in-repo faithful engine (same algorithm as the
    reference C++ trainer, byte-identical output)."""
    from shredword_tpu.runtime.native import FaithfulTrainer, NativeCorpus
    c = NativeCorpus.from_file(CORPUS, faithful_order=True)
    t = FaithfulTrainer(VOCAB, -1, COVERAGE, MIN_FREQ)
    t.load(c)
    t0 = time.perf_counter()
    n = t.train()
    dt = time.perf_counter() - t0
    t.free(); c.free()
    return dt, n


def _train(vocab: int, min_freq: int, coverage: float,
           engine: str = "auto"):
    from shredword_tpu.models.bpe import BPETrainer
    t = BPETrainer(target_vocab_size=vocab, unk_id=-1,
                   character_coverage=coverage, min_pair_freq=min_freq,
                   engine=engine)
    try:
        t.load_corpus(CORPUS)
        t0 = time.perf_counter()
        n = t.train()
        dt = time.perf_counter() - t0
    finally:
        t.destroy()
    return dt, n


def measure_device() -> tuple[float, int]:
    """Median of 3 warm runs (a first run compiles); all runs are
    reported on stderr."""
    _train(VOCAB, MIN_FREQ, COVERAGE)
    runs = [_train(VOCAB, MIN_FREQ, COVERAGE) for _ in range(3)]
    secs = sorted(dt for dt, _ in runs)
    sys.stderr.write("[bench] train runs: "
                     + " ".join(f"{s:.3f}s" for s in secs) + "\n")
    return secs[1], runs[0][1]


def check_device_engines() -> None:
    """Cross-check: the table and flat engines are independent device
    counting paths (maintained pair table; sort-based segment
    reduction) that must produce bit-identical models."""
    from shredword_tpu.models.bpe import BPETrainer
    outs = {}
    for eng in ("hist", "flat"):
        t = BPETrainer(target_vocab_size=VOCAB, unk_id=-1,
                       character_coverage=COVERAGE, min_pair_freq=MIN_FREQ,
                       engine=eng)
        t.load_corpus(CORPUS)
        t.train()
        mp = os.path.join(WORK, f"check_{eng}.model")
        vp = os.path.join(WORK, f"check_{eng}.vocab")
        t.save(mp, vp)
        t.destroy()
        with open(mp, "rb") as f, open(vp, "rb") as g:
            outs[eng] = (f.read(), g.read())
    if outs["hist"] != outs["flat"]:
        raise RuntimeError(
            "device engine cross-check FAILED: the engines disagree — "
            "the measured result cannot be trusted")
    sys.stderr.write("[bench] device engine cross-check: table == flat "
                     "(model+vocab bit-identical)\n")


def _median_mbs(fn, nbytes: float, trials: int = 3) -> float:
    """Steady-state MB/s: median of `trials` (the first call is warm
    already)."""
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return nbytes / 1e6 / sorted(times)[len(times) // 2]


def measure_encode() -> dict:
    """Encode/decode MB/s on a trained model (BASELINE.md config 3: cpu
    native encode, device whole-text + batch encode, and the vectorized
    decode; array API)."""
    from shredword_tpu import Tokenizer
    tok = Tokenizer.train(CORPUS, vocab_size=VOCAB, min_pair_freq=MIN_FREQ,
                          character_coverage=COVERAGE, backend="cpu",
                          tie_break="faithful")
    with open(CORPUS) as f:
        text = f.read(4 * 10**6)
    nbytes = len(text.encode())
    ids = tok.encode_array(text)             # warm
    cpu_mbs = _median_mbs(lambda: tok.encode_array(text), nbytes)

    if tok.decode(ids) != text:
        raise RuntimeError("decode round trip failed")
    dec_mbs = _median_mbs(lambda: tok.decode(ids), nbytes)

    tok.backend = "device"
    dev_ids = tok.encode_array(text)         # warm-up: compile
    if not np.array_equal(np.asarray(dev_ids, np.int64),
                          np.asarray(ids, np.int64)):
        raise RuntimeError("device encode differs from the cpu encoder")
    dev_mbs = _median_mbs(lambda: tok.encode_array(text), nbytes)

    # batch encode: the text split into document-sized pieces
    docs = [text[i:i + 65536] for i in range(0, len(text), 65536)]
    dev_batch = tok.encode_batch_arrays(docs)   # warm-up: compile
    dev_batch_mbs = _median_mbs(lambda: tok.encode_batch_arrays(docs),
                                nbytes)
    if "".join(tok.decode(d) for d in dev_batch) != "".join(docs):
        raise RuntimeError("batch decode round trip failed")
    return {"cpu_mbs": cpu_mbs, "dev_mbs": dev_mbs,
            "dev_batch_mbs": dev_batch_mbs, "dec_mbs": dec_mbs,
            "n_ids": len(ids)}


def measure_vocab_32k() -> dict:
    """32k-vocab train on the bench corpus (BASELINE config 2's vocab at
    bench scale): one run to compile, then one measured run."""
    _train(32768, 2, 1.0)
    dt, n = _train(32768, 2, 1.0)
    mb = os.path.getsize(CORPUS) / 1e6
    return {"merges": n, "seconds": dt, "mbs": mb / dt,
            "ms_per_merge": dt / max(n, 1) * 1000}


def measure_unigram() -> dict:
    """Train a 1,024-piece unigram LM on the 16 MB bench corpus and
    measure device-Viterbi encode MB/s on 1 MB of it."""
    from shredword_tpu import UnigramTokenizer, UnigramTrainer
    t = UnigramTrainer(target_vocab_size=1024, seed_size=10_000)
    t.load_corpus(CORPUS)
    t0 = time.perf_counter()
    n = t.train()
    train_s = time.perf_counter() - t0
    model = os.path.join(WORK, "uni.model")
    t.save(model)
    tok = UnigramTokenizer.load(model)
    with open(CORPUS) as f:
        text = f.read(10**6)
    nb = len(text.encode())
    ids = tok.encode_array(text)             # warm
    enc_mbs = _median_mbs(lambda: tok.encode_array(text), nbytes=nb)
    return {"vocab": n, "train_s": train_s,
            "train_mbs": os.path.getsize(CORPUS) / 1e6 / train_s,
            "enc_mbs": enc_mbs, "n_ids": len(ids),
            "final_ll": t.final_ll}


def measure_unigram_default() -> dict:
    """Unigram at its DEFAULT config: 8,192 pieces, seed 100k on the
    16 MB corpus, with quality metrics — final corpus log-likelihood
    (total and per word occurrence) and pieces-per-word on a 1 MB
    sample."""
    from shredword_tpu import UnigramTokenizer, UnigramTrainer
    t = UnigramTrainer(target_vocab_size=8192, seed_size=100_000)
    t.load_corpus(CORPUS)
    t0 = time.perf_counter()
    n = t.train()
    train_s = time.perf_counter() - t0
    model = os.path.join(WORK, "uni_default.model")
    t.save(model)
    tok = UnigramTokenizer.load(model)
    with open(CORPUS) as f:
        text = f.read(10**6)
    ids = tok.encode_array(text)
    n_words = max(text.count(" ") + text.count("\n") + 1, 1)
    return {"vocab": n, "train_s": train_s,
            "train_mbs": os.path.getsize(CORPUS) / 1e6 / train_s,
            "final_ll": t.final_ll,
            "ll_per_word": t.final_ll_per_word,
            "pieces_per_word": len(ids) / n_words}


def measure_presplit() -> dict:
    """GPT-pattern pre-split MB/s: the native host scanner vs the
    in-repo device DFA (ops/pretok_ops.gpt_starts_device); both must
    give the same chunk starts."""
    from shredword_tpu import pretokenize
    from shredword_tpu.ops import pretok_ops
    with open(CORPUS) as f:
        text = f.read(8 * 10**6)
    data = text.encode()
    nb = len(data) / 1e6
    cp = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    pretokenize.gpt_starts_bytes(data[:1000])     # class table warm-up
    t_native = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        starts = np.asarray(pretokenize.gpt_starts_bytes(data))
        t_native = min(t_native, time.perf_counter() - t0)
    dev_starts = pretok_ops.gpt_starts_device(cp)  # compile
    t_dev = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        dev_starts = np.asarray(pretok_ops.gpt_starts_device(cp))
        t_dev = min(t_dev, time.perf_counter() - t0)
    # device starts are codepoint offsets: map them to utf-8 bytes
    nbytes = 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000)
    byte_at = np.concatenate([[0], np.cumsum(nbytes)])
    if not np.array_equal(byte_at[dev_starts], starts):
        raise RuntimeError("pre-split parity failure: native != device")
    return {"native": nb / t_native, "device": nb / t_dev}


def main() -> int:
    from chip_smoke import card_line
    from shredword_tpu import device
    dev = device.describe()
    card = card_line() if dev["platform"] == "gpu" else "no GPU"
    sys.stderr.write(f"[bench] device {dev}; card {card}\n")
    if dev["platform"] != "gpu":
        sys.stderr.write("[bench] needs an NVIDIA GPU; JAX finds none\n")
        return 1
    make_corpus(CORPUS)
    raw_bytes = os.path.getsize(CORPUS)

    ref_dt, ref_n = measure_faithful_engine()
    dev_dt, dev_n = measure_device()
    check_device_engines()

    mb = raw_bytes / 1e6
    ours = mb / dev_dt
    base = mb / ref_dt
    sys.stderr.write(
        f"[bench] corpus {mb:.1f} MB; faithful cpu: {ref_dt:.2f}s "
        f"({ref_n} merges, {base:.1f} MB/s); device: {dev_dt:.2f}s "
        f"({dev_n} merges, {ours:.1f} MB/s)\n")
    pre = measure_presplit()
    sys.stderr.write(
        f"[bench] gpt pre-split: native {pre['native']:.1f} MB/s, device "
        f"DFA {pre['device']:.1f} MB/s (output identical)\n")
    e = measure_encode()
    sys.stderr.write(
        f"[bench] encode: cpu native {e['cpu_mbs']:.1f} MB/s "
        f"({e['n_ids']} ids, round-trip exact), device whole-text "
        f"{e['dev_mbs']:.1f} MB/s, device batch "
        f"{e['dev_batch_mbs']:.1f} MB/s; decode {e['dec_mbs']:.1f} MB/s\n")
    u = measure_unigram()
    sys.stderr.write(
        f"[bench] unigram: {u['vocab']}-piece LM trained on the "
        f"16 MB corpus in {u['train_s']:.1f}s "
        f"({u['train_mbs']:.2f} MB/s, final LL {u['final_ll']:.6g}); "
        f"viterbi encode {u['enc_mbs']:.1f} MB/s ({u['n_ids']} ids)\n")
    u = measure_unigram_default()
    sys.stderr.write(
        f"[bench] unigram DEFAULT config (8192 pieces, seed 100k, "
        f"16 MB): {u['train_s']:.0f}s ({u['train_mbs']:.2f} MB/s); "
        f"final corpus LL {u['final_ll']:.4g} "
        f"({u['ll_per_word']:.3f}/word), "
        f"{u['pieces_per_word']:.2f} pieces/word\n")
    g = measure_vocab_32k()
    sys.stderr.write(
        f"[bench] 32k-vocab train: {g['merges']} merges in "
        f"{g['seconds']:.1f}s — {g['mbs']:.1f} MB/s, "
        f"{g['ms_per_merge']:.2f} ms/merge\n")
    sys.stderr.write(f"[bench] card {card}\n")
    print(json.dumps({
        "metric": "train_mb_s",
        "value": round(ours, 2),
        "unit": "MB/s",
        "vs_baseline": round(ours / base, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
