"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py            # one card: phases 0-5
    python chip_smoke.py --cards 4  # four cards: the sharded path only

One card, through the public API, on the seeded 16 MB bench corpus
(bench.make_corpus, seed 1234):

  0. the card's name and power limit (nvidia-smi), then a fresh-process
     CLI train (2 MB slice, vocab 400) twice: cold, then warm on the
     persistent compile cache — before this process imports JAX;
  1. JAX's device must be a GPU;
  2. BPETrainer at the bench's 768 config: engine="auto", "flat" and
     "hist" (the table engine) on the GPU; merges, freqs and the saved
     .model/.vocab bytes equal a run on the CPU device;
  3. the 32768 config: flat and table engines on the GPU agree exactly
     and their first 512 merges equal a CPU run;
  4. Tokenizer(backend="device") on the phase-3 model: ids equal the
     native CPU encoder's (4 MB whole text, 64 KB documents) and decode
     round-trips;
  5. UnigramTrainer (1024 pieces, seed 10k): one device E-step against
     the host numpy E-step, then training to the end.

Four cards: BPETrainer(shards=4) at the 32768 config equals the one-card
run, and UnigramTrainer on a 4-device mesh matches one card.

Counts are integers, so BPE results must be equal exactly.  The CPU
reference runs the table engine compiled for the CPU: the flat engine
there sorts the whole stream every merge, about 0.8 s per merge on this
corpus, so 2 x 512 CPU merges would not fit the smoke test's time.  The
GPU flat engine — the independent algorithm — is held to the GPU table
engine and through it to the CPU run.  A merge sequence does not depend
on the target vocab, so the 32768 prefix is checked against a
768-vocab CPU run.  The Unigram
E-step sums float32 on the GPU in another order than the host's float64
numpy sums, so counts are held to rtol 1e-4 and the log likelihood to
rtol 1e-5.

Any failed check raises: the script then exits non-zero and prints no
"ok" line.  The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".bench")
CORPUS = os.path.join(WORK, "corpus.txt")
V768 = dict(vocab=768, min_pair_freq=50, coverage=0.9999)     # bench.py
V32K = dict(vocab=32768, min_pair_freq=2, coverage=1.0)
CPU_PREFIX_MERGES = 512
UNI_RTOL_COUNTS = 1e-4
UNI_RTOL_LL = 1e-5


def card_line() -> str:
    """`nvidia-smi` name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"FAILED: {what}")
    log(f"  ok: {what}")


# ---------------------------------------------------------------------
# phase 0: no JAX in this process yet
# ---------------------------------------------------------------------

def phase0_cli(card: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "_shred_build", os.path.join(ROOT, "shredword_tpu", "runtime",
                                     "build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build()                 # native runtime: set-up, not timed
    small = os.path.join(WORK, "cli_2mb.txt")
    with open(CORPUS, "rb") as f, open(small, "wb") as g:
        g.write(f.read(2 * 10**6))
    env = dict(os.environ, JAX_PLATFORMS="cuda",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        ROOT, ".jax_cache")
    log(f"[0] CLI train, 2 MB slice, vocab 400 (compile cache {cache}, "
        f"{'present' if os.path.isdir(cache) else 'absent'} before)")
    models = []
    for label in ("cold", "warm"):
        model = os.path.join(WORK, f"cli_{label}.model")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "shredword_tpu", "train", "--corpus",
             small, "--model", model, "--vocab-size", "400",
             "--min-pair-freq", "2"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if p.returncode != 0:
            raise RuntimeError(f"CLI train ({label}) failed:\n"
                               f"{p.stderr[-3000:]}")
        log(f"  CLI train {label} process: {dt:.3f} s  [{card}]")
        with open(model, "rb") as f:
            models.append(f.read())
    check(models[0] == models[1], "cold and warm CLI models identical")


# ---------------------------------------------------------------------
# phases 1-5
# ---------------------------------------------------------------------

def bpe_run(cfg: dict, engine: str, tag: str, shards: int = 0):
    """Train + save through the public API; returns (trainer outputs,
    seconds of train())."""
    from shredword_tpu import BPETrainer
    t = BPETrainer(target_vocab_size=cfg["vocab"], unk_id=-1,
                   character_coverage=cfg["coverage"],
                   min_pair_freq=cfg["min_pair_freq"], engine=engine,
                   shards=shards)
    t.load_corpus(CORPUS)
    t0 = time.perf_counter()
    n = t.train()
    dt = time.perf_counter() - t0
    mp = os.path.join(WORK, f"{tag}.model")
    vp = os.path.join(WORK, f"{tag}.vocab")
    t.save(mp, vp)
    t.destroy()
    with open(mp, "rb") as f, open(vp, "rb") as g:
        out = dict(n=n, merges=t.merges.copy(), freqs=t.merge_freqs.copy(),
                   model=f.read(), vocab=g.read(), path=mp)
    return out, dt


def on_cpu(fn, *a, **k):
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        return fn(*a, **k)


def same_bpe(x: dict, y: dict, what: str, files: bool = True) -> None:
    import numpy as np
    check(x["n"] == y["n"]
          and np.array_equal(x["merges"], y["merges"])
          and np.array_equal(x["freqs"], y["freqs"]),
          f"{what}: merges and freqs equal ({x['n']} merges)")
    if files:
        check(x["model"] == y["model"] and x["vocab"] == y["vocab"],
              f"{what}: .model and .vocab bytes equal")


def timed_engines(cfg: dict, tag: str, card: str, runs: int) -> dict:
    """flat and table engines on the GPU, `runs` times each; prints
    every time (the first includes compilation)."""
    mb = os.path.getsize(CORPUS) / 1e6
    res = {}
    for engine in ("flat", "hist"):
        times = []
        for r in range(runs):
            out, dt = bpe_run(cfg, engine, f"{tag}_{engine}")
            times.append(dt)
        res[engine] = out
        log(f"  vocab {cfg['vocab']} {engine:5s} engine train(): "
            + ", ".join(f"{t:.3f} s" for t in times)
            + f"  (last {mb / times[-1]:.2f} MB/s, {out['n']} merges)"
              f"  [{card}]")
    return res


def phase2_768(card: str) -> None:
    from shredword_tpu.models import bpe as bpe_model
    log("[2] BPE 768 config")
    mb = os.path.getsize(CORPUS) / 1e6
    ref, _ = on_cpu(bpe_run, V768, "hist", "v768_cpu")
    bpe_run(V768, "auto", "v768_auto")                 # compile
    auto, dt = bpe_run(V768, "auto", "v768_auto")
    routed = "table" if bpe_model._use_table_engine(
        "auto", V768["vocab"]) else "flat"
    log(f"  auto ({routed}) warm train(): {dt:.3f} s, {mb / dt:.2f} MB/s "
        f"on {mb:.2f} MB  [{card}]")
    same_bpe(auto, ref, "768 auto GPU vs CPU")
    res = timed_engines(V768, "v768", card, runs=2)
    same_bpe(res["flat"], ref, "768 flat GPU vs CPU")
    same_bpe(res["hist"], ref, "768 table GPU vs CPU")


def phase3_32k(card: str) -> str:
    import jax
    import numpy as np
    log("[3] BPE 32768 config")
    res = timed_engines(V32K, "v32k", card, runs=1)
    same_bpe(res["hist"], res["flat"], "32768 table vs flat on GPU")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}  [{card}]")
    k = CPU_PREFIX_MERGES
    ref, _ = on_cpu(bpe_run, dict(V32K, vocab=256 + k), "hist",
                    "v32k_cpu")
    check(ref["n"] == k
          and np.array_equal(res["flat"]["merges"][:k], ref["merges"])
          and np.array_equal(res["flat"]["freqs"][:k], ref["freqs"]),
          f"32768 first {k} GPU merges equal the CPU run")
    return res["flat"]["path"]


def phase4_encode(model: str, card: str) -> None:
    import numpy as np
    from shredword_tpu import Tokenizer
    log("[4] encode/decode with the 32768 model")
    with open(CORPUS, encoding="utf-8") as f:
        text = f.read(4 * 10**6)
    nb = len(text.encode()) / 1e6
    dev = Tokenizer.load(model, backend="device")
    cpu = Tokenizer.load(model, backend="cpu")
    want = cpu.encode_array(text)
    dev.encode_array(text)                                  # compile
    t0 = time.perf_counter()
    got = dev.encode_array(text)
    dt = time.perf_counter() - t0
    check(np.array_equal(got, want),
          f"device encode_array ids equal the native encoder "
          f"({len(want)} ids)")
    check(dev.decode(got) == text, "decode round-trips the 4 MB text")
    log(f"  device encode_array warm: {dt:.3f} s, {nb / dt:.2f} MB/s  "
        f"[{card}]")
    docs = [text[i:i + 65536] for i in range(0, len(text), 65536)]
    dev.encode_batch_arrays(docs)                           # compile
    t0 = time.perf_counter()
    got = dev.encode_batch_arrays(docs)
    dt = time.perf_counter() - t0
    check(all(np.array_equal(g, cpu.encode_array(d))
              for g, d in zip(got, docs)),
          f"device encode_batch_arrays ids equal the native encoder "
          f"({len(docs)} docs)")
    check(all(dev.decode(g) == d for g, d in zip(got, docs)),
          "batch decode round-trips every document")
    log(f"  device encode_batch_arrays warm: {dt:.3f} s, "
        f"{nb / dt:.2f} MB/s  [{card}]")


def unigram_estep(trainer):
    """One E-step at the seed piece set, as train() starts it."""
    import numpy as np
    pieces, counts = trainer._seed()
    freq = counts.astype(np.float64)
    logp = np.log(freq / freq.sum())
    return trainer._e_step(pieces, logp)


def same_estep(got, want, what: str) -> None:
    import numpy as np
    (c1, ll1), (c0, ll0) = got, want
    rel = np.abs(c1 - c0) / np.maximum(np.abs(c0), 1e-30)
    check(np.allclose(c1, c0, rtol=UNI_RTOL_COUNTS, atol=0.0),
          f"{what}: expected counts within rtol {UNI_RTOL_COUNTS} "
          f"(max rel diff {rel.max():.3g})")
    check(abs(ll1 - ll0) <= UNI_RTOL_LL * abs(ll0),
          f"{what}: log likelihood within rtol {UNI_RTOL_LL} "
          f"({ll1!r} vs {ll0!r})")


def uni_trainer(**kw):
    from shredword_tpu import UnigramTrainer
    t = UnigramTrainer(target_vocab_size=1024, seed_size=10_000, **kw)
    t.load_corpus(CORPUS)
    return t


def phase5_unigram(card: str) -> None:
    log("[5] Unigram 1024 pieces, seed 10k")
    dev = uni_trainer()
    host = uni_trainer(backend="cpu")
    same_estep(unigram_estep(dev), unigram_estep(host),
               "device E-step vs host numpy E-step")
    t = uni_trainer()
    t0 = time.perf_counter()
    n = t.train()
    dt = time.perf_counter() - t0
    check(n == 1024, f"trained to {n} pieces")
    log(f"  Unigram train(): {dt:.3f} s, final LL {t.final_ll!r} "
        f"({t.final_ll_per_word!r}/word)  [{card}]")


def four_cards(card: str) -> None:
    import jax
    from shredword_tpu.parallel import make_mesh
    log("[4 cards] BPETrainer(shards=4) at 32768, UnigramTrainer mesh")
    devs = jax.devices()
    check(len(devs) == 4 and len({d.id for d in devs}) == 4,
          "four distinct GPUs")
    one, dt1 = bpe_run(V32K, "auto", "v32k_one")
    log(f"  one card auto train(): {dt1:.3f} s  [{card}]")
    four, dt4 = bpe_run(V32K, "auto", "v32k_four", shards=4)
    log(f"  shards=4 train(): {dt4:.3f} s  [{card}]")
    same_bpe(four, one, "shards=4 vs one card")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    log(f"  peak_bytes_in_use per device {peaks}")
    shard = (V32K["vocab"] // 4) * V32K["vocab"] * 4
    check(min(peaks) >= shard,
          f"every device held its {shard}-byte table row shard")
    mesh = make_mesh(4)
    same_estep(unigram_estep(uni_trainer(mesh=mesh)),
               unigram_estep(uni_trainer()),
               "4-device mesh E-step vs one card")
    t1 = uni_trainer()
    t1.train()
    t4 = uni_trainer(mesh=mesh)
    t4.train()
    log(f"  final LL one card {t1.final_ll!r}, mesh {t4.final_ll!r}")
    check(abs(t4.final_ll - t1.final_ll) <= UNI_RTOL_LL * abs(t1.final_ll),
          f"mesh final LL within rtol {UNI_RTOL_LL} of one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    card = card_line()
    log(f"card: {card}")
    sys.path.insert(0, ROOT)
    import bench
    os.makedirs(WORK, exist_ok=True)
    bench.make_corpus(CORPUS)
    if args.cards == 1:
        phase0_cli(card)

    # phase 1: from here on this process holds the card(s)
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    from shredword_tpu import device
    dev = device.describe()
    log(f"[1] JAX device: {dev}")
    check(dev["platform"] == "gpu", "JAX's default device is a GPU")
    check(dev["count"] >= args.cards, f"{args.cards} card(s) present")
    if args.cards == 4:
        four_cards(card)
    else:
        phase2_768(card)
        model = phase3_32k(card)
        phase4_encode(model, card)
        phase5_unigram(card)
    log(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
