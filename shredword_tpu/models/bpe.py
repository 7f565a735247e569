"""BPETrainer — the device BPE trainer.

API parity with the reference Python class (trainer.py:5-39):
``BPETrainer(target_vocab_size, unk_id, character_coverage,
min_pair_freq)`` + ``load_corpus`` / ``train`` / ``save``; plus
extensions (backend selection, incremental training, sharded training via
``shredword_tpu.parallel``).

Pipeline:
  1. host: native corpus ingestion (threaded dedup) + coverage/unk mapping
  2. device: flat int32 arrays; the whole merge loop runs inside
     ``lax.while_loop`` (ops/bpe_ops.py) with exact sort-based counting
  3. host: periodic array re-compaction to smaller capacity buckets as
     the stream shrinks (fewer bytes per pass; shapes stay static per
     bucket so XLA caches one executable per bucket)

Tie-breaking: the device engines break equal-frequency ties to the
lexicographically smallest pair ("lex") — deterministic and documented.
``tie_break="faithful"`` reproduces the reference's heap-artifact order
bit-for-bit via the native faithful engine (runtime/csrc/faithful.cpp),
whose outputs byte-match the compiled reference binary.
"""

from __future__ import annotations

import numpy as np

from .. import device
from ..config import BPEConfig
from ..errors import TrainingError
from ..runtime import native
from ..utils import logging as log

_BASE_VOCAB = 256

# Largest vocab that engine="auto" trains on the table engine on an
# accelerator; above it (and on a CPU-only host) auto takes the flat
# engine.  From warm train() times on an H100 on the 16 MB bench corpus
# (PERF.md): the table engine wins at 768 and ties to within 3% at
# 2048 and 4096; flat wins at 8192 and by 2x at 32768, where the
# table's per-merge pick scans all V^2 cells.
TABLE_AUTO_MAX_VOCAB = 4096


def _use_table_engine(engine: str, vocab: int) -> bool:
    """Whether a single-device run starts with the table engine."""
    if engine in ("hist", "giant"):
        return True
    return (engine == "auto" and device.is_accelerator()
            and vocab <= TABLE_AUTO_MAX_VOCAB)


def _bucket(n: int) -> int:
    """Static-shape capacity bucket (power of two, >= 1024)."""
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


class BPETrainer:
    def __init__(self, target_vocab_size: int = 8192, unk_id: int = 0,
                 character_coverage: float = 0.995,
                 min_pair_freq: int = 2000, mesh=None, **kwargs):
        self.config = BPEConfig(
            target_vocab_size=target_vocab_size, unk_id=unk_id,
            character_coverage=character_coverage,
            min_pair_freq=min_pair_freq, **kwargs).validate()
        # jax.sharding.Mesh for data-parallel training; alternatively set
        # shards=N in the config to build a 1-D mesh over local devices
        self.mesh = mesh
        self._corpus: native.NativeCorpus | None = None
        self._faithful: native.FaithfulTrainer | None = None
        self._arrays: native.CorpusArrays | None = None
        self._keep: np.ndarray | None = None
        self._merges = np.zeros((0, 2), dtype=np.int32)
        self._merge_freqs = np.zeros(0, dtype=np.int64)
        self.__final_tokens: np.ndarray | None = None
        self.__final_word_id: np.ndarray | None = None
        self._final_fn = None   # lazy materializer (device -> host)
        self._trained = False

    # The table engines leave the merged corpus on device; the D2H
    # transfer happens only when a consumer (token_frequencies,
    # tokens()) first touches the arrays.
    @property
    def _final_tokens(self) -> np.ndarray | None:
        self._materialize_final()
        return self.__final_tokens

    @_final_tokens.setter
    def _final_tokens(self, value) -> None:
        self._final_fn = None
        self.__final_tokens = value

    @property
    def _final_word_id(self) -> np.ndarray | None:
        self._materialize_final()
        return self.__final_word_id

    @_final_word_id.setter
    def _final_word_id(self, value) -> None:
        # clear the lazy materializer in BOTH setters: assigning either
        # array must not be silently overwritten by a later _final_fn run
        self._final_fn = None
        self.__final_word_id = value

    def _materialize_final(self) -> None:
        if self._final_fn is not None:
            fn, self._final_fn = self._final_fn, None
            self.__final_tokens, self.__final_word_id = fn()

    # ------------------------------------------------------------------
    # corpus
    # ------------------------------------------------------------------

    def load_corpus(self, path: str) -> None:
        # The cpu backend runs the faithful engine, whose tie-breaks are
        # corpus-order artifacts; keep the reference word order so its
        # output is reference-identical regardless of tie_break.
        faithful = (self.config.tie_break == "faithful"
                    or self.config.backend == "cpu")
        with log.Timer("load_corpus") as t:
            self._corpus = native.NativeCorpus.from_file(
                path, faithful_order=faithful)
            self._ingest()
        log.info("Loaded corpus: %d unique words, %d occurrences, "
                 "%.1f MB raw (%.1f MB/s)", self._arrays.n_words,
                 self._arrays.total_occurrences,
                 self._arrays.total_raw_bytes / 1e6,
                 self._arrays.total_raw_bytes / 1e6 / max(t.elapsed, 1e-9))

    def load_corpus_bytes(self, data: bytes) -> None:
        faithful = (self.config.tie_break == "faithful"
                    or self.config.backend == "cpu")
        self._corpus = native.NativeCorpus.from_bytes(
            data, faithful_order=faithful)
        self._ingest()

    def load_corpora(self, paths: list[str]) -> None:
        """Train on several corpus files at once (deduplicated jointly).

        The reference documents calling load_corpus repeatedly for this
        (UserBPE.md "Multiple Corpus Training") but its implementation
        discards all but the last corpus; here load_corpus replaces by
        design (matching the real reference behavior) and load_corpora
        provides the documented capability honestly."""
        chunks = []
        for p in paths:
            with open(p, "rb") as f:
                chunks.append(f.read())
            if chunks[-1] and not chunks[-1].endswith(b"\n"):
                chunks.append(b"\n")
        self.load_corpus_bytes(b"".join(chunks))

    # context-manager support (the reference docs make users hand-roll
    # a wrapper for this, UserBPE.md "Context Manager Pattern")
    def __enter__(self) -> "BPETrainer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.destroy()

    def _ingest(self) -> None:
        if self._faithful is not None:   # stale vs the new corpus
            self._faithful.free()
            self._faithful = None
        self._arrays = self._corpus.arrays()
        keep, n_kept, n_unique = self._corpus.coverage(
            self.config.character_coverage)
        self._keep = keep
        log.debug("Character histogram: %d unique, keeping %d", n_unique,
                  n_kept)

    def _token_arrays(self):
        """Flat (tokens, word_id, wcount) int32 arrays with unk applied."""
        arr = self._arrays
        tokens = arr.word_bytes.astype(np.int32)
        unk = np.where(~self._keep[arr.word_bytes])[0]
        tokens[unk] = self.config.unk_id
        lengths = np.diff(arr.offsets)
        word_id = np.repeat(
            np.arange(arr.n_words, dtype=np.int32), lengths)
        counts = np.minimum(arr.counts, np.iinfo(np.int32).max)
        wcount = counts.astype(np.int32)[word_id]
        return tokens, word_id, wcount

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(self, max_merges: int | None = None) -> int:
        if self._arrays is None:
            raise TrainingError("load_corpus must be called before train")
        resuming = len(self._merges) > 0 and not self._trained
        if self.config.backend == "cpu" or self.config.tie_break == "faithful":
            if resuming:
                raise TrainingError(
                    "checkpoint resume needs the device engines "
                    "(backend='device', tie_break='lex'): the faithful "
                    "engine's tie-break state cannot be reconstructed "
                    "mid-training")
            return self._train_cpu_or_faithful(max_merges)
        return self._train_device(max_merges)

    def _train_cpu_or_faithful(self, max_merges) -> int:
        # tie_break="faithful" requires the reference's heap/hash iteration
        # artifacts (docs/CONFORMANCE.md §2), which only the native engine
        # reproduces; it is used regardless of backend.
        cfg = self.config
        if self._faithful is None:
            self._faithful = native.FaithfulTrainer(
                cfg.target_vocab_size, cfg.unk_id,
                cfg.character_coverage, cfg.min_pair_freq)
            self._faithful.load(self._corpus)
        t = self._faithful   # kept alive: train() continues incrementally
        limit = -1 if max_merges is None else max_merges
        if cfg.checkpoint_path and cfg.checkpoint_every:
            from .. import checkpoint as ckpt
            n = 0
            while True:
                step = cfg.checkpoint_every
                if limit >= 0:
                    step = min(step, limit - n)
                    if step <= 0:
                        break
                got = t.train(step)
                n += got
                ckpt.save_checkpoint(
                    cfg.checkpoint_path, merges=t.merges(),
                    merge_freqs=t.merge_freqs().astype(np.int64),
                    config=cfg)
                if got < step:
                    break
        else:
            n = t.train(limit)
        self._merges = t.merges()
        self._merge_freqs = t.merge_freqs().astype(np.int64)
        toks, wids = t.tokens()
        self._final_tokens, self._final_word_id = toks, wids
        self._trained = True
        log.info("Training completed: %d merges performed.", n)
        return n

    def _train_device(self, max_merges) -> int:
        import jax.numpy as jnp

        from ..ops import bpe_ops

        cfg = self.config
        target = cfg.target_merges
        if max_merges is not None:
            target = min(target, len(self._merges) + max_merges)
        # Device engines count in int32 (the reference accumulates in
        # uint64, bpe.cpp:329-355).  The EXACT bound: any single pair's
        # weighted count is at most the total number of adjacent pairs,
        # sum over unique words of count * (len - 1).  Corpora far over
        # 2 GiB raw pass this when deduplication is heavy; only corpora
        # whose pair mass itself overflows int32 must use the cpu
        # backend's 64-bit counts.
        lens64 = np.diff(self._arrays.offsets)
        pair_mass = int(
            (self._arrays.counts.astype(np.uint64)
             * np.maximum(lens64 - 1, 0).astype(np.uint64)).sum())
        if int(self._arrays.counts.max(initial=0)) >= 2**31 or \
                pair_mass >= 2**31:
            raise TrainingError(
                "corpus pair counts exceed the device engines' int32 "
                "range; use backend='cpu' (64-bit counts)")
        tokens, word_id, wcount = self._token_arrays()
        n = len(tokens)
        if n == 0 or target <= 0:
            self._trained = True
            self._final_tokens = tokens
            self._final_word_id = word_id
            log.info("Training completed: 0 merges performed.")
            return 0

        if self.mesh is not None or cfg.shards > 1:
            tokens, word_id, wcount, n_prev = self._replay_for_resume(
                tokens, word_id, wcount)
            return self._train_sharded(tokens, word_id, wcount, target,
                                       n_prev)

        tokens, word_id, wcount, n_prev = self._replay_for_resume(
            tokens, word_id, wcount)
        n = len(tokens)

        if _use_table_engine(cfg.engine, cfg.target_vocab_size):
            out = self._train_table(tokens, word_id, target, n_prev)
            if out is not None:
                return out
            if cfg.engine != "auto":
                raise TrainingError(
                    f"{cfg.engine} engine requested but the corpus/vocab "
                    "does not fit the table engine (a word > 64 tokens "
                    "or vocab > 32768)")

        log.debug("using the flat-stream engine")
        state = bpe_ops.make_state(tokens, word_id, wcount, _bucket(n))
        ts = bpe_ops.train_init(state, cfg.target_merges,
                                n_prev_merges=n_prev)

        chunk = cfg.merges_per_device_call
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            while True:
                n_before = int(ts.n_merges)
                ts = bpe_ops.train_loop(
                    ts, jnp.int32(cfg.unk_id), jnp.int32(cfg.min_pair_freq),
                    target_merges=target, max_steps=chunk)
                n_after = int(ts.n_merges)
                done = bool(ts.done) or n_after >= target
                length = int(ts.corpus.length)
                log.progress("Completed %d/%d merges (stream %d/%d)",
                             n_after, target, length,
                             ts.corpus.tokens.shape[0])
                if cfg.checkpoint_path and cfg.checkpoint_every and \
                        n_after // cfg.checkpoint_every \
                        > n_before // cfg.checkpoint_every:
                    self._write_checkpoint(ts, n_prev)
                if done:
                    break
                if n_after == n_before:
                    break  # safety: no progress
                # device-side re-compaction to a smaller capacity bucket
                # (tokens are already front-compacted after every merge, so
                # shrinking is a pure device slice — no host round trip)
                cap = ts.corpus.tokens.shape[0]
                new_cap = _bucket(length)
                if new_cap <= cap // 2:
                    corpus = bpe_ops.CorpusState(
                        ts.corpus.tokens[:new_cap],
                        ts.corpus.word_id[:new_cap],
                        ts.corpus.wcount[:new_cap],
                        ts.corpus.length)
                    ts = ts._replace(corpus=corpus)

        n_merges = int(ts.n_merges)
        new_merges = np.asarray(ts.merges)[n_prev:n_merges].astype(np.int32)
        new_freqs = np.asarray(
            ts.merge_freqs)[n_prev:n_merges].astype(np.int64)
        self._merges = np.concatenate([self._merges[:n_prev], new_merges])
        self._merge_freqs = np.concatenate(
            [self._merge_freqs[:n_prev], new_freqs])
        length = int(ts.corpus.length)
        self._final_tokens = np.asarray(ts.corpus.tokens)[:length]
        self._final_word_id = np.asarray(ts.corpus.word_id)[:length]
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s)",
                 n_merges - n_prev, t.elapsed)
        return n_merges - n_prev

    def _replay_for_resume(self, tokens, word_id, wcount):
        """Checkpoint resume (ANY device engine, sharded or not):
        replay the learned merges onto the fresh corpus with the native
        encoder (exact — same rank-order, left-to-right overlap
        semantics as training), then continue with re-counted pairs,
        mirroring the reference's bpe_init-after-merge resumability
        (bpe.cpp:171-185).  The device engines resume natively: their
        merge counters seed at n_prev so new ids continue at
        256 + n_prev.  Returns (tokens, word_id, wcount, n_prev)."""
        n_prev = len(self._merges)
        if not n_prev:
            return tokens, word_id, wcount, 0
        lengths = np.bincount(word_id, minlength=self._arrays.n_words)
        offsets = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        enc = native.NativeEncoder(self._merges)
        tokens, out_off = enc.apply_merges(tokens, offsets)
        enc.free()
        word_id = np.repeat(
            np.arange(self._arrays.n_words, dtype=np.int32),
            np.diff(out_off))
        counts = np.minimum(self._arrays.counts,
                            np.iinfo(np.int32).max).astype(np.int32)
        wcount = counts[word_id]
        log.info("Resumed from %d merges; replayed corpus has %d "
                 "tokens", n_prev, len(tokens))
        return tokens, word_id, wcount, n_prev

    def _train_sharded(self, tokens, word_id, wcount, target,
                       n_prev: int = 0) -> int:
        """Data-parallel training over a device mesh: the replicated
        table (parallel/hist.py) up to vocab 4096, the row-sharded table
        (parallel/giant.py) up to 65536, the flat all-gather path
        beyond.
        Merge sequences are bit-identical to single-device training
        (tests/test_parallel.py).  Resume: the caller has already
        replayed n_prev merges into `tokens` (_replay_for_resume)."""
        from ..parallel import (make_mesh, sharded_giant_train,
                                sharded_hist_train, sharded_train)

        cfg = self.config
        mesh = self.mesh if self.mesh is not None else make_mesh(
            cfg.shards)
        n_shards = mesh.devices.size
        counts = np.minimum(self._arrays.counts,
                            np.iinfo(np.int32).max).astype(np.int32)
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            engine = "hist"
            out = sharded_hist_train(
                tokens, word_id, counts, mesh=mesh,
                target_merges=target, unk_id=cfg.unk_id,
                min_pair_freq=cfg.min_pair_freq, n_prev_merges=n_prev)
            if out is None:
                # beyond the replicated-table cap: row-sharded giant
                # table (pure XLA), vocab to 65536
                engine = "giant"
                out = sharded_giant_train(
                    tokens, word_id, counts, mesh=mesh,
                    target_merges=target, unk_id=cfg.unk_id,
                    min_pair_freq=cfg.min_pair_freq,
                    n_prev_merges=n_prev)
            if out is None:    # vocab/layout outside every table engine
                engine = "flat"
                out = sharded_train(
                    tokens, word_id, wcount, mesh=mesh,
                    target_merges=target, unk_id=cfg.unk_id,
                    min_pair_freq=cfg.min_pair_freq,
                    n_prev_merges=n_prev)
        merges, freqs = out
        self._merges = np.concatenate(
            [self._merges[:n_prev], merges.astype(np.int32)])
        self._merge_freqs = np.concatenate(
            [self._merge_freqs[:n_prev], freqs.astype(np.int64)])
        self._final_tokens = None
        self._final_word_id = None
        self._set_final_replay(self._merges)
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s, "
                 "sharded %s engine, %d shards)", len(merges), t.elapsed,
                 engine, n_shards)
        return len(merges)

    def _set_final_replay(self, merges: np.ndarray) -> None:
        """Lazy final corpus: replay the learned merges onto the raw
        dedup stream with the native encoder (exact — same rank-order,
        left-to-right overlap semantics as training)."""
        arr = self._arrays
        keep = self._keep
        unk_id = self.config.unk_id

        def final_fn():
            tokens = arr.word_bytes.astype(np.int32)
            unk = np.where(~keep[arr.word_bytes])[0]
            tokens[unk] = unk_id
            offsets = arr.offsets.astype(np.int64)
            if len(merges):
                enc = native.NativeEncoder(merges)
                tokens, offsets = enc.apply_merges(tokens, offsets)
                enc.free()
            word_id = np.repeat(np.arange(arr.n_words, dtype=np.int32),
                                np.diff(offsets))
            return tokens.astype(np.int32), word_id

        self._final_fn = final_fn

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _write_checkpoint(self, ts, n_prev: int) -> None:
        from .. import checkpoint as ckpt
        n = int(ts.n_merges)
        merges = np.concatenate(
            [self._merges[:n_prev],
             np.asarray(ts.merges)[n_prev:n].astype(np.int32)])
        freqs = np.concatenate(
            [self._merge_freqs[:n_prev],
             np.asarray(ts.merge_freqs)[n_prev:n].astype(np.int64)])
        ckpt.save_checkpoint(self.config.checkpoint_path, merges=merges,
                             merge_freqs=freqs, config=self.config)
        log.debug("checkpoint: %d merges -> %s", n,
                  self.config.checkpoint_path)

    def save_checkpoint(self, path: str) -> None:
        """Write a resumable checkpoint of the merges learned so far."""
        from .. import checkpoint as ckpt
        ckpt.save_checkpoint(path, merges=self._merges,
                             merge_freqs=self._merge_freqs,
                             config=self.config)

    def load_checkpoint(self, path: str) -> int:
        """Load a checkpoint; the next train() resumes after its merges
        (corpus must be loaded; it is replayed on resume).  Returns the
        number of merges restored."""
        from .. import checkpoint as ckpt
        _, merges, freqs = ckpt.load_checkpoint(path)
        self._merges = merges.astype(np.int32)
        self._merge_freqs = freqs.astype(np.int64)
        self._trained = False
        return len(merges)

    def _table_checkpoint_cb(self, n_prev: int):
        """(cb, steps) for the table engines' progress callbacks.  The
        engines report only NEW merges; the checkpoint must carry the
        full sequence, so the replayed prefix is prepended."""
        cfg = self.config
        if not (cfg.checkpoint_path and cfg.checkpoint_every):
            return None, None
        from .. import checkpoint as ckpt
        prev_m = self._merges[:n_prev].astype(np.int32)
        prev_f = self._merge_freqs[:n_prev].astype(np.int64)

        def cb(merges, freqs):
            ckpt.save_checkpoint(
                cfg.checkpoint_path,
                merges=np.concatenate([prev_m,
                                       merges.astype(np.int32)]),
                merge_freqs=np.concatenate([prev_f,
                                            freqs.astype(np.int64)]),
                config=cfg)

        return cb, cfg.checkpoint_every

    def _finish_table_engine(self, merges, freqs, final_fn, n_prev,
                             elapsed, engine: str) -> int:
        self._merges = np.concatenate(
            [self._merges[:n_prev], merges.astype(np.int32)])
        self._merge_freqs = np.concatenate(
            [self._merge_freqs[:n_prev], freqs.astype(np.int64)])
        self._final_tokens = None
        self._final_word_id = None
        self._final_fn = final_fn
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s, "
                 "%s engine)", len(merges), elapsed, engine)
        return len(merges)

    def _train_table(self, tokens, word_id, target,
                     n_prev: int = 0) -> int | None:
        """Table engine (ops/bpe_hist.py): by-word layout with a
        maintained pair table — no global sort per merge.  Returns None
        if the corpus/vocab is outside its envelope.  On resume the
        caller has already replayed n_prev merges into `tokens`."""
        from ..ops import bpe_hist

        cfg = self.config
        counts = np.minimum(self._arrays.counts,
                            np.iinfo(np.int32).max).astype(np.int32)
        cb, steps = self._table_checkpoint_cb(n_prev)
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            out = bpe_hist.hist_train(
                tokens, word_id, counts, target_merges=target,
                unk_id=cfg.unk_id, min_pair_freq=cfg.min_pair_freq,
                max_steps_per_call=steps, progress_cb=cb, lazy_final=True,
                n_prev_merges=n_prev)
            if out is None:
                return None
            merges, freqs, final_fn = out
        return self._finish_table_engine(merges, freqs, final_fn, n_prev,
                                         t.elapsed, "table")

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    @property
    def merges(self) -> np.ndarray:
        return self._merges

    @property
    def merge_freqs(self) -> np.ndarray:
        return self._merge_freqs

    @property
    def num_merges(self) -> int:
        return len(self._merges)

    @property
    def vocab_size(self) -> int:
        return _BASE_VOCAB + self.num_merges

    def token_frequencies(self) -> np.ndarray:
        """Frequency of every vocab id over the final merged corpus
        (reference bpe_save counting pass, bpe.cpp:704-712)."""
        if not self._trained:
            raise TrainingError("train must be called first")
        freqs = np.zeros(self.vocab_size, dtype=np.int64)
        toks = self._final_tokens
        counts = np.minimum(self._arrays.counts,
                            np.iinfo(np.int64).max).astype(np.int64)
        w = counts[self._final_word_id]
        valid = (toks >= 0) & (toks < self.vocab_size)
        np.add.at(freqs, toks[valid], w[valid])
        return freqs

    def save(self, model_path: str, vocab_path: str | None = None) -> None:
        from .. import serialization
        if not self._trained:
            raise TrainingError("train must be called before save")
        serialization.write_model_binary(model_path, self._merges)
        if vocab_path is not None:
            serialization.write_vocab(vocab_path, self._merges,
                                      self.token_frequencies())
        if vocab_path is not None:
            log.info("Saved %d-token vocab to %s and %d merges to %s",
                     self.vocab_size, vocab_path, self.num_merges,
                     model_path)
        else:
            log.info("Saved %d merges to %s", self.num_merges, model_path)

    def destroy(self) -> None:
        if self._faithful is not None:
            self._faithful.free()
            self._faithful = None
        if self._corpus is not None:
            self._corpus.free()
            self._corpus = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
