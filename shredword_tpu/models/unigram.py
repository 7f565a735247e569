"""UnigramTrainer — SentencePiece-style unigram LM trainer on device.

The reference ships only the dormant groundwork for this trainer — the
normalizer and the seed-vocabulary substring enumerator
(normalize.cpp:24-59, 215-237; SURVEY.md §2.A "Normalizer + subword
enumerator (DORMANT)") — while its package description promises "BPE &
Unigram trainers" (pyproject.toml:8).  This module supplies the full
trainer the reference never wired up:

  1. normalize + whitespace-split to unique words with counts, each
     word prefixed with the U+2581 marker (SentencePiece convention)
  2. seed vocabulary = all substrings (reference enumerator semantics)
     capped to `seed_size` by count
  3. EM: the E-step runs as a batched lattice forward-backward on
     device — words padded to [n_words, L], piece lookups precomputed
     host-side into an int32 [n_words, L, K] table (runtime
     shred_piece_table), the DP scanned over positions with
     ``lax.scan`` and reduced with logsumexp; expected counts
     aggregated per piece
  4. pruning: drop the lowest-likelihood-contribution pieces per round
     (keeping all single bytes) until the target size is reached
  5. Viterbi segmentation for encoding (same lattice, max instead of
     logsumexp)

Counts/probabilities are float32 on device; piece scores are kept in
log space throughout.
"""

from __future__ import annotations

import math

import numpy as np

from .. import device
from ..config import UnigramConfig
from ..errors import EncodeError, TrainingError
from ..runtime import native
from ..utils import logging as log

_MARKER = "▁".encode()


def _prep_words(corpus_bytes: bytes, max_word_len: int):
    """Normalize, split at markers, dedup to (words, counts)."""
    norm = native.normalize(corpus_bytes)
    counts: dict[bytes, int] = {}
    for line in norm.split(b"\n"):
        for raw in line.split(_MARKER):
            if not raw:
                continue
            w = (_MARKER + raw)[: max_word_len]
            counts[w] = counts.get(w, 0) + 1
    words = sorted(counts)
    return words, np.asarray([counts[w] for w in words], dtype=np.int64)


class UnigramTrainer:
    """API mirrors BPETrainer: load_corpus / train / save."""

    def __init__(self, target_vocab_size: int = 8192,
                 seed_size: int = 100_000, max_piece_len: int = 15,
                 max_word_len: int = 32, shrink_factor: float = 0.75,
                 num_em_rounds: int = 2, backend: str = "device",
                 mesh=None, shards: int = 0, **kw):
        self.config = UnigramConfig(
            target_vocab_size=target_vocab_size, seed_size=seed_size,
            max_piece_len=max_piece_len, max_word_len=max_word_len,
            shrink_factor=shrink_factor, num_em_rounds=num_em_rounds,
            backend=backend, **kw).validate()
        # jax.sharding.Mesh: shard the lattice tables (and the EM
        # forward-backward) by word over the mesh's `data` axis —
        # expected counts psum across devices (parallel/unigram.py).
        # shards=N builds a 1-D mesh over local devices (BPETrainer's
        # convention, models/bpe.py:64).
        if mesh is None and shards > 1:
            from ..parallel import make_mesh
            mesh = make_mesh(shards)
        self.mesh = mesh
        self._words: list[bytes] | None = None
        self._wcounts: np.ndarray | None = None
        self._slabs = None          # device-resident lattice tables
        self._nb: int | None = None  # run-constant piece-count bucket
        self.pieces: list[bytes] = []
        self.log_probs: np.ndarray = np.zeros(0, np.float64)
        # quality metrics, set by train(): total corpus log likelihood
        # of the final EM round and its normalizations
        self.final_ll: float = 0.0
        self.final_ll_per_word: float = 0.0
        self.final_ll_per_byte: float = 0.0

    # ------------------------------------------------------------------

    def load_corpus(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        self._words, self._wcounts = _prep_words(
            data, self.config.max_word_len)
        self._slabs = None
        log.info("Unigram corpus: %d unique words, %d occurrences",
                 len(self._words), int(self._wcounts.sum()))

    # ------------------------------------------------------------------

    def _seed(self) -> tuple[list[bytes], np.ndarray]:
        sv = native.SeedVocab()
        try:
            for w, c in zip(self._words, self._wcounts):
                # skip_markers=False: word-boundary pieces (marker-
                # prefixed) must be seedable for the trainer, unlike the
                # reference-parity enumerator surface
                sv.add(w, max_len=self.config.max_piece_len,
                       weight=int(c), skip_markers=False)
            pieces, counts = sv.export(self.config.seed_size)
        finally:
            sv.free()
        # required single bytes: every byte occurring in any word
        seen = set()
        for w in self._words:
            seen.update(w)
        singles = [bytes([b]) for b in sorted(seen)]
        have = set(pieces)
        extra = [s for s in singles if s not in have]
        if extra:
            pieces = pieces + extra
            counts = np.concatenate(
                [counts, np.ones(len(extra), np.int64)])
        return pieces, counts

    def _required(self, pieces: list[bytes]) -> np.ndarray:
        """Mask of pieces that may never be pruned (single bytes)."""
        return np.asarray([len(p) == 1 for p in pieces])

    def _loss_delta_keep(self, pieces, logp, exp_counts) -> np.ndarray:
        """SentencePiece-style loss-delta pruning mask.

        For each prunable piece p: segment p's own string with the
        current model EXCLUDING the whole-string arc (mask that one
        table cell, batched device Viterbi).  Removing p re-routes its
        expected frequency F_p through that alternative, so the
        likelihood loss is F_p * (logp_p - alt_p).  Keep the
        shrink_factor fraction with the largest loss; single bytes and
        pieces with no alternative are unprunable."""
        from ..ops import unigram_ops
        cfg = self.config
        required = self._required(pieces)
        loss = np.full(len(pieces), np.inf)
        prunable = np.nonzero(~required)[0]
        lp64 = np.asarray(logp, np.float64)
        for s in range(0, len(prunable), self.EM_SLAB_WORDS):
            idx = prunable[s:s + self.EM_SLAB_WORDS]
            strs = [pieces[i] for i in idx]
            L = max(2, max(len(p) for p in strs))
            table = native.piece_table(strs, pieces, L,
                                       min(cfg.max_piece_len, L))
            for row, i in enumerate(idx):      # mask the identity arc
                table[row, 0, len(pieces[i]) - 1] = -1
            wlen = np.asarray([len(p) for p in strs], np.int32)
            segs, scores = unigram_ops.viterbi(
                table, wlen, np.asarray(logp, np.float32),
                return_scores=True)
            alt = np.asarray(scores, np.float64)
            f = exp_counts[idx]
            d = f * (lp64[idx] - alt)
            d = np.where(np.isfinite(alt), d, np.inf)  # no alt: keep
            loss[idx] = d
        keep_n = max(cfg.target_vocab_size,
                     int(len(pieces) * cfg.shrink_factor))
        keep = required.copy()
        slots = keep_n - int(keep.sum())
        if slots > 0:
            order = prunable[np.argsort(-loss[prunable], kind="stable")]
            keep[order[:slots]] = True
        # anything whose removal makes some string unsegmentable stays
        keep[np.isinf(loss) & ~required] = True
        return keep

    # ------------------------------------------------------------------

    # words per E-step slab: bounds the [W, L, K] piece-table working
    # set (int32) to ~126 MB at L=32, K=15 regardless of corpus size
    EM_SLAB_WORDS = 65536

    def _dev_slab_tables(self, pieces):
        """Device-resident per-slab lattice tables, built once for the
        seed piece set and REMAPPED (device gather) at every prune —
        the host piece-table rebuild and the 2x[L, W, K] upload happen
        exactly once per slab for the whole training run instead of
        once per EM round (the dominant cost of the r3 trainer)."""
        from ..ops import unigram_ops
        if self._slabs is None:
            L = self.config.max_word_len
            K = self.config.max_piece_len
            wlen = np.asarray([len(w) for w in self._words], np.int32)
            wc = self._wcounts.astype(np.float32)
            self._slabs = []
            # length-bucketed slabs: a word of length l needs only an
            # [l-tight, W, K] lattice, and short words dominate natural
            # text — riding them in the full-L table doubles every FB
            # gather/scatter.  Buckets are L/2 (short) and L (rest);
            # counts are order-independent, so bucketing is free.
            buckets = ([L // 2, L] if L >= 8 else [L])
            lo = 0
            for b in buckets:
                sel = np.nonzero((wlen > lo) & (wlen <= b))[0]
                lo = b
                for s in range(0, len(sel), self.EM_SLAB_WORDS):
                    idx = sel[s:s + self.EM_SLAB_WORDS]
                    words_b = [self._words[i] for i in idx]
                    table = native.piece_table(words_b, pieces, b,
                                               min(K, b))
                    if self.mesh is not None:
                        from ..parallel import unigram as par_uni
                        self._slabs.append(par_uni.make_sharded_table(
                            self.mesh, table, wlen[idx], wc[idx]))
                    else:
                        self._slabs.append(unigram_ops.make_device_table(
                            table, wlen[idx], wc[idx]))
        return self._slabs

    def _remap_slabs(self, keep: np.ndarray) -> None:
        """Apply a prune to the resident tables: survivors renumber,
        pruned cells become absent."""
        if self._slabs is None:
            return
        from ..ops import unigram_ops
        perm = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
        self._slabs = [unigram_ops.remap_device_table(dt, perm,
                                                      self._nb)
                       for dt in self._slabs]

    def _e_step(self, pieces, logp):
        """Expected piece counts + total log likelihood (device DP).
        The device path scans resident tables (zero per-round upload);
        the cpu backend keeps the slab-streamed host fallback."""
        from ..ops import unigram_ops
        lp = np.asarray(logp, np.float32)
        total = np.zeros(len(pieces), np.float64)
        ll = 0.0
        # An explicit mesh is its own opt-in and overrides the backend
        # (the sharded FB is plain XLA and runs on any platform, incl.
        # the virtual CPU mesh).  Otherwise the E-step runs on the
        # device whenever JAX has an accelerator; on a CPU-only host the
        # vectorized numpy FB is the faster choice.
        use_device = self.mesh is not None or (
            self.config.backend != "cpu" and device.is_accelerator())
        if use_device:
            # run-constant piece-count bucket: the FB/remap cost is
            # n_pieces-independent (the lattice is [L, W, K]); sizing
            # every round to the SEED bucket shares one executable per
            # slab shape for the whole shrink schedule instead of one
            # per power-of-two crossing (each distinct shape costs a
            # full compile)
            if self._nb is None:
                self._nb = unigram_ops._pow2(len(pieces))
            if self.mesh is not None:
                from ..parallel import unigram as par_uni
                for dt in self._dev_slab_tables(pieces):
                    c, l = par_uni.sharded_forward_backward(
                        dt, lp, len(pieces), mesh=self.mesh,
                        nb=self._nb)
                    total += np.asarray(c, np.float64)
                    ll += float(l)
                return total, ll
            for dt in self._dev_slab_tables(pieces):
                c, l = unigram_ops.forward_backward_resident(
                    dt, lp, len(pieces), nb=self._nb)
                total += np.asarray(c, np.float64)
                ll += float(l)
            return total, ll
        L = self.config.max_word_len
        K = self.config.max_piece_len
        wlen = np.asarray([len(w) for w in self._words], np.int32)
        wc = self._wcounts.astype(np.float32)
        for s in range(0, len(self._words), self.EM_SLAB_WORDS):
            e = min(s + self.EM_SLAB_WORDS, len(self._words))
            table = native.piece_table(self._words[s:e], pieces, L, K)
            c, l = unigram_ops.forward_backward(
                table, wlen[s:e], wc[s:e], lp, len(pieces),
                backend="cpu")
            total += np.asarray(c, np.float64)
            ll += float(l)
        return total, ll

    def train(self) -> int:
        if self._words is None:
            raise TrainingError("load_corpus must be called before train")
        cfg = self.config
        pieces, counts = self._seed()
        self._slabs = None          # resident tables track `pieces`
        self._nb = None             # re-derived from this seed set
        freq = counts.astype(np.float64)
        logp = np.log(freq / freq.sum())
        log.info("Unigram seed: %d pieces", len(pieces))

        ll = 0.0
        while True:
            for r in range(cfg.num_em_rounds):
                exp_counts, ll = self._e_step(pieces, logp)
                tot = exp_counts.sum()
                with np.errstate(divide="ignore"):
                    logp = np.where(exp_counts > 0,
                                    np.log(exp_counts / max(tot, 1e-300)),
                                    -1e30)
                log.progress("EM round %d: %d pieces, loss %.4f", r,
                             len(pieces), -ll)
            if len(pieces) <= cfg.target_vocab_size:
                break
            keep = self._loss_delta_keep(pieces, logp, exp_counts)
            new_pieces = [p for p, k in zip(pieces, keep) if k]
            if len(new_pieces) == len(pieces):
                log.warning(
                    "unigram prune cannot shrink below %d required "
                    "pieces (target %d); stopping",
                    int(self._required(pieces).sum()),
                    cfg.target_vocab_size)
                break
            self._remap_slabs(keep)
            pieces = new_pieces
            logp = logp[keep]
            logp -= np.log(np.exp(logp).sum() + 1e-300)
        self.pieces = pieces
        self.log_probs = logp
        # quality metrics (BASELINE "Unigram" table): total corpus log
        # likelihood of the final EM round, and its per-occurrence /
        # per-byte normalizations (word occurrences weight the lattice)
        self.final_ll = float(ll)
        n_occ = float(self._wcounts.sum())
        n_bytes = float((self._wcounts
                         * np.asarray([len(w) for w in self._words],
                                      np.int64)).sum())
        self.final_ll_per_word = self.final_ll / max(n_occ, 1.0)
        self.final_ll_per_byte = self.final_ll / max(n_bytes, 1.0)
        log.info("Unigram training complete: %d pieces "
                 "(corpus LL %.4g, %.4f/word)", len(pieces),
                 self.final_ll, self.final_ll_per_word)
        return len(pieces)

    # ------------------------------------------------------------------

    def save(self, model_path: str) -> None:
        """Text format: 'shredword unigram v1' + piece-hex<TAB>logprob."""
        with open(model_path, "w", encoding="utf-8") as f:
            f.write("shredword unigram v1\n")
            f.write(f"{len(self.pieces)}\n")
            for p, lp in zip(self.pieces, self.log_probs):
                f.write(f"{p.hex()}\t{lp:.17g}\n")

    @classmethod
    def load_model(cls, model_path: str) -> tuple[list[bytes], np.ndarray]:
        with open(model_path, "r", encoding="utf-8") as f:
            header = f.readline().strip()
            if header != "shredword unigram v1":
                raise TrainingError(f"bad unigram model header: {header!r}")
            n = int(f.readline())
            pieces, lps = [], []
            for _ in range(n):
                hx, lp = f.readline().split("\t")
                pieces.append(bytes.fromhex(hx))
                lps.append(float(lp))
        return pieces, np.asarray(lps, np.float64)


class UnigramTokenizer:
    """Viterbi segmentation with a trained unigram model.

    encode() runs the BATCHED DEVICE Viterbi (ops/unigram_ops.viterbi)
    over the deduplicated words of the input — one dispatch per slab —
    with a persistent word -> ids memo; the per-word host DP remains
    only as the fallback for words beyond the device layout bound."""

    DEVICE_WORD_CAP = 64        # device-lattice word length bound
    ENC_SLAB_WORDS = 32768      # bounds the [W, L, K] lookup table

    def __init__(self, pieces: list[bytes], log_probs: np.ndarray):
        self.pieces = pieces
        self.log_probs = np.asarray(log_probs, np.float64)
        self._index = {p: i for i, p in enumerate(pieces)}
        self._max_len = max((len(p) for p in pieces), default=1)
        self._memo: dict[bytes, list[int]] = {}
        # (flat bytes, offsets, n_pieces-at-build) — see decode_bytes
        self._flat: tuple[np.ndarray, np.ndarray, int] | None = None

    @classmethod
    def load(cls, model_path: str) -> "UnigramTokenizer":
        return cls(*UnigramTrainer.load_model(model_path))

    def encode_word(self, word: bytes) -> list[int]:
        n = len(word)
        best = np.full(n + 1, -math.inf)
        best[0] = 0.0
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        for j in range(1, n + 1):
            for l in range(1, min(self._max_len, j) + 1):
                pid = self._index.get(word[j - l:j])
                if pid is None:
                    continue
                cand = best[j - l] + self.log_probs[pid]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (j - l, pid)
        if not math.isfinite(best[n]):
            raise EncodeError(
                f"word {word!r} cannot be segmented: it contains bytes "
                "absent from the training corpus")
        ids = []
        j = n
        while j > 0:
            j, pid = back[j]
            ids.append(pid)
        return ids[::-1]

    def encode(self, text: str) -> list[int]:
        return self.encode_array(text).tolist()

    def encode_array(self, text: str) -> np.ndarray:
        """encode() returning int32 numpy ids, with NO per-word Python
        loop over the stream: ONE native pass splits the normalized
        bytes into words AND deduplicates them (csrc/dedup.cpp
        shred_marker_word_dedup — natural text repeats its words), only
        the UNIQUE words materialize as Python bytes for the device
        Viterbi, and the full id stream is a native memcpy expansion —
        the same fused shape as the BPE encoder's whole-text path."""
        norm = native.normalize(text.encode())
        inverse, uoff_b, ulen = native.marker_word_dedup(norm)
        if len(inverse) == 0:
            return np.zeros(0, np.int32)
        nb = norm if isinstance(norm, bytes) else bytes(norm)
        uniq_words = [_MARKER + nb[o:o + l]
                      for o, l in zip(uoff_b.tolist(), ulen.tolist())]
        self._segment_new(uniq_words)
        lens = np.empty(len(uniq_words), np.int64)
        parts: list[list[int]] = []
        for i, w in enumerate(uniq_words):
            ids = self._memo[w]
            parts.append(ids)
            lens[i] = len(ids)
        flat = np.fromiter((i for u in parts for i in u), np.int32,
                           int(lens.sum()))
        uoff = np.zeros(len(parts) + 1, np.int64)
        np.cumsum(lens, out=uoff[1:])
        total = int(lens[inverse].sum())
        return native.expand_ids(flat, uoff, inverse, total)

    def _segment_new(self, words: list[bytes]) -> None:
        """Device-Viterbi any not-yet-memoized words (deduplicated,
        slab-batched); oversized words fall back to the host DP."""
        from ..ops import unigram_ops
        fresh: dict[bytes, None] = {}
        for w in words:
            if w not in self._memo:
                fresh[w] = None
        dev = [w for w in fresh if len(w) <= self.DEVICE_WORD_CAP]
        for s in range(0, len(dev), self.ENC_SLAB_WORDS):
            slab = dev[s:s + self.ENC_SLAB_WORDS]
            L = max(len(w) for w in slab)
            table = native.piece_table(slab, self.pieces, max(L, 2),
                                       min(self._max_len, max(L, 2)))
            wlen = np.asarray([len(w) for w in slab], np.int32)
            segs = unigram_ops.viterbi(
                table, wlen, np.asarray(self.log_probs, np.float32))
            self._memo.update(zip(slab, segs))
        for w in fresh:
            if len(w) > self.DEVICE_WORD_CAP:
                self._memo[w] = self.encode_word(w)

    def encode_batch(self, texts: list[str]) -> list[list[int]]:
        """Encode many documents; the device Viterbi sees each DISTINCT
        word across the whole batch once (shared memo).  Returns lists
        of ints — the BPE Tokenizer.encode_batch contract."""
        return [a.tolist() for a in self.encode_batch_arrays(texts)]

    def encode_batch_arrays(self, texts: list[str]) -> list[np.ndarray]:
        """encode_batch returning int32 numpy arrays (bulk-pipeline
        shape, mirrors Tokenizer.encode_batch_arrays)."""
        return [self.encode_array(t) for t in texts]

    def decode_bytes(self, ids) -> bytes:
        """ids -> raw bytes (marker bytes preserved), vectorized via
        the native piece expansion the BPE decoder uses."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) == 0:
            return b""
        # cache keyed on the piece-table size so a mutated/extended
        # `pieces` list invalidates it (ADVICE r4: a stale cache would
        # decode wrong bytes or raise a spurious EncodeError)
        if self._flat is None or self._flat[2] != len(self.pieces):
            lens = np.fromiter((len(p) for p in self.pieces), np.int64,
                               len(self.pieces))
            off = np.zeros(len(self.pieces) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            self._flat = (np.frombuffer(b"".join(self.pieces), np.uint8),
                          off, len(self.pieces))
        flat, off = self._flat[:2]
        if (ids < 0).any() or (ids >= len(self.pieces)).any():
            raise EncodeError("invalid piece id in decode")
        total = int((off[ids + 1] - off[ids]).sum())
        return native.expand_bytes(flat, off, ids.astype(np.int32), total)

    def decode(self, ids) -> str:
        data = self.decode_bytes(ids)
        return data.replace(_MARKER, b" ").decode("utf-8", "replace").strip()
