"""Tokenizer — unified encode/decode/save/load over a trained BPE model.

The reference has two disconnected halves: a C++ trainer that cannot
encode, and a pure-Python ``BaseTokenizer`` whose encode/decode are
``NotImplementedError`` stubs (base.py:107-109).  This class completes the
contract: state = {merges, pattern, special_tokens, vocab}
(base.py:98-104), encode = lowest-rank-first merge substitution with
left-to-right overlap consumption (base.py:22-36), both reference model
formats read/written (binary triples bpe.cpp:722-731; "shredword v1"
text base.py:111-149).

Backends:
  - "cpu": native C++ rank-loop encoder with a word memo cache
  - "device": batched encoder on JAX's default device
    (ops/encode_ops.py); thousands of chunks advance in one
    ``lax.while_loop`` dispatch
"""

from __future__ import annotations

import unicodedata

import numpy as np

from . import pretokenize, serialization
from .errors import DecodeError, EncodeError

_REPLACEMENT = "�"


def replace_control_characters(s: str) -> str:
    """Escape control characters for vocab dumps (base.py:83-90)."""
    out = []
    for ch in s:
        if unicodedata.category(ch)[0] != "C":
            out.append(ch)
        else:
            out.append(f"\\u{ord(ch):04x}")
    return "".join(out)


def render_token(t: bytes) -> str:
    """Human-readable token rendering (base.py:92-96)."""
    return replace_control_characters(t.decode("utf-8", errors="replace"))


def get_stats(ids, counts=None):
    """Adjacent-pair counts over an id sequence (reference helper,
    base.py:10-20): dict (a, b) -> count, optionally accumulating into
    `counts`."""
    counts = {} if counts is None else counts
    for pair in zip(ids, ids[1:]):
        counts[pair] = counts.get(pair, 0) + 1
    return counts


def merge(ids, pair, idx):
    """Substitute every occurrence of `pair` with `idx`, consuming
    overlapping runs left-to-right (reference helper, base.py:22-36 —
    the semantics the trainers and encoder replicate)."""
    out = []
    i = 0
    while i < len(ids):
        if (i + 1 < len(ids) and ids[i] == pair[0]
                and ids[i + 1] == pair[1]):
            out.append(idx)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out


def build_vocab(merges, special_tokens=None):
    """id -> bytes over the 256-byte base + merges + specials
    (reference helper, base.py:60-79).  Components outside the known id
    range (e.g. the faithful engine's unk-involving merges,
    docs/CONFORMANCE.md §3) contribute no bytes — mirroring the
    reference C++ bpe_save tolerance."""
    vocab = {i: bytes([i]) for i in range(256)}
    for m, (a, b) in enumerate(merges):
        vocab[256 + m] = vocab.get(int(a), b"") + vocab.get(int(b), b"")
    for tok, idx in (special_tokens or {}).items():
        vocab[idx] = tok.encode("utf-8")
    return vocab


class Tokenizer:
    def __init__(self, merges: np.ndarray | None = None, pattern: str = "",
                 special_tokens: dict[str, int] | None = None,
                 backend: str = "cpu"):
        self._merges = (np.zeros((0, 2), np.int32) if merges is None
                        else np.asarray(merges, np.int32).reshape(-1, 2))
        self._pattern = pattern
        self._special_tokens: dict[str, int] = dict(special_tokens or {})
        self.backend = backend
        self._native = None
        self._table = None
        self._flat_vocab = None
        self._rebuild()

    # ------------------------------------------------------------------
    # mutable model state (reference README.md:66-71,90-99: "View or set
    # the merge rules / pattern / special_tokens") — assigning any of
    # these rebuilds the vocab and invalidates the encode/decode caches,
    # so set-then-encode never uses a stale model.
    # ------------------------------------------------------------------

    @property
    def merges(self) -> np.ndarray:
        return self._merges

    @merges.setter
    def merges(self, value) -> None:
        self._merges = (np.zeros((0, 2), np.int32) if value is None
                        else np.asarray(value, np.int32).reshape(-1, 2))
        self._rebuild()

    @property
    def pattern(self) -> str:
        return self._pattern

    @pattern.setter
    def pattern(self, value: str) -> None:
        self._pattern = value or ""

    @property
    def special_tokens(self) -> dict[str, int]:
        return self._special_tokens

    @special_tokens.setter
    def special_tokens(self, value) -> None:
        self._special_tokens = dict(value or {})
        self._rebuild()

    # ------------------------------------------------------------------
    # vocab
    # ------------------------------------------------------------------

    def _rebuild(self) -> None:
        # the constructor/load path must enforce the same id-collision
        # rule as register_special_tokens: a special id inside the
        # byte+merge range would silently clobber a real token
        limit = 256 + len(self.merges)
        for name, idx in self.special_tokens.items():
            if idx < limit:
                raise EncodeError(
                    f"special token {name!r} id {idx} collides with "
                    f"merge ids (< {limit})")
        self.vocab = build_vocab(self.merges, self.special_tokens)
        self._inverse_special = {v: k for k, v in self.special_tokens.items()}
        self._native = None
        self._table = None
        self._flat_vocab = None

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.special_tokens)

    def register_special_tokens(self, special: dict[str, int]) -> None:
        for name, idx in special.items():
            if idx < 256 + len(self.merges):
                raise EncodeError(
                    f"special token id {idx} collides with merge ids "
                    f"(< {256 + len(self.merges)})")
        self.special_tokens.update(special)
        self._rebuild()

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------

    def _chunks(self, text: str) -> list[bytes]:
        if self.pattern:
            return [c.encode("utf-8")
                    for c in pretokenize.regex_split(text, self.pattern)]
        return pretokenize.whitespace_keep_split(text.encode("utf-8"))

    def _encode_chunks_cpu(self, chunks: list[bytes]) -> np.ndarray:
        from .runtime.native import NativeEncoder
        if self._native is None:
            self._native = NativeEncoder(self.merges)
        flat = b"".join(chunks)
        offsets = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum([len(c) for c in chunks], out=offsets[1:])
        word_bytes = np.frombuffer(flat, np.uint8)
        return self._native.encode_words(word_bytes, offsets)

    def _encode_chunks_device(self, chunks: list[bytes]) -> np.ndarray:
        return self._encode_groups_device(chunks, [0, len(chunks)])[0]

    def _encode_groups_device(self, chunks: list[bytes],
                              bounds) -> list[np.ndarray]:
        """Device encode of chunk groups (one output array per group —
        e.g. one group per document), all groups in ONE dispatch.
        Chunks longer than MAX_TW_LEN (rare after pre-tokenization) are
        spliced in via the flat-stream path."""
        from .ops import encode_ops
        if self._table is None:
            self._table = {}
        v = 256 + len(self.merges)
        lens = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
        if len(chunks) == 0 or lens.max(initial=0) <= encode_ops.MAX_TW_LEN:
            flat = np.frombuffer(b"".join(chunks), np.uint8)
            return encode_ops.encode_stream(flat, lens, self.merges, v,
                                            bounds, self._table)
        if "flat" not in self._table:
            self._table["flat"] = encode_ops.build_merge_table(self.merges)
        out: list[np.ndarray] = []
        for gi in range(len(bounds) - 1):
            parts: list[np.ndarray] = []
            seg: list[bytes] = []
            for c in chunks[bounds[gi]:bounds[gi + 1]]:
                if len(c) <= encode_ops.MAX_TW_LEN:
                    seg.append(c)
                    continue
                if seg:
                    sl = np.fromiter((len(s) for s in seg), np.int64,
                                     len(seg))
                    parts.append(encode_ops.encode_stream(
                        np.frombuffer(b"".join(seg), np.uint8), sl,
                        self.merges, v, None, self._table)[0])
                    seg = []
                parts.append(encode_ops.encode_chunks(
                    [c], self._table["flat"]))
            if seg:
                sl = np.fromiter((len(s) for s in seg), np.int64, len(seg))
                parts.append(encode_ops.encode_stream(
                    np.frombuffer(b"".join(seg), np.uint8), sl,
                    self.merges, v, None, self._table)[0])
            out.append(np.concatenate(parts).astype(np.int32)
                       if parts else np.zeros(0, np.int32))
        return out

    @staticmethod
    def _ws_chunk_lens(arr: np.ndarray) -> np.ndarray:
        """Vectorized whitespace-keep chunk lengths (alternating word /
        whitespace runs — whitespace_keep_split semantics over bytes)."""
        if len(arr) == 0:
            return np.zeros(0, np.int64)
        ws = (arr == 32) | (arr == 9) | (arr == 13) | (arr == 10)
        cut = np.nonzero(ws[1:] != ws[:-1])[0] + 1
        return np.diff(np.concatenate([[0], cut, [len(arr)]]))

    def _encode_text_device(self, data: bytes) -> np.ndarray:
        """Whole-text device encode: one fused native pass chunks AND
        dedups the raw bytes, the device encodes unique chunks, a
        native memcpy pass expands the ids (encode_ops.encode_ws_text)."""
        from .ops import encode_ops
        if self._table is None:
            self._table = {}
        out = encode_ops.encode_ws_text(
            np.frombuffer(data, np.uint8), self.merges,
            256 + len(self.merges), self._table)
        if out is None:   # a chunk beyond MAX_TW_LEN: splice path
            chunks = pretokenize.whitespace_keep_split(data)
            return self._encode_groups_device(chunks, [0, len(chunks)])[0]
        return out

    def encode_ordinary(self, text: str) -> list[int]:
        """Encode ignoring special tokens."""
        return self.encode_array(text).tolist()

    def encode_array(self, text: str) -> np.ndarray:
        """Encode ignoring special tokens; returns int32 numpy ids.

        The array form skips the list materialization (2.3M Python ints
        per 4 MB of text) — use it for bulk pipelines, and pass the
        array straight to decode/decode_bytes.
        """
        if not text:
            return np.zeros(0, np.int32)
        if not self.pattern and self.backend == "cpu":
            # fast path: whole-text native encode (the whitespace-keep
            # chunking runs inside the C++ pass — no per-chunk Python)
            from .runtime.native import NativeEncoder
            if self._native is None:
                self._native = NativeEncoder(self.merges)
            return self._native.encode_text(text.encode("utf-8"))
        if not self.pattern and self.backend == "device":
            return self._encode_text_device(text.encode("utf-8"))
        if self.pattern in ("gpt", pretokenize.PATTERN_GPT):
            # byte-level fast path: native GPT scanner gives chunk
            # offsets directly — no per-chunk Python strings
            data = text.encode("utf-8")
            starts = pretokenize.gpt_starts_bytes(data)
            lens = np.diff(np.concatenate([starts, [len(data)]]))
            from .ops import encode_ops
            if self.backend == "device" and len(lens) \
                    and lens.max() <= encode_ops.MAX_TW_LEN:
                if self._table is None:
                    self._table = {}
                arr = np.frombuffer(data, np.uint8)
                return encode_ops.encode_stream(
                    arr, lens, self.merges, 256 + len(self.merges),
                    None, self._table)[0]
            if self.backend == "cpu":
                from .runtime.native import NativeEncoder
                if self._native is None:
                    self._native = NativeEncoder(self.merges)
                offsets = np.concatenate(
                    [starts, [len(data)]]).astype(np.int64)
                return self._native.encode_words(
                    np.frombuffer(data, np.uint8), offsets)
        chunks = self._chunks(text)
        if not chunks:
            return np.zeros(0, np.int32)
        if self.backend == "device":
            return self._encode_chunks_device(chunks)
        return self._encode_chunks_cpu(chunks)

    def encode(self, text: str, allowed_special="none_raise") -> list[int]:
        """Encode with special-token handling.

        allowed_special: "all" | "none" | "none_raise" | set[str].
        "none_raise" (default) raises if a registered special token occurs
        in the text — the safe default for untrusted input.
        """
        if allowed_special == "all":
            allowed = set(self.special_tokens)
        elif allowed_special == "none":
            allowed = set()
        elif allowed_special == "none_raise":
            allowed = set()
            for s in self.special_tokens:
                if s in text:
                    raise EncodeError(
                        f"text contains special token {s!r}; pass "
                        f"allowed_special='all' or an explicit set")
        elif isinstance(allowed_special, (set, frozenset, list, tuple)):
            allowed = set(allowed_special)
        else:
            raise EncodeError(
                f"allowed_special must be 'all'|'none'|'none_raise'|set, "
                f"got {allowed_special!r}")
        if not allowed:
            return self.encode_ordinary(text)
        ids: list[int] = []
        for is_special, part in pretokenize.split_special(
                text, self.special_tokens, allowed):
            if is_special:
                ids.append(self.special_tokens[part])
            else:
                ids.extend(self.encode_ordinary(part))
        return ids

    def encode_batch(self, texts: list[str],
                     allowed_special="none_raise") -> list[list[int]]:
        """Encode many texts.  On the device backend all texts' chunks are
        concatenated into ONE flat-stream device dispatch (the whole
        batch advances in a single lax.while_loop) and split back by
        chunk ownership afterwards."""
        if self.backend != "device" or self.special_tokens or not texts:
            return [self.encode(t, allowed_special) for t in texts]
        return [g.tolist()
                for g in self.encode_batch_arrays(texts, allowed_special)]

    def encode_batch_arrays(self, texts: list[str],
                            allowed_special="none_raise"
                            ) -> list[np.ndarray]:
        """encode_batch returning int32 numpy arrays — skips the
        per-id Python list materialization (2.3M PyLong boxes per 4 MB
        of text); use for bulk pipelines, ids feed decode directly."""
        if self.backend != "device" or self.special_tokens or not texts:
            return [np.asarray(self.encode(t, allowed_special), np.int32)
                    for t in texts]
        from .ops import encode_ops
        if not self.pattern:
            # vectorized whitespace chunking across the whole batch:
            # one numpy pass + one encode_stream dispatch
            arrs = [np.frombuffer(t.encode("utf-8"), np.uint8)
                    for t in texts]
            lens_per = [self._ws_chunk_lens(a) for a in arrs]
            lens = (np.concatenate(lens_per) if arrs
                    else np.zeros(0, np.int64))
            if lens.max(initial=0) <= encode_ops.MAX_TW_LEN:
                if self._table is None:
                    self._table = {}
                bounds = np.zeros(len(texts) + 1, np.int64)
                np.cumsum([len(x) for x in lens_per], out=bounds[1:])
                flat = (np.concatenate(arrs) if arrs
                        else np.zeros(0, np.uint8))
                return encode_ops.encode_stream(
                    flat, lens, self.merges, 256 + len(self.merges),
                    bounds, self._table)
        chunks: list[bytes] = []
        n_chunks_per_text = []
        for t in texts:
            c = self._chunks(t) if t else []
            chunks.extend(c)
            n_chunks_per_text.append(len(c))
        if not chunks:
            return [np.zeros(0, np.int32) for _ in texts]
        bounds = np.zeros(len(texts) + 1, np.int64)
        np.cumsum(n_chunks_per_text, out=bounds[1:])
        return list(self._encode_groups_device(chunks, bounds))

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode_table(self):
        """Flat vocab byte buffer + offsets for vectorized decode.  Slot
        vocab_size is the replacement token; ids outside the table map
        there."""
        if self._flat_vocab is None:
            n = max(self.vocab, default=-1) + 1
            pieces = [self.vocab.get(i, b"") for i in range(n)]
            pieces.append(_REPLACEMENT.encode("utf-8"))
            known = np.zeros(n + 1, bool)
            known[:n] = [i in self.vocab for i in range(n)]
            lens = np.fromiter((len(p) for p in pieces), np.int64, n + 1)
            off = np.zeros(n + 2, np.int64)
            np.cumsum(lens, out=off[1:])
            flat = np.frombuffer(b"".join(pieces), np.uint8)
            self._flat_vocab = (flat, off, lens, known, n)
        return self._flat_vocab

    def decode_bytes(self, ids, errors: str = "strict") -> bytes:
        """ids -> bytes, vectorized (one table gather, no per-id Python).

        errors: "strict" raises on unknown ids, "replace" substitutes
        U+FFFD, "ignore" drops them.
        """
        if isinstance(ids, list):
            ids = np.fromiter(ids, np.int64, len(ids))
        else:
            ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if len(ids) == 0:
            return b""
        flat, off, lens, known, n = self._decode_table()
        bad = (ids < 0) | (ids >= n)
        ok = ~bad
        ok[ok] = known[ids[ok]]
        bad = ~ok
        if bad.any():
            if errors == "strict":
                raise DecodeError(
                    f"invalid token id {int(ids[bad][0])}")
            if errors == "replace":
                ids = np.where(bad, n, ids)
            elif errors == "ignore":
                ids = ids[~bad]
            else:
                raise DecodeError(f"unknown errors mode {errors!r}")
        piece_len = lens[ids]
        total = int(piece_len.sum())
        if total == 0:
            return b""
        # native memcpy expansion (csrc/dedup.cpp shred_expand_bytes):
        # pieces are contiguous in `flat`, so piece i is
        # flat[off[i]:off[i+1]] — the same expansion pass the encoder's
        # dedup path uses, at memory bandwidth instead of numpy
        # repeat-gather speed
        from .runtime import native
        return native.expand_bytes(flat, off, ids.astype(np.int32), total)

    def decode(self, ids, errors: str = "replace") -> str:
        """ids -> text.  Byte-level errors use utf-8 'replace' so any id
        sequence decodes; id-level errors follow `errors`."""
        return self.decode_bytes(ids, errors=errors).decode(
            "utf-8", errors="replace")

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    @classmethod
    def train(cls, corpus_path: str, vocab_size: int = 8192,
              min_pair_freq: int = 2, character_coverage: float = 1.0,
              pattern: str = "", backend: str = "device",
              **trainer_kwargs) -> "Tokenizer":
        """Train from a corpus file and return a ready tokenizer.

        Defaults differ from BPETrainer's reference-parity defaults:
        full coverage and min_pair_freq=2 (general-purpose tokenization
        rather than the reference's aggressive pruning, trainer.py:6).
        """
        from .models.bpe import BPETrainer
        t = BPETrainer(target_vocab_size=vocab_size, unk_id=-1,
                       character_coverage=character_coverage,
                       min_pair_freq=min_pair_freq, backend=backend,
                       **trainer_kwargs)
        t.load_corpus(corpus_path)
        t.train()
        tok = cls(merges=t.merges, pattern=pattern)
        t.destroy()
        return tok

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def save(self, model_path: str, vocab_path: str | None = None) -> None:
        """Write the model (format by extension: '.model' binary triples
        unless it ends in '.v1.model'/'.txt') + optional debug vocab."""
        if model_path.endswith((".v1.model", ".txt")) or self.pattern \
                or self.special_tokens:
            serialization.write_model_v1(model_path, self.merges,
                                         pattern=self.pattern,
                                         special_tokens=self.special_tokens)
        else:
            serialization.write_model_binary(model_path, self.merges)
        if vocab_path is not None:
            self._save_vocab_debug(vocab_path)

    def _save_vocab_debug(self, path: str) -> None:
        """Debug vocab dump (base.py:124-133 rendering; not loadable)."""
        inverted = {256 + m: (int(a), int(b))
                    for m, (a, b) in enumerate(self.merges)}
        with open(path, "w", encoding="utf-8") as f:
            for idx in sorted(self.vocab):
                s = render_token(self.vocab[idx])
                if idx in inverted:
                    a, b = inverted[idx]
                    f.write(f"[{render_token(self.vocab[a])}]"
                            f"[{render_token(self.vocab[b])}] -> "
                            f"[{s}] {idx}\n")
                else:
                    f.write(f"[{s}] {idx}\n")

    class _HybridLoad:
        """``Tokenizer.load(path)`` constructs a new tokenizer (this
        package's classmethod shape); ``tok.load(path)`` mutates ``tok``
        in place — the reference's instance-method shape
        (base.py:135-149), where loading replaces merges/pattern/
        special_tokens on an existing object."""

        def __get__(self, obj, objtype=None):
            if obj is None:
                def load(model_path: str,
                         backend: str = "cpu") -> "Tokenizer":
                    merges, pattern, special = \
                        serialization.read_model_any(model_path)
                    return objtype(merges=merges, pattern=pattern,
                                   special_tokens=special, backend=backend)
                return load

            def load(model_path: str) -> "Tokenizer":
                merges, pattern, special = \
                    serialization.read_model_any(model_path)
                obj._merges = np.asarray(merges, np.int32).reshape(-1, 2)
                obj._pattern = pattern
                obj._special_tokens = dict(special)
                obj._rebuild()
                return obj
            return load

    load = _HybridLoad()
