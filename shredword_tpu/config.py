"""Configuration for BPE training.

Parity with the reference `BPEConfig` (bpe.h:43-48) + Python defaults
(trainer.py:6), with the same defaulting rules as create_trainer
(bpe.cpp:124-130) — but applied explicitly and validated up front.

Note the reference's Python default `unk_id=0` collides with byte 0x00
(SURVEY.md §5); we keep it for API parity but default to -1 in our own
high-level entry points.
"""

from __future__ import annotations

import dataclasses

from .errors import ConfigError


@dataclasses.dataclass(frozen=True)
class BPEConfig:
    target_vocab_size: int = 8192
    unk_id: int = -1
    character_coverage: float = 0.995
    min_pair_freq: int = 2000

    # device-trainer knobs (no reference counterpart)
    merges_per_device_call: int = 64    # on-device merge steps per host loop
                                        # (smaller chunks let re-compaction
                                        # shrink the stream sooner; dispatch
                                        # overhead is ~ms per chunk)
    compact_every: int = 64             # host-side re-compactions (steps)
    tie_break: str = "lex"              # "lex" | "faithful" (CPU selector)
    backend: str = "device"             # "device" (JAX's default device)
                                        # | "cpu" (native faithful engine)
    engine: str = "auto"                # "auto" | "hist" | "giant" |
                                        # "flat" — device merge-loop
                                        # engine (hist and giant both
                                        # name the pair-table engine,
                                        # vocab <= 32768; flat = the
                                        # sort-based stream; auto routes
                                        # by device and vocab)
    checkpoint_path: str | None = None  # mid-training checkpoint file
    checkpoint_every: int = 0           # merges between checkpoints (0=off)
    shards: int = 0                     # data-parallel corpus shards over a
                                        # device mesh (0/1 = single device;
                                        # merge sequence stays bit-identical
                                        # to single-device training)

    def normalized(self) -> "BPEConfig":
        """Apply reference defaulting rules (bpe.cpp:124-130)."""
        cov = self.character_coverage
        if cov <= 0.0 or cov >= 1.0:
            cov = 0.995
        mpf = self.min_pair_freq
        if mpf == 0:
            mpf = 2000
        return dataclasses.replace(self, character_coverage=cov,
                                   min_pair_freq=mpf)

    def validate(self) -> "BPEConfig":
        if self.target_vocab_size < 256:
            raise ConfigError(
                f"target_vocab_size must be >= 256, got {self.target_vocab_size}")
        if self.min_pair_freq < 0:
            raise ConfigError("min_pair_freq must be >= 0")
        if self.tie_break not in ("lex", "faithful"):
            raise ConfigError(f"unknown tie_break {self.tie_break!r}")
        if self.backend not in ("device", "cpu"):
            raise ConfigError(f"unknown backend {self.backend!r}")
        if self.engine not in ("auto", "hist", "giant", "flat"):
            raise ConfigError(f"unknown engine {self.engine!r}")
        if self.shards < 0:
            raise ConfigError("shards must be >= 0")
        return self.normalized()

    @property
    def target_merges(self) -> int:
        return self.target_vocab_size - 256


@dataclasses.dataclass(frozen=True)
class UnigramConfig:
    """Unigram trainer config (greenfield — the reference only ships the
    dormant normalizer/seed-vocab groundwork, normalize.h:7-12; its
    MAX_SUBWORD_LEN=16 bounds counted piece lengths to 15 and
    MAX_VOCAB_SIZE=100000 is the seed cap default here)."""

    target_vocab_size: int = 8192
    seed_size: int = 100_000
    max_piece_len: int = 15
    max_word_len: int = 32
    shrink_factor: float = 0.75
    num_em_rounds: int = 2
    backend: str = "device"

    def validate(self) -> "UnigramConfig":
        if self.target_vocab_size < 1:
            raise ConfigError("target_vocab_size must be positive")
        if not (0.1 <= self.shrink_factor < 1.0):
            raise ConfigError("shrink_factor must be in [0.1, 1)")
        if self.max_piece_len < 1 or self.max_piece_len > 15:
            raise ConfigError("max_piece_len must be in 1..15 "
                              "(reference MAX_SUBWORD_LEN cap)")
        if self.max_word_len < self.max_piece_len:
            raise ConfigError("max_word_len must be >= max_piece_len")
        if self.backend not in ("device", "cpu"):
            raise ConfigError(f"unknown backend {self.backend!r}")
        return self
