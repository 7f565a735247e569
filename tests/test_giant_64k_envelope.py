"""The 64k sharded-vocab envelope, exercised past the int16 boundary:
sharded_giant_train must produce merge ids past 32767 and consume them
(the layout is int32; the single-device table engine stops at 32768
because of its table size).

A fresh run reaching 32768 merges needs a GB-scale corpus and hours of
virtual-mesh CPU time, so the test uses the resume path instead: seed
``n_prev_merges`` just below the boundary with a synthetic corpus whose
ids sit near the int16 limit, then train the ~20 merges that cross it.
New ids 32756..32775 span the boundary, and later merges consume pairs
CONTAINING post-boundary ids (> 32767), which is the representation
being tested.  Bit-exactness oracle: the flat sharded engine (unbounded
vocab, int32 streams, same lex tie-break), resumed identically.
"""

import numpy as np

from shredword_tpu.parallel import make_mesh, sharded_giant_train, \
    sharded_train

N_PREV = 32510          # merge ids already "learned": 256..32765
TARGET = N_PREV + 14    # new ids 32766..32779 — crosses 32768


def _synthetic_corpus():
    """Two 8-token chain words whose greedy merge order is fully
    determined (freq desc, then lex): within each word the four
    original-id pairs merge first (their rows are below any new id),
    then the new-id pairs (N1,N2) and (N3,N4), then (N12,N34).  With
    N_PREV = 32510, word 1 yields new ids 32766..32772 — merge
    32771 = (32768, 32769) CONSUMES a post-int16 id, the exact
    representation under test."""
    w1 = np.arange(31000, 31008, dtype=np.int32)     # count 100
    w2 = np.arange(31100, 31108, dtype=np.int32)     # count 50
    tokens = np.concatenate([w1, w2])
    word_id = np.repeat(np.arange(2, dtype=np.int32), 8)
    counts = np.asarray([100, 50], np.int32)
    wcount = counts[word_id]
    return tokens, word_id, counts, wcount


def test_sharded_giant_crosses_int16_boundary():
    tokens, word_id, counts, wcount = _synthetic_corpus()
    mesh = make_mesh(4)

    out = sharded_giant_train(
        tokens, word_id, counts, mesh=mesh, target_merges=TARGET,
        unk_id=-1, min_pair_freq=2, n_prev_merges=N_PREV)
    assert out is not None, "64k envelope refused the layout"
    m_giant, f_giant = out
    assert len(m_giant) == 14

    # the run actually crossed the boundary: some NEW ids exceed the
    # int16 range, and some merges CONSUME a post-boundary id
    new_ids = 256 + N_PREV + np.arange(len(m_giant))
    assert new_ids.max() > 32767
    assert (m_giant > 32767).any(), \
        "no merge consumed a post-boundary id — corpus int32 path idle"

    # bit-exact vs the flat sharded engine (unbounded vocab oracle)
    m_flat, f_flat = sharded_train(
        tokens, word_id, wcount, mesh=mesh, target_merges=TARGET,
        unk_id=-1, min_pair_freq=2, n_prev_merges=N_PREV)
    np.testing.assert_array_equal(m_giant, m_flat)
    np.testing.assert_array_equal(f_giant, f_flat)
