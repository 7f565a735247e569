"""Core device ops for BPE training — pure JAX functions over flat arrays.

Data model (replaces the reference's linked lists / chained
hash maps / heap, SURVEY.md §7):

  tokens  : int32[N]  token ids of all unique words, concatenated
  word_id : int32[N]  owning word index per position (-1 on tail padding)
  wcount  : int32[N]  occurrence count of the owning word (0 on padding)
  length  : int32     live prefix length (arrays stay fixed-shape; the
                      stream is compacted in place after every merge)

A "pair" lives at position i: (tokens[i], tokens[i+1]) when both positions
are inside the same word and i+1 < length.  Counting is exact via
lexicographic sort + segment reduction (no hashing, no collisions —
reference bpe_count_bigrams semantics, bpe.cpp:329-355, with unk pairs
excluded).  Merging applies the greedy left-to-right overlap rule of the
reference merge scan (bpe.cpp:472-482 / base.py:22-36) with a parity
trick, then compacts in place.

All shapes are static; everything jits and runs inside lax.while_loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.jaxcache import ensure_jax_cache

ensure_jax_cache()

INT32_MAX = jnp.iinfo(jnp.int32).max

# Pair keys pack as (a << PACK_SHIFT) | b when every id < 2**PACK_SHIFT
# (vocab ids are bounded by 256 + target_merges).  Packed keys keep the
# hot sort single-key/2-operand; ids >= 2**PACK_SHIFT fall back to the
# 2-key sort path automatically (see best_pair).
PACK_SHIFT = 14
PACK_LIMIT = 1 << PACK_SHIFT


class CorpusState(NamedTuple):
    tokens: jax.Array    # int32[N]
    word_id: jax.Array   # int32[N]
    wcount: jax.Array    # int32[N]
    length: jax.Array    # int32 scalar


def make_state(tokens, word_id, wcount, capacity: int) -> CorpusState:
    """Pad host arrays up to `capacity` and build a CorpusState."""
    n = tokens.shape[0]
    assert capacity >= n
    pad = capacity - n
    tokens = jnp.concatenate(
        [jnp.asarray(tokens, jnp.int32), jnp.zeros(pad, jnp.int32)])
    word_id = jnp.concatenate(
        [jnp.asarray(word_id, jnp.int32), jnp.full(pad, -1, jnp.int32)])
    wcount = jnp.concatenate(
        [jnp.asarray(wcount, jnp.int32), jnp.zeros(pad, jnp.int32)])
    return CorpusState(tokens, word_id, wcount, jnp.int32(n))


def pair_mask(state: CorpusState, unk_id) -> jax.Array:
    """valid-for-counting mask at each position i for pair (i, i+1)."""
    t = state.tokens
    nxt = jnp.roll(t, -1)
    w = state.word_id
    wn = jnp.roll(w, -1)
    idx = jnp.arange(t.shape[0], dtype=jnp.int32)
    inside = idx < state.length - 1
    same_word = (w == wn) & (w >= 0)
    not_unk = (t != unk_id) & (nxt != unk_id)
    return inside & same_word & not_unk


def pair_counts_sorted(state: CorpusState, unk_id):
    """Exact weighted pair counts via 2-key sort + segment sum.

    Returns (seg_a, seg_b, seg_count, n_pairs_bound) where segment arrays
    have length N; entries beyond the number of distinct pairs are
    (INT32_MAX, INT32_MAX, 0).  Segments are sorted ascending by (a, b),
    so argmax over seg_count picks the lexicographically smallest pair on
    ties (the documented "lex" tie-break of the device engines).
    """
    t = state.tokens
    n = t.shape[0]
    valid = pair_mask(state, unk_id)
    a = jnp.where(valid, t, INT32_MAX)
    b = jnp.where(valid, jnp.roll(t, -1), INT32_MAX)
    w = jnp.where(valid, state.wcount, 0)
    a, b, w = jax.lax.sort((a, b, w), num_keys=2)

    prev_a = jnp.concatenate([jnp.array([INT32_MAX], jnp.int32), a[:-1]])
    prev_b = jnp.concatenate([jnp.array([INT32_MAX], jnp.int32), b[:-1]])
    is_new = (a != prev_a) | (b != prev_b)
    is_new = is_new.at[0].set(True)
    seg_id = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # int32[n]

    seg_count = jax.ops.segment_sum(w, seg_id, num_segments=n)
    # representative pair per segment: scatter from segment heads only
    head_idx = jnp.where(is_new, seg_id, n)
    seg_a = jnp.full(n, INT32_MAX, jnp.int32).at[head_idx].set(a, mode="drop")
    seg_b = jnp.full(n, INT32_MAX, jnp.int32).at[head_idx].set(b, mode="drop")
    # padding/invalid segment (INT32_MAX, INT32_MAX) must not win argmax
    seg_count = jnp.where((seg_a == INT32_MAX) & (seg_b == INT32_MAX), 0,
                          seg_count)
    return seg_a, seg_b, seg_count


def pair_totals_packed(state: CorpusState, unk_id):
    """Exact weighted pair counts over packed keys, scatter-free.

    Returns (key, total, is_last): int32[N] sorted packed keys, the
    running within-segment weight sum, and a mask marking each segment's
    last position (where `total` is the segment's full count).  Padding
    and invalid positions carry key == INT32_MAX.

    Only valid when every live token id < PACK_LIMIT.  Scatter-free:
    sort + cumsum + prefix-max + one gather (this path replaces
    segment_sum + two scatters of pair_counts_sorted).
    """
    t = state.tokens
    n = t.shape[0]
    valid = pair_mask(state, unk_id)
    key = jnp.where(valid, (t << PACK_SHIFT) | jnp.roll(t, -1), INT32_MAX)
    w = jnp.where(valid, state.wcount, 0)
    key, w = jax.lax.sort((key, w), num_keys=1)

    diff = key[1:] != key[:-1]
    is_new = jnp.concatenate([jnp.ones(1, bool), diff])
    is_last = jnp.concatenate([diff, jnp.ones(1, bool)])
    cumw = jnp.cumsum(w)
    # cumsum just before each segment head, propagated across the
    # segment by a prefix max (cumw is non-decreasing, so the most
    # recent head wins) — no gather needed.
    base = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_new, cumw - w, -1))
    return key, cumw - base, is_last


def best_pair(state: CorpusState, unk_id, min_pair_freq, *,
              packed: bool = True):
    """(a, b, count) of the highest-count eligible pair; count==0 if none.

    Ties break to the lexicographically smallest (a, b): keys sort
    ascending and argmax takes the first maximum.
    """
    if packed:
        key, total, is_last = pair_totals_packed(state, unk_id)
        ok = is_last & (key != INT32_MAX) & (total >= min_pair_freq)
        masked = jnp.where(ok, total, 0)
        best = jnp.argmax(masked)
        bk = key[best]
        return bk >> PACK_SHIFT, bk & (PACK_LIMIT - 1), masked[best]
    seg_a, seg_b, seg_count = pair_counts_sorted(state, unk_id)
    eligible = seg_count >= min_pair_freq
    masked = jnp.where(eligible, seg_count, 0)
    best = jnp.argmax(masked)
    return seg_a[best], seg_b[best], masked[best]


def select_matches(state: CorpusState, a, b) -> jax.Array:
    """Greedy left-to-right non-overlapping occurrences of (a, b).

    A position matches when tokens[i]==a and tokens[i+1]==b within one
    word (NO unk exclusion: the reference merge scan matches raw ids,
    bpe.cpp:441-443).  In a run of consecutive matches (only possible when
    a==b), select every other one starting from the run head — exactly
    the reference's no-advance-after-splice behavior (bpe.cpp:480-482).
    """
    t = state.tokens
    n = t.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt = jnp.roll(t, -1)
    w = state.word_id
    same_word = (w == jnp.roll(w, -1)) & (w >= 0)
    inside = idx < state.length - 1
    match = inside & same_word & (t == a) & (nxt == b)

    def resolve_runs(match):
        # last non-match index at or before i (prefix max of masked idx)
        nm = jnp.where(match, -1, idx)
        last_nm = jax.lax.associative_scan(jnp.maximum, nm)
        run_pos = idx - last_nm - 1  # 0 for a run head
        return match & (run_pos % 2 == 0)

    # overlapping matches require t[i+1] == a == b; for a != b the match
    # set is already non-overlapping and the run scan is skipped
    return jax.lax.cond(a == b, resolve_runs, lambda m: m, match)


def apply_merge(state: CorpusState, a, b, new_id) -> tuple[CorpusState, jax.Array]:
    """Merge all selected (a, b) occurrences into new_id and compact.

    Returns (new_state, select_mask) — the mask is over PRE-merge
    positions (used by delta extraction in conformance mode).
    """
    sel = select_matches(state, a, b)
    t = jnp.where(sel, new_id, state.tokens)
    killed = jnp.roll(sel, 1).at[0].set(False)  # position i+1 of each match
    n = t.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    keep = (~killed) & (idx < state.length)

    # stream compaction as ONE stable 4-operand sort (kept elements keep
    # their relative order; killed/padding sink to the tail)
    skey = jnp.where(keep, idx, idx + n)
    _, tokens, word_id, wcount = jax.lax.sort(
        (skey, t, state.word_id, state.wcount), num_keys=1)
    new_len = jnp.sum(keep.astype(jnp.int32))
    live = idx < new_len
    tokens = jnp.where(live, tokens, 0)
    word_id = jnp.where(live, word_id, -1)
    wcount = jnp.where(live, wcount, 0)
    return CorpusState(tokens, word_id, wcount, new_len), sel


class TrainState(NamedTuple):
    corpus: CorpusState
    merges: jax.Array       # int32[M_max, 2]
    merge_freqs: jax.Array  # int32[M_max]
    n_merges: jax.Array     # int32 scalar
    done: jax.Array         # bool scalar


def train_init(corpus: CorpusState, max_merges: int,
               n_prev_merges: int = 0) -> TrainState:
    return TrainState(
        corpus=corpus,
        merges=jnp.zeros((max_merges, 2), jnp.int32),
        merge_freqs=jnp.zeros(max_merges, jnp.int32),
        n_merges=jnp.int32(n_prev_merges),
        done=jnp.bool_(False),
    )


@partial(jax.jit, static_argnames=("target_merges", "max_steps", "packed"))
def train_loop(ts: TrainState, unk_id, min_pair_freq, *, target_merges: int,
               max_steps: int, packed: bool | None = None) -> TrainState:
    """Run up to max_steps greedy merges fully on device.

    One device dispatch executes many merges (amortizing host round trips
    — the device answer to the reference's merge batching, bpe.cpp:615-629,
    but with exact per-merge count updates so the merge sequence is the
    strict greedy one).
    """
    if packed is None:
        packed = 256 + target_merges <= PACK_LIMIT

    def cond_fn(carry):
        ts, steps = carry
        return (~ts.done) & (ts.n_merges < target_merges) & (steps < max_steps)

    def body_fn(carry):
        ts, steps = carry
        a, b, cnt = best_pair(ts.corpus, unk_id, min_pair_freq,
                              packed=packed)
        no_pair = cnt == 0

        def do_merge(ts: TrainState) -> TrainState:
            new_id = 256 + ts.n_merges
            new_corpus, _ = apply_merge(ts.corpus, a, b, new_id)
            merges = ts.merges.at[ts.n_merges].set(
                jnp.stack([a, b]).astype(jnp.int32))
            freqs = ts.merge_freqs.at[ts.n_merges].set(cnt.astype(jnp.int32))
            return TrainState(new_corpus, merges, freqs, ts.n_merges + 1,
                              jnp.bool_(False))

        ts = jax.lax.cond(
            no_pair,
            lambda s: s._replace(done=jnp.bool_(True)),
            do_merge,
            ts,
        )
        return ts, steps + 1

    ts, _ = jax.lax.while_loop(cond_fn, body_fn, (ts, jnp.int32(0)))
    return ts
