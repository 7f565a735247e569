"""Table engine for BPE training: a by-word layout plus an exact pair
count table maintained by per-merge deltas, in plain ``jax.numpy`` and
``lax``.

The flat-stream engine (bpe_ops.py) pays a global sort per merge.  This
engine never sorts after initialization:

  layout   tokens as int32[L, W] — one word per column, PAD beyond each
           word; W is padded with zero-weight columns
  table    int32[V, V] exact pair counts; the pick is the row-major
           argmax over it, which is the documented lex tie-break
  step     ``merge_step``: greedy left-to-right match selection, merge,
           hole-march compaction, and the left/right neighbour delta
           vectors by exact int32 scatter-add

Delta exactness (reference bpe_merge_batch accounting, bpe.cpp:437-470):
a merge of (a,b)->N at column row r destroys pair (Lval, a) and creates
(Lval, N) with the SAME weight, where Lval is the left neighbor AFTER
earlier occurrences in the same word merged (sel[r-2] override); ditto
(b, Rval)/(N, Rval) with the PRE-merge right neighbor t[r+2].  One
delta vector per side therefore yields both the subtraction and the
addition.  The merged pair's own cell is zeroed (all occurrences merge:
the greedy overlap rule leaves none behind).

``merge_step``, ``pick_pair`` and ``apply_hist_updates`` are shared by
the single-device loop here and the sharded engines (parallel/hist.py,
parallel/giant.py).

Conformance: bit-identical merge sequences to bpe_ops.train_loop (lex
tie-break) — enforced by differential tests on random corpora.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcache import ensure_jax_cache
from .encode_ops import _shift_down_rows as _shift_down
from .encode_ops import _shift_up_rows as _shift_up

ensure_jax_cache()

PAD = -3
MAX_V = 32768         # single-device envelope: 4.3 GB int32 table
MAX_WORD_LEN = 64     # longest word (in tokens) the layout accepts
STEPS_PER_CALL = 1024  # merges per device dispatch when not checkpointing


# ---------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------

class HistCorpus(NamedTuple):
    tw: np.ndarray      # int32[L, W] tokens, PAD beyond each word
    wcount: np.ndarray  # int32[1, W] word weights (0 on padding columns)


def build_layout(tokens: np.ndarray, word_id: np.ndarray,
                 wcount: np.ndarray, max_word_len: int = MAX_WORD_LEN,
                 n_shards: int = 1) -> HistCorpus | None:
    """Pack the flat dedup stream into host arrays [L, W]; None if a
    word exceeds max_word_len (caller falls back to the flat engine).

    wcount is PER WORD (length = number of words), unlike the flat
    engine's per-position convention.  W is a multiple of 128 *
    n_shards so every shard of a word-sharded mesh gets equal columns.
    """
    if len(tokens) == 0:
        return None
    n_words = int(word_id[-1]) + 1
    lens = np.bincount(word_id, minlength=n_words)
    L = int(lens.max(initial=1))
    if L > max_word_len:
        return None
    L = max(2, 1 << int(np.ceil(np.log2(L))))
    unit = 128 * n_shards
    W = -(-n_words // unit) * unit
    tw = np.full((L, W), PAD, np.int32)
    starts = np.zeros(n_words + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    pos = np.arange(len(tokens)) - starts[word_id]
    tw[pos, word_id] = tokens
    wc = np.zeros((1, W), np.int32)
    wc[0, :n_words] = wcount
    return HistCorpus(tw, wc)


# ---------------------------------------------------------------------
# table init (once per training): exact count by scatter-add
# ---------------------------------------------------------------------

def init_hist(c: HistCorpus, unk_id, *, v: int) -> jax.Array:
    return _init_hist(jnp.asarray(c.tw), jnp.asarray(c.wcount), unk_id,
                      v=v)


@partial(jax.jit, static_argnames=("v",))
def _init_hist(tw, wcount, unk_id, *, v: int) -> jax.Array:
    L, W = tw.shape
    t = tw.reshape(-1)
    nxt = _shift_up(tw, PAD).reshape(-1)
    w = jnp.broadcast_to(wcount, (L, W)).reshape(-1)
    valid = (t >= 0) & (nxt >= 0) & (t != unk_id) & (nxt != unk_id)
    key = jnp.where(valid, t * v + nxt, v * v)
    cnt = jnp.where(valid, w, 0)
    hist = jnp.zeros(v * v + 1, jnp.int32).at[key].add(cnt, mode="drop")
    return hist[:-1].reshape(v, v)


# ---------------------------------------------------------------------
# per-merge step
# ---------------------------------------------------------------------

def _select_apply(tt, a, b, new):
    """Greedy left-to-right match selection + merge + hole-march
    compaction on the [L, W] block.  Returns (t2, sel)."""
    L = tt.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, tt.shape, 0)
    nxt = _shift_up(tt, PAD)
    m = ((tt == a) & (nxt == b)).astype(jnp.int32)

    def gbody(l, sel):                       # greedy overlap rule
        prev = _shift_down(sel, 0)
        return jnp.where(row == l, m * (1 - prev), sel)

    sel = jax.lax.fori_loop(0, L, gbody, jnp.zeros_like(tt))
    t2 = tt + sel * (new - tt)

    def hbody(_, carry):                     # hole march
        t2, hole = carry
        t_dn = _shift_up(t2, PAD)
        return t2 + hole * (t_dn - t2), _shift_down(hole, 0)

    t2, _ = jax.lax.fori_loop(0, L - 1, hbody, (t2, _shift_down(sel, 0)))
    return t2, sel


def _deltas(tt, sel, ww, new, unk, v):
    """Left/right neighbor delta vectors int32[v] (bpe_merge_batch
    accounting, reference bpe.cpp:437-470) by masked scatter-add."""
    sel2 = _shift_down(_shift_down(sel, 0), 0)
    t_up = _shift_down(tt, PAD)
    lval = t_up + sel2 * (new - t_up)        # earlier merge overrides
    rval = _shift_up(_shift_up(tt, PAD), PAD)
    wsel = sel * ww
    wl = jnp.where((lval >= 0) & (lval != unk), wsel, 0)
    wr = jnp.where((rval >= 0) & (rval != unk), wsel, 0)
    li = jnp.where(wl > 0, lval, v).ravel()
    ri = jnp.where(wr > 0, rval, v).ravel()
    dl = jnp.zeros(v, jnp.int32).at[li].add(wl.ravel(), mode="drop")
    dr = jnp.zeros(v, jnp.int32).at[ri].add(wr.ravel(), mode="drop")
    return dl, dr


def merge_step(tw, wc, a, b, new, unk, v: int):
    """Merge every (a, b) occurrence of the [L, W] block into `new`.
    Returns (merged block, left deltas, right deltas) — the deltas are
    the block's contribution only, so shards sum them."""
    t2, sel = _select_apply(tw, a, b, new)
    dl, dr = _deltas(tw, sel, wc, new, unk, v)
    return t2, dl, dr


def pick_pair(hist, min_pair_freq):
    """(count, a, b) of the lex-first most frequent pair at or above
    min_pair_freq; count 0 when none is."""
    v = hist.shape[1]
    flat = hist.reshape(-1)
    masked = jnp.where(flat >= min_pair_freq, flat, 0)
    best = jnp.argmax(masked)
    return (masked[best], (best // v).astype(jnp.int32),
            (best % v).astype(jnp.int32))


def add_col(h, c, d):
    """h[:, c] += d as a slice read-modify-write, which XLA updates in
    place in a loop-carried table (a scatter there copied the table)."""
    col = jax.lax.dynamic_slice(h, (0, c), (h.shape[0], 1))
    return jax.lax.dynamic_update_slice(h, col + d[:, None], (0, c))


def add_row(h, r, d):
    """h[r, :] += d, in place like add_col."""
    row = jax.lax.dynamic_slice(h, (r, 0), (1, h.shape[1]))
    return jax.lax.dynamic_update_slice(h, row + d[None, :], (r, 0))


def zero_cell(h, r, c, go=True):
    """h[r, c] = 0 where go, in place like add_col."""
    cell = jax.lax.dynamic_slice(h, (r, c), (1, 1))
    return jax.lax.dynamic_update_slice(h, jnp.where(go, 0, cell), (r, c))


def apply_hist_updates(hist, a, b, new, dl, dr, go=True):
    """The five exact table updates shared by every train loop:
    column a/new from the left-side vector, row b/new from the
    right-side vector, merged cell zeroed — all no-ops where `go` is
    false.

    The loops run this step unconditionally and mask it: under a
    lax.cond, XLA copies the whole [V, V] table every merge (4.3 GB at
    vocab 32768) instead of updating it in place."""
    dl = jnp.where(go, dl, 0)
    dr = jnp.where(go, dr, 0)
    hist = add_col(hist, a, -dl)
    hist = add_col(hist, new, dl)
    hist = add_row(hist, b, -dr)
    hist = add_row(hist, new, dr)
    return zero_cell(hist, a, b, go)


# ---------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------

class HistTrainState(NamedTuple):
    tw: jax.Array           # int32[L, W]
    hist: jax.Array         # int32[V, V]
    merges: jax.Array       # int32[M_max, 2]
    merge_freqs: jax.Array  # int32[M_max]
    n_merges: jax.Array     # int32
    done: jax.Array         # bool


def make_train_loop(v: int, *, target_merges: int, max_steps: int):
    """Jitted loop of up to max_steps merges; the table is updated in
    place (donated)."""

    def train_loop(ts: HistTrainState, wcount, unk_id, min_pair_freq):
        def cond_fn(carry):
            ts, steps = carry
            return ((~ts.done) & (ts.n_merges < target_merges)
                    & (steps < max_steps))

        def body_fn(carry):
            ts, steps = carry
            cnt, a, b = pick_pair(ts.hist, min_pair_freq)
            go = cnt > 0               # else: no pair left, stop
            new = 256 + ts.n_merges
            t2, dl, dr = merge_step(ts.tw, wcount, a, b, new, unk_id, v)
            hist = apply_hist_updates(ts.hist, a, b, new, dl, dr, go)
            merges = ts.merges.at[ts.n_merges].set(jnp.stack([a, b]))
            freqs = ts.merge_freqs.at[ts.n_merges].set(cnt)
            ts = HistTrainState(jnp.where(go, t2, ts.tw), hist, merges,
                                freqs, ts.n_merges + go.astype(jnp.int32),
                                ~go)
            return ts, steps + 1

        ts, _ = jax.lax.while_loop(cond_fn, body_fn, (ts, jnp.int32(0)))
        return ts

    return jax.jit(train_loop, donate_argnums=(0,))


def hist_train(tokens: np.ndarray, word_id: np.ndarray, wcount: np.ndarray,
               *, target_merges: int, unk_id: int = -1,
               min_pair_freq: int = 2, max_word_len: int = MAX_WORD_LEN,
               max_steps_per_call: int | None = None, progress_cb=None,
               lazy_final: bool = False, n_prev_merges: int = 0,
               _cache={}):
    """Full driver.  Returns (merges[M,2], freqs[M], final flat tokens,
    final word_id) — or (merges, freqs, final_fn) with lazy_final — or
    None if the vocab or a word is outside the envelope.

    Checkpoint resume: pass the REPLAYED corpus (previous merges already
    applied by the caller — models/bpe.py does this with the native
    encoder) plus ``n_prev_merges``; new ids continue at
    256 + n_prev_merges and ``target_merges`` counts from zero (total
    including the previous run).  Only new merges are returned."""
    v = -(-(256 + target_merges) // 128) * 128
    if v > MAX_V:
        return None
    c = build_layout(tokens, word_id, wcount, max_word_len)
    if c is None:
        return None
    steps = STEPS_PER_CALL if max_steps_per_call is None \
        else max_steps_per_call
    m_max = max(target_merges, 1)
    ts = HistTrainState(
        tw=jnp.asarray(c.tw), hist=init_hist(c, jnp.int32(unk_id), v=v),
        merges=jnp.zeros((m_max, 2), jnp.int32),
        merge_freqs=jnp.zeros(m_max, jnp.int32),
        n_merges=jnp.int32(n_prev_merges), done=jnp.bool_(False))
    wc = jnp.asarray(c.wcount)
    key = (v, target_merges, steps)
    if key not in _cache:
        _cache[key] = make_train_loop(v, target_merges=target_merges,
                                      max_steps=steps)
    loop = _cache[key]
    while True:
        n_before = int(ts.n_merges)
        ts = loop(ts, wc, jnp.int32(unk_id), jnp.int32(min_pair_freq))
        n_after = int(ts.n_merges)
        if progress_cb is not None:
            progress_cb(np.asarray(ts.merges)[n_prev_merges:n_after],
                        np.asarray(ts.merge_freqs)[n_prev_merges:n_after])
        if bool(ts.done) or n_after >= target_merges \
                or n_after == n_before:
            break
    n = int(ts.n_merges)
    # slots [0, n_prev_merges) were never written (resume seeds the
    # counter, not the array)
    merges = np.asarray(ts.merges)[n_prev_merges:n]
    freqs = np.asarray(ts.merge_freqs)[n_prev_merges:n]
    final_tw = ts.tw
    del ts                                   # frees the table

    def final_fn():
        """Materialize the final merged corpus (one D2H transfer)."""
        tw = np.asarray(final_tw)
        n_real_words = int(word_id[-1]) + 1   # padding columns beyond
        cols = (tw >= 0).T                    # [W, L]
        final_tokens = tw.T[cols]
        final_word_id = np.repeat(np.arange(tw.shape[1], dtype=np.int32),
                                  cols.sum(1))
        keep = final_word_id < n_real_words
        return (final_tokens[keep].astype(np.int32), final_word_id[keep])

    if lazy_final:
        return merges, freqs, final_fn
    return (merges, freqs, *final_fn())
