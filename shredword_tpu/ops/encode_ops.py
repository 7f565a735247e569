"""Device batch encoder — minbpe-contract BPE encoding.

Semantics (the contract implied by the reference's merges table + merge()
left-to-right overlap rule, base.py:22-36, never implemented there):
per chunk, repeatedly substitute the *lowest-rank* adjacent pair present,
consuming overlapping runs greedily left-to-right, until no adjacent pair
is a known merge.

Two formulations:

1. ``encode_tw`` (default): chunks as LANE COLUMNS of an int32[L, W]
   block — the trainer's by-word layout (bpe_hist.build_layout) applied
   to encoding.  Per device round: one dense-table gather gives every
   adjacent pair's rank, the per-chunk min is a column reduce (a chunk
   IS a column — no segment ops), greedy run selection and hole-march
   compaction are row-shift arithmetic.  No sorts, no scatters; the only
   non-elementwise op per round is the rank gather.  Rounds needed =
   max merges in any single chunk <= L - 1.

2. ``encode_flat`` (kept for >64-byte chunks and differential tests):
   flat stream + chunk-id segments, hash-probe rank lookup, sort-free
   but scatter-heavy, so far slower than encode_tw; retained because
   its chunk length is unbounded.

Both run their entire loop inside ``lax.while_loop`` in one dispatch,
with shapes bucketed to powers of two so steady state never recompiles.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcache import ensure_jax_cache

ensure_jax_cache()

RANK_INF = jnp.iinfo(jnp.int32).max


def _np_mix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # uint32 wraparound is the point of the mix; silence the warnings
    with np.errstate(over="ignore"):
        h = (a.astype(np.uint32) * np.uint32(0x9E3779B1)
             + b.astype(np.uint32) * np.uint32(0x85EBCA6B))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x045D9F3B)
        h ^= h >> np.uint32(16)
    return h


def _jnp_mix(a: jax.Array, b: jax.Array) -> jax.Array:
    h = (a.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         + b.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
    h ^= h >> jnp.uint32(16)
    h *= jnp.uint32(0x045D9F3B)
    h ^= h >> jnp.uint32(16)
    return h


class MergeTable(NamedTuple):
    """Replicated open-addressing pair->rank table (device arrays)."""

    ka: jax.Array     # int32[C] first id  (-1 = empty)
    kb: jax.Array     # int32[C] second id
    rank: jax.Array   # int32[C] merge rank (-1 = empty)
    max_probe: int    # static probe bound

    @property
    def capacity(self) -> int:
        return self.ka.shape[0]


def build_merge_table(merges: np.ndarray) -> MergeTable:
    """Host-side construction; first occurrence of a pair wins (earliest
    rank), matching the reference trainer's dense-id invariant."""
    merges = np.asarray(merges, dtype=np.int32).reshape(-1, 2)
    n = len(merges)
    cap = 64
    while cap < 2 * n + 2:
        cap *= 2
    ka = np.full(cap, -1, np.int32)
    kb = np.full(cap, -1, np.int32)
    rk = np.full(cap, -1, np.int32)
    mask = cap - 1
    max_probe = 1
    for m in range(n):
        a, b = int(merges[m, 0]), int(merges[m, 1])
        slot = int(_np_mix(np.int32(a), np.int32(b))) & mask
        probes = 1
        while rk[slot] != -1:
            if ka[slot] == a and kb[slot] == b:
                break  # duplicate pair: keep earliest rank
            slot = (slot + 1) & mask
            probes += 1
        if rk[slot] == -1:
            ka[slot], kb[slot], rk[slot] = a, b, m
            max_probe = max(max_probe, probes)
    return MergeTable(jnp.asarray(ka), jnp.asarray(kb), jnp.asarray(rk),
                      max_probe)


def lookup_ranks(table: MergeTable, a: jax.Array, b: jax.Array,
                 valid: jax.Array) -> jax.Array:
    """Vectorized pair->rank lookup; RANK_INF where absent/invalid."""
    cap = table.capacity
    mask = jnp.uint32(cap - 1)
    h = (_jnp_mix(a, b) & mask).astype(jnp.int32)

    def probe(k, carry):
        rank, done = carry
        slot = (h + k) & (cap - 1)
        ta = table.ka[slot]
        tb = table.kb[slot]
        tr = table.rank[slot]
        hit = (ta == a) & (tb == b)
        empty = tr < 0
        rank = jnp.where(hit & ~done, tr, rank)
        done = done | hit | empty
        return rank, done

    rank = jnp.full(a.shape, RANK_INF, jnp.int32)
    done = jnp.zeros(a.shape, jnp.bool_)
    rank, _ = jax.lax.fori_loop(0, table.max_probe, probe, (rank, done))
    return jnp.where(valid & (rank >= 0) & (rank < RANK_INF), rank, RANK_INF)


class EncodeState(NamedTuple):
    tokens: jax.Array    # int32[N]
    chunk_id: jax.Array  # int32[N], -1 padding
    length: jax.Array    # int32


@partial(jax.jit, static_argnames=("num_chunks",))
def encode_flat(tokens: jax.Array, chunk_id: jax.Array, length: jax.Array,
                table: MergeTable, *, num_chunks: int) -> EncodeState:
    """Encode the flat stream fully on device.  Shapes are static; the
    result's live prefix is ``length``."""
    n = tokens.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    state = EncodeState(tokens, chunk_id, length)

    def pair_ranks(st: EncodeState):
        t = st.tokens
        nxt = jnp.roll(t, -1)
        w = st.chunk_id
        valid = (idx < st.length - 1) & (w == jnp.roll(w, -1)) & (w >= 0)
        return lookup_ranks(table, t, nxt, valid), nxt

    def cond_fn(st: EncodeState):
        r, _ = pair_ranks(st)
        return jnp.any(r < RANK_INF)

    def body_fn(st: EncodeState):
        r, nxt = pair_ranks(st)
        w = st.chunk_id
        seg = jnp.where(w >= 0, w, 0)
        cmin = jax.ops.segment_min(r, seg, num_segments=num_chunks)
        match = (r < RANK_INF) & (r == cmin[seg]) & (w >= 0)
        # parity scan: greedy left-to-right within runs of matches
        nm = jnp.where(match, -1, idx)
        last_nm = jax.lax.associative_scan(jnp.maximum, nm)
        sel = match & ((idx - last_nm - 1) % 2 == 0)

        t = jnp.where(sel, 256 + r, st.tokens)
        killed = jnp.roll(sel, 1).at[0].set(False)
        keep = (~killed) & (idx < st.length)
        pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
        dest = jnp.where(keep, pos, n)
        tokens = jnp.zeros(n, jnp.int32).at[dest].set(t, mode="drop")
        chunk = jnp.full(n, -1, jnp.int32).at[dest].set(w, mode="drop")
        return EncodeState(tokens, chunk, jnp.sum(keep.astype(jnp.int32)))

    return jax.lax.while_loop(cond_fn, body_fn, state)


def _bucket(n: int, floor: int = 1024) -> int:
    """Power-of-two shape bucket: every (capacity, num_chunks) pair maps
    to one cached XLA executable instead of one per input shape."""
    cap = floor
    while cap < n:
        cap *= 2
    return cap


# ---------------------------------------------------------------------
# by-word layout encoder (the fast path)
# ---------------------------------------------------------------------

MAX_TW_LEN = 64      # chunks longer than this fall back to encode_flat


def build_rank_table(merges: np.ndarray, v: int) -> jax.Array:
    """Dense flat pair->rank table int32[v*v] ON DEVICE (only the merge
    list crosses the host link); RANK_INF = no merge.  First occurrence
    of a pair wins (earliest rank)."""
    merges = np.asarray(merges, np.int32).reshape(-1, 2)
    ok = (merges >= 0).all(1) & (merges < v).all(1)
    keys = jnp.asarray(merges[ok, 0].astype(np.int64) * v
                       + merges[ok, 1])
    ranks = jnp.asarray(np.arange(len(merges), dtype=np.int32)[ok])
    table = jnp.full(v * v, RANK_INF, jnp.int32)
    return table.at[keys].min(ranks, mode="drop")


def _shift_up_rows(x, fill):
    return jnp.concatenate([x[1:], jnp.full_like(x[:1], fill)], axis=0)


def _shift_down_rows(x, fill):
    return jnp.concatenate([jnp.full_like(x[:1], fill), x[:-1]], axis=0)


def _shift_down_n(x, s):
    return jnp.concatenate([jnp.full_like(x[:s], -1), x[:-s]], axis=0)


def _take_row(x: jax.Array, idx: jax.Array, row: jax.Array) -> jax.Array:
    """x[idx[w], w] per column w; 0 where idx is out of range.  A masked
    lane reduce, NOT take_along_axis — XLA lowers the latter to a real
    gather, while this is one elementwise pass + a row reduce."""
    return jnp.sum(jnp.where(row == idx[None, :], x, 0), axis=0)


def _encode_core(flat: jax.Array, off: jax.Array, lens: jax.Array,
                 gb: jax.Array, rank_of, L: int, out_dtype,
                 out_cap: int):
    """Device half of encode_stream: gather the [L, W] by-chunk layout
    straight from the flat byte stream (column w = bytes
    flat[off[w] : off[w]+lens[w]], -1 padded), run the merge loop,
    compact column-major, and count ids per group.
    ``rank_of(a, b, valid)`` supplies the pair->rank lookup (dense
    table or hash probe), elementwise over any shape.

    Merge-loop formulation: LOCKED-PAIR rounds with an incrementally
    maintained rank table.  The contract (base.py:22-36 applied
    lowest-rank-first) is: pick the lowest-rank pair present, replace
    ALL its occurrences left-to-right (overlapping runs consumed
    greedily), repeat.  Each column tracks a locked pair (la, lb): per
    round it merges the TOPMOST remaining occurrence of its locked pair
    (exhausting occurrences over successive rounds == the single
    left-to-right replacement pass, because a merge never creates a new
    occurrence of the merged pair — the new id exceeds both components'
    ids... and even a degenerate hand-built table terminates, since
    every round strictly shrinks the column).  When a column's locked
    pair is exhausted it relocks from its maintained rank rows in the
    SAME round (no wasted rounds).

    Why this shape: the naive formulation re-gathers pair ranks for all
    L*W cells every round, a full gather per round.  Merging one site
    per column makes every update a SINGLE row shift, so ranks shift
    along with tokens and only the two pair slots touching the merge
    site need fresh lookups: per-round gather volume drops from L*W to
    ~4*W, and the data-dependent hole-march while_loop disappears
    entirely.

    Host traffic: the raw uint8 stream + two int32[W] vectors up (the
    layout expansion happens ON DEVICE); the live id prefix — downcast
    to ``out_dtype`` (uint16 when the vocab allows) — and tiny count
    vectors down.  Nothing O(L*W) crosses the link.
    """
    W = lens.shape[0]
    lens = lens.astype(jnp.int32)
    if off is None:
        # chunks are contiguous in `flat`: offsets are the exclusive
        # cumsum of lens, computed on device (saves the int32[W] upload)
        off = jnp.cumsum(lens) - lens
    row = jax.lax.broadcasted_iota(jnp.int32, (L, W), 0)
    gidx = jnp.minimum(off[None, :] + row, flat.shape[0] - 1)
    tw = jnp.where(row < lens[None, :], flat[gidx].astype(jnp.int32), -1)

    nxt0 = _shift_up_rows(tw, -1)
    rank0 = rank_of(tw, nxt0, (tw >= 0) & (nxt0 >= 0))

    L_sent = jnp.int32(L)          # per-column "no site" sentinel

    def cond_fn(carry):
        return carry[-1]

    def body_fn(carry):
        t, rank, la, lb, lrk, _ = carry
        locked = la >= 0
        nxt = _shift_up_rows(t, -1)
        # topmost remaining occurrence of each column's locked pair —
        # pure compares, no table lookup
        m = locked[None, :] & (t == la[None, :]) & (nxt == lb[None, :])
        occ = jnp.min(jnp.where(m, row, L_sent), axis=0)        # [W]
        exhausted = locked & (occ >= L_sent)
        # relock from the maintained ranks (rank rows are current for
        # every column: they were updated by that column's last merge)
        rmin = jnp.min(rank, axis=0)                            # [W]
        can = rmin < RANK_INF
        rloc = jnp.min(jnp.where(rank == rmin[None, :], row, L_sent),
                       axis=0)
        relock = (~locked) | exhausted
        set_lock = relock & can
        la = jnp.where(set_lock, _take_row(t, rloc, row),
                       jnp.where(relock, -1, la))
        lb = jnp.where(set_lock, _take_row(t, rloc + 1, row),
                       jnp.where(relock, -1, lb))
        lrk = jnp.where(set_lock, rmin, lrk)
        site = jnp.where(relock, jnp.where(can, rloc, L_sent), occ)
        active = site < L_sent
        new_id = 256 + lrk                                      # [W]

        # merge at `site` + single-shift compaction (one fused pass):
        # t'[j<s] = t[j]; t'[s] = new; t'[j>s] = t[j+1]
        tu = _shift_up_rows(t, -1)
        t2 = jnp.where(row < site[None, :], t,
                       jnp.where(row == site[None, :], new_id[None, :],
                                 tu))
        # rank shifts identically; only the two slots touching the site
        # change: (t[s-1], new) at row s-1 and (new, t[s+2]) at row s
        ru = _shift_up_rows(rank, RANK_INF)
        rank2 = jnp.where(row < site[None, :] - 1, rank, ru)
        a_l = _take_row(t, site - 1, row)
        rank_l = rank_of(a_l, new_id, active & (site >= 1) & (a_l >= 0))
        b_r = jnp.where(site + 2 < L, _take_row(t, site + 2, row), -1)
        rank_r = rank_of(new_id, b_r, active & (b_r >= 0))
        rank2 = jnp.where(row == site[None, :] - 1, rank_l[None, :],
                         jnp.where(row == site[None, :], rank_r[None, :],
                                   rank2))
        return (t2, rank2, la, lb, lrk, jnp.any(active))

    out, _, _, _, _, _ = jax.lax.while_loop(
        cond_fn, body_fn,
        (tw, rank0, jnp.full(W, -1, jnp.int32),
         jnp.full(W, -1, jnp.int32), jnp.zeros(W, jnp.int32),
         jnp.bool_(True)))

    # column-major packing without a sort: live ids stay contiguous at
    # the top of each column (single-shift compaction), so output slot
    # i belongs to column colof[i] = (# column starts <= i) - 1, at row
    # i - start[colof[i]] — a W-scatter, a cumsum, and two out_cap
    # gathers instead of an L*W 2-array sort.
    counts = jnp.sum((out >= 0).astype(jnp.int32), axis=0)     # [W]
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(counts)])                # [W+1]
    steps = jnp.zeros(out_cap, jnp.int32).at[cum[:W]].add(
        1, mode="drop")
    colof = jnp.cumsum(steps) - 1                              # [out_cap]
    pos = jnp.arange(out_cap, dtype=jnp.int32) - cum[colof]
    ids_packed = out.reshape(-1)[
        jnp.clip(pos, 0, L - 1) * W + jnp.clip(colof, 0, W - 1)]
    gcounts = cum[gb[1:]] - cum[gb[:-1]]
    return ids_packed.astype(out_dtype), gcounts, counts.astype(jnp.int8)


def _out_dtype(v: int):
    """Smallest download dtype that holds every id < v (uint16 halves
    the device-to-host copy)."""
    return jnp.uint16 if v <= 65536 else jnp.int32


@partial(jax.jit, static_argnames=("v", "L", "out_cap"))
def _encode_device(flat: jax.Array, off: jax.Array, lens: jax.Array,
                   gb: jax.Array, table_flat: jax.Array, *, v: int,
                   L: int, out_cap: int):
    """Dense-table variant: rank lookups index int32[v*v]."""
    def rank_of(a, b, valid):
        key = jnp.where(valid, a * v + b, 0)
        return jnp.where(valid, table_flat[key], RANK_INF)

    return _encode_core(flat, off, lens, gb, rank_of, L, _out_dtype(v),
                        out_cap)


@partial(jax.jit, static_argnames=("max_probe", "v", "L", "out_cap"))
def _encode_device_hash(flat: jax.Array, off: jax.Array, lens: jax.Array,
                        gb: jax.Array, ka: jax.Array, kb: jax.Array,
                        rk: jax.Array, *, max_probe: int, v: int, L: int,
                        out_cap: int):
    """Hash-probe variant for big vocabs: the dense [v, v] table at
    v = 32k would be ~4.3 GB of device memory; the open-addressing
    MergeTable is O(len(merges)) with a handful of gathers per round."""
    def rank_of(a, b, valid):
        return lookup_ranks(MergeTable(ka, kb, rk, max_probe),
                            a, b, valid)

    return _encode_core(flat, off, lens, gb, rank_of, L, _out_dtype(v),
                        out_cap)


LEN_BUCKETS = (4, 8, 16, 32, 64)

# Above this vocab the dense v*v rank table (v*v*4 bytes; 64 MB at 4096)
# is replaced by the O(merges) hash-probe MergeTable.
DENSE_V_MAX = 4096


def _get_table(merges, v, _cache):
    if _cache is None or ("table", v) not in _cache:
        if v <= DENSE_V_MAX:
            table = build_rank_table(merges, v)
        else:
            table = build_merge_table(np.asarray(merges))
        if _cache is not None:
            _cache[("table", v)] = table
    else:
        table = _cache[("table", v)]
    return table


def _encode_block(dflat, lens, off, table, v, gbn, contiguous=False):
    """One [L, W] device call over chunks of similar length.  ``dflat``
    is the ALREADY-UPLOADED full byte stream; per block only a uint8[W]
    length vector goes up (plus an int32[W] offset vector unless the
    chunks are contiguous in the stream — then offsets are a device
    cumsum).  Returns (device packed ids, device gcounts, device
    per-chunk counts)."""
    n = len(lens)
    L = _bucket(int(lens.max(initial=1)), floor=4)
    W = _bucket(n, floor=256)
    out_cap = _bucket(int(lens.sum()), floor=1024)   # ids <= input bytes
    lens_w = np.zeros(W, np.uint8)                   # lens <= MAX_TW_LEN
    lens_w[:n] = lens
    if contiguous:
        off_d = None
    else:
        off_w = np.zeros(W, np.int32)
        off_w[:n] = off
        off_d = jnp.asarray(off_w)
    gb = np.full(_bucket(len(gbn), floor=16), n, np.int32)
    gb[:len(gbn)] = gbn
    if isinstance(table, MergeTable):
        return _encode_device_hash(
            dflat, off_d, jnp.asarray(lens_w),
            jnp.asarray(gb), table.ka, table.kb, table.rank,
            max_probe=table.max_probe, v=v, L=L, out_cap=out_cap)
    return _encode_device(dflat, off_d, jnp.asarray(lens_w),
                          jnp.asarray(gb), table, v=v, L=L,
                          out_cap=out_cap)


def _encode_all(flat: np.ndarray, lens: np.ndarray, off: np.ndarray,
                table, v: int, single_block: bool = False):
    """Encode every chunk; returns (ids int32 in chunk order,
    counts int64[n] ids per chunk).

    Chunks are split into per-length-bucket [L, W] blocks (a chunk of
    length l needs at most l-1 merge rounds, and the per-round rank
    gather is the dominant cost, so short chunks — the vast majority —
    must not ride in a tall block); ``single_block`` forces one block
    (fewer link round-trips — right when n is already small, e.g. after
    dedup).  Bucket outputs re-interleave into chunk order host-side
    from per-chunk id counts.  All shapes bucket to powers of two (no
    steady-state recompiles).
    """
    n = len(lens)
    # ONE upload of the raw stream; every block gathers its columns
    # from this device array by (offset, length)
    fcap = _bucket(max(len(flat), LEN_BUCKETS[-1]))
    fpad = np.zeros(fcap, np.uint8)
    fpad[:len(flat)] = flat
    dflat = jnp.asarray(fpad)

    maxlen = int(lens.max(initial=1))
    which = np.searchsorted(np.asarray(LEN_BUCKETS), lens)
    n_buckets = int(which.max(initial=0)) + 1
    if single_block or n_buckets <= 1 or maxlen <= LEN_BUCKETS[0]:
        ids_packed, _, counts = _encode_block(
            dflat, lens, off, table, v, np.array([0, n]),
            contiguous=True)
        # ONE transfer round for both results: the id download is
        # bounded by the host-known byte total instead of waiting a
        # round-trip for the exact count
        ub = min(int(lens.sum()), ids_packed.shape[0])
        counts_h, ids_h = jax.device_get((counts, ids_packed[:ub]))
        cb = counts_h[:n].astype(np.int64)
        ids = ids_h[: int(cb.sum())].astype(np.int32)
        return ids, cb

    # multi-bucket: encode each length class in its own short block,
    # then re-interleave by original chunk order
    dev_parts = []
    for b in range(n_buckets):
        idx = np.nonzero(which == b)[0]
        if len(idx) == 0:
            dev_parts.append(None)
            continue
        ids_packed, _, counts = _encode_block(
            dflat, lens[idx], off[idx], table, v,
            np.array([0, len(idx)]))
        ub = min(int(lens[idx].sum()), ids_packed.shape[0])
        dev_parts.append((idx, ids_packed[:ub], counts))
    # ONE transfer round after every dispatch is queued
    got = jax.device_get([(p[1], p[2]) for p in dev_parts
                          if p is not None])
    counts_full = np.zeros(n, np.int64)
    bucket_ids = {}
    gi = 0
    for b, part in enumerate(dev_parts):
        if part is None:
            continue
        idx = part[0]
        ids_h, counts_h = got[gi]
        gi += 1
        cb = counts_h[: len(idx)].astype(np.int64)
        counts_full[idx] = cb
        bucket_ids[b] = (idx, ids_h[: int(cb.sum())], cb)
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts_full, out=out_off[1:])
    total = int(out_off[-1])
    out = np.zeros(total, np.int32)
    for b, (idx, ids_b, cb) in bucket_ids.items():
        inner = np.arange(int(cb.sum())) - np.repeat(
            np.cumsum(cb) - cb, cb)
        out[np.repeat(out_off[idx], cb) + inner] = ids_b
    return out, counts_full


# dedup pays for itself once the stream repeats chunks; below this many
# chunks the hash pass + expansion overhead beats nothing
DEDUP_MIN_CHUNKS = 2048

# single-block cap for the deduped sub-problem: beyond this many [L, W]
# cells (int32), fall back to length buckets so device memory stays
# bounded and short chunks don't ride in a tall block
SINGLE_BLOCK_MAX_CELLS = 1 << 24

# prefer per-length-bucket blocks above this many chunks even when one
# block would fit: short chunks riding a tall block waste merge rounds,
# and the extra dispatches amortize once W is large (a threshold taken
# on other hardware; not re-measured on the H100)
SINGLE_BLOCK_MAX_CHUNKS = 8192

# one device call's stream window (int32 gather offsets on device)
STREAM_WINDOW_BYTES = 2 ** 31 - 2 ** 27


def _try_dedup(flat, off, lens):
    try:
        from ..runtime import native
        inverse, uniq = native.dedup_spans(flat, off, lens)
    except Exception:
        return None
    # worth it only if the stream actually repeats itself
    if len(uniq) * 2 > len(lens):
        return None
    return inverse, uniq


def _encode_counts(flat, lens, off, table, v):
    """(ids int32 in chunk order, counts int64[n]) for one <2 GiB
    window, deduplicating when the stream repeats itself."""
    n = len(lens)
    dd = _try_dedup(flat, off, lens) if n >= DEDUP_MIN_CHUNKS else None
    if dd is None:
        return _encode_all(flat, lens, off, table, v)

    # dedup path: encode unique chunks (compacted into their own small
    # flat buffer), then expand to the full stream with the native
    # memcpy pass (the numpy repeat-gather formulation cost ~0.3 s per
    # 2.3M output ids — the single largest term of the old 10 MB/s)
    inverse, uniq = dd
    lens_u = lens[uniq]
    off_u = np.zeros(len(uniq), np.int64)
    np.cumsum(lens_u[:-1], out=off_u[1:])
    src = np.repeat(off[uniq], lens_u) + (
        np.arange(int(lens_u.sum()), dtype=np.int64)
        - np.repeat(off_u, lens_u))
    Lb = _bucket(int(lens_u.max(initial=1)), floor=4)
    Wb = _bucket(len(uniq), floor=256)
    ids_u, cnt_u = _encode_all(
        flat[src], lens_u, off_u, table, v,
        single_block=(Lb * Wb <= SINGLE_BLOCK_MAX_CELLS
                      and len(lens_u) <= SINGLE_BLOCK_MAX_CHUNKS))
    from ..runtime import native
    uoff = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum(cnt_u, out=uoff[1:])
    counts_full = cnt_u[inverse]
    out = native.expand_ids(ids_u, uoff, inverse, int(counts_full.sum()))
    return out, counts_full


def encode_stream(flat: np.ndarray, lens: np.ndarray, merges: np.ndarray,
                  v: int, group_bounds: np.ndarray | None = None,
                  _cache: dict | None = None) -> list[np.ndarray]:
    """Encode a pre-chunked byte stream on device; ids per group.

    flat: uint8 bytes of all chunks, concatenated.
    lens: per-chunk byte lengths (each <= MAX_TW_LEN).
    group_bounds: int chunk-index boundaries [0, ..., n_chunks] — one
        output array per group (e.g. one group per document).  Default:
        a single group.

    Duplicate chunks (the overwhelming majority in natural text) are
    deduplicated by a native hash pass first: the device encodes each
    DISTINCT chunk once and the full id stream is a host-side gather —
    both link directions and device work shrink by the duplication
    factor.  Streams over ~2 GiB are processed in chunk-aligned windows
    (device gather offsets are int32) and stitched — group boundaries
    may span windows freely.  The dense rank table is built ON DEVICE
    and cached via `_cache`.
    """
    n = len(lens)
    lens = np.asarray(lens, np.int64)
    if group_bounds is None:
        group_bounds = np.array([0, n], np.int64)
    gbn = np.asarray(group_bounds, np.int64)
    g = len(gbn) - 1
    if n == 0:
        return [np.zeros(0, np.int32)] * g
    flat = np.asarray(flat, np.uint8)
    off = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    table = _get_table(merges, v, _cache)

    if len(flat) <= STREAM_WINDOW_BYTES:
        ids, counts = _encode_counts(flat, lens, off, table, v)
    else:
        # window the stream at chunk boundaries; per-chunk counts make
        # the final group split window-agnostic
        parts, cparts = [], []
        c0 = 0
        while c0 < n:
            c1 = int(np.searchsorted(
                off, off[c0] + STREAM_WINDOW_BYTES, side="right")) - 1
            c1 = max(c1, c0 + 1)
            w_off = off[c0:c1] - off[c0]
            w_end = int(off[c1]) if c1 < n else len(flat)
            ids_w, cnt_w = _encode_counts(
                flat[int(off[c0]):w_end], lens[c0:c1], w_off, table, v)
            parts.append(ids_w)
            cparts.append(cnt_w)
            c0 = c1
        ids = np.concatenate(parts)
        counts = np.concatenate(cparts)

    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=out_off[1:])
    return np.split(ids, out_off[gbn[1:-1]]) if g > 1 else [ids]


def encode_ws_text(flat: np.ndarray, merges: np.ndarray, v: int,
                   _cache: dict | None = None) -> np.ndarray | None:
    """Whole-text device encode over whitespace-keep chunking, fully
    fused host side: ONE native pass chunks the raw stream and
    deduplicates the chunks (csrc/dedup.cpp shred_ws_chunk_dedup), the
    device encodes each DISTINCT chunk once, and the native memcpy pass
    expands the unique ids back to the full stream.  Returns None when
    a chunk exceeds MAX_TW_LEN (caller falls back to the splice path).
    """
    from ..runtime import native
    flat = np.ascontiguousarray(flat, np.uint8)
    inverse, uoff_b, ulen = native.ws_chunk_dedup(flat)
    if len(inverse) == 0:
        return np.zeros(0, np.int32)
    if int(ulen.max(initial=0)) > MAX_TW_LEN:
        return None
    table = _get_table(merges, v, _cache)
    lens_u = ulen.astype(np.int64)
    off_u = np.zeros(len(lens_u), np.int64)
    np.cumsum(lens_u[:-1], out=off_u[1:])
    src = np.repeat(uoff_b, lens_u) + (
        np.arange(int(lens_u.sum()), dtype=np.int64)
        - np.repeat(off_u, lens_u))
    Lb = _bucket(int(lens_u.max(initial=1)), floor=4)
    Wb = _bucket(len(lens_u), floor=256)
    ids_u, cnt_u = _encode_all(
        flat[src], lens_u, off_u, table, v,
        single_block=(Lb * Wb <= SINGLE_BLOCK_MAX_CELLS
                      and len(lens_u) <= SINGLE_BLOCK_MAX_CHUNKS))
    uoff = np.zeros(len(cnt_u) + 1, np.int64)
    np.cumsum(cnt_u, out=uoff[1:])
    total = int(cnt_u[inverse].sum())
    return native.expand_ids(ids_u, uoff, inverse, total)


def encode_chunks(chunks: list[bytes], table: MergeTable,
                  capacity: int | None = None,
                  return_chunk_ids: bool = False):
    """Host convenience: encode a list of byte chunks, return flat ids
    (optionally with each output id's chunk index).

    Shapes are bucketed to powers of two (tokens >= 1024, chunks >= 64)
    so steady-state encoding never recompiles — the trainer's _bucket
    discipline (models/bpe.py:36) applied to the encoder.
    """
    if not chunks:
        ids = np.zeros(0, np.int32)
        return (ids, ids) if return_chunk_ids else ids
    lens = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
    total = int(lens.sum())
    cap = capacity or _bucket(total)
    flat = np.frombuffer(b"".join(chunks), np.uint8).astype(np.int32)
    cid = np.repeat(np.arange(len(chunks), dtype=np.int32), lens)
    tokens = np.zeros(cap, np.int32)
    tokens[:total] = flat
    chunk_id = np.full(cap, -1, np.int32)
    chunk_id[:total] = cid
    st = encode_flat(jnp.asarray(tokens), jnp.asarray(chunk_id),
                     jnp.int32(total), table,
                     num_chunks=_bucket(len(chunks), floor=64))
    n_out = int(st.length)
    ids = np.asarray(st.tokens)[:n_out]
    if return_chunk_ids:
        return ids, np.asarray(st.chunk_id)[:n_out]
    return ids
