"""Sharded BPE training: corpus split by words across a `data` mesh axis.

Per merge step (all inside one jitted ``shard_map`` + ``lax.while_loop``):

  1. LOCAL  : sort-based aggregation of this shard's adjacent pairs into
              distinct (a, b, weight) segments — O(C/D log C/D) per device
  2. GATHER : ``all_gather`` of the aggregated segments
  3. REDUCE : replicated global sort + segment-sum + argmax — identical
              on every device, so the chosen pair needs no broadcast; the
              lexicographic tie-break matches the single-device trainer
              exactly (ops/bpe_ops.py pair_counts_sorted)
  4. APPLY  : purely local parity-scan merge + compaction (words never
              span shards, so no halo exchange is needed)

The reference has no distributed analog (single-threaded C++,
SURVEY.md §2.D); XLA collectives (NCCL on GPUs) take the place of the
absent NCCL/MPI layer.  Counts are integers end-to-end, so the
reduction is bit-deterministic regardless of shard order.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import bpe_ops

INT32_MAX = bpe_ops.INT32_MAX


def mesh_key(mesh: Mesh) -> tuple:
    """Stable cache key from mesh contents (axis names + device ids).
    id(mesh) could alias a GC'd-and-reallocated mesh with a stale
    compiled executable."""
    return (tuple(mesh.axis_names), mesh.devices.shape,
            tuple(d.id for d in mesh.devices.flat))


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} present "
                f"(platform {devs[0].platform})")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


class ShardedCorpus(NamedTuple):
    """Per-shard flat streams, stacked on a leading device axis."""

    tokens: jax.Array    # int32[D, C]
    word_id: jax.Array   # int32[D, C]  (globally unique word ids, -1 pad)
    wcount: jax.Array    # int32[D, C]
    lengths: jax.Array   # int32[D]     live prefix per shard


def shard_corpus(tokens: np.ndarray, word_id: np.ndarray,
                 wcount: np.ndarray, n_shards: int,
                 capacity: int | None = None) -> ShardedCorpus:
    """Host-side: split the flat stream at word boundaries into
    `n_shards` roughly equal spans, pad each to a common capacity."""
    n = len(tokens)
    cuts = [0]
    for s in range(1, n_shards):
        c = min(round(n * s / n_shards), n)
        # move cut forward to the next word boundary
        while 0 < c < n and word_id[c] == word_id[c - 1]:
            c += 1
        cuts.append(max(c, cuts[-1]))
    cuts.append(n)
    spans = [(cuts[i], cuts[i + 1]) for i in range(n_shards)]
    max_len = max((b - a) for a, b in spans)
    cap = capacity or max(1024, 1 << int(np.ceil(np.log2(max(max_len, 2)))))
    assert cap >= max_len
    T = np.zeros((n_shards, cap), np.int32)
    W = np.full((n_shards, cap), -1, np.int32)
    C = np.zeros((n_shards, cap), np.int32)
    L = np.zeros(n_shards, np.int32)
    for i, (a, b) in enumerate(spans):
        m = b - a
        T[i, :m] = tokens[a:b]
        W[i, :m] = word_id[a:b]
        C[i, :m] = wcount[a:b]
        L[i] = m
    return ShardedCorpus(jnp.asarray(T), jnp.asarray(W), jnp.asarray(C),
                         jnp.asarray(L))


class ShardedTrainState(NamedTuple):
    corpus: ShardedCorpus
    merges: jax.Array       # int32[M_max, 2] (replicated)
    merge_freqs: jax.Array  # int32[M_max]
    n_merges: jax.Array     # int32
    done: jax.Array         # bool


def _local_state(sc_tok, sc_wid, sc_cnt, length) -> bpe_ops.CorpusState:
    return bpe_ops.CorpusState(sc_tok, sc_wid, sc_cnt, length)


def _global_best_pair(keys, vals, min_pair_freq):
    """Replicated reduce over gathered per-shard packed segments.

    keys/vals: int32[D*C] gathered (packed pair key, local count) with
    key == INT32_MAX padding; returns (a, b, count) with the same lex
    tie-break as the single-device path.  Scatter-free: sort + cumsum +
    prefix-max + gather.
    """
    n = keys.shape[0]
    key, w = jax.lax.sort((keys, vals), num_keys=1)
    idx = jnp.arange(n, dtype=jnp.int32)
    diff = key[1:] != key[:-1]
    is_new = jnp.concatenate([jnp.ones(1, bool), diff])
    is_last = jnp.concatenate([diff, jnp.ones(1, bool)])
    cumw = jnp.cumsum(w)
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_new, idx, -1))
    base = jnp.where(seg_start > 0, cumw[jnp.maximum(seg_start - 1, 0)], 0)
    total = cumw - base
    ok = is_last & (key != INT32_MAX) & (total >= min_pair_freq)
    masked = jnp.where(ok, total, 0)
    best = jnp.argmax(masked)
    bk = key[best]
    return (bk >> bpe_ops.PACK_SHIFT, bk & (bpe_ops.PACK_LIMIT - 1),
            masked[best])


def _local_pair_segments(state: bpe_ops.CorpusState, unk_id):
    """Per-shard packed (key, count) segment summaries: each distinct
    local pair contributes exactly one entry (at its segment-last
    position); everything else is (INT32_MAX, 0)."""
    key, total, is_last = bpe_ops.pair_totals_packed(state, unk_id)
    live = is_last & (key != INT32_MAX)
    return (jnp.where(live, key, INT32_MAX),
            jnp.where(live, total, 0).astype(jnp.int32))


def _global_best_pair2(ga, gb, gv, min_pair_freq):
    """2-key variant of _global_best_pair for vocab past PACK_LIMIT
    (ids >= 2^14 cannot pack into one int32 key; the single-device flat
    engine makes the same packed/2-key switch in train_loop).  Same lex
    tie-break: segments sort ascending by (a, b), argmax takes the
    first maximum."""
    n = ga.shape[0]
    a, b, w = jax.lax.sort((ga, gb, gv), num_keys=2)
    idx = jnp.arange(n, dtype=jnp.int32)
    diff = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    is_new = jnp.concatenate([jnp.ones(1, bool), diff])
    is_last = jnp.concatenate([diff, jnp.ones(1, bool)])
    cumw = jnp.cumsum(w)
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_new, idx, -1))
    base = jnp.where(seg_start > 0, cumw[jnp.maximum(seg_start - 1, 0)], 0)
    total = cumw - base
    ok = is_last & (a != INT32_MAX) & (total >= min_pair_freq)
    masked = jnp.where(ok, total, 0)
    best = jnp.argmax(masked)
    return a[best], b[best], masked[best]


def build_sharded_train_loop(mesh: Mesh, *, target_merges: int,
                             max_steps: int, axis: str = "data",
                             packed: bool = True):
    """Returns a jitted function running up to `max_steps` merges on the
    sharded corpus in a single dispatch."""

    def shard_body(tok, wid, cnt, length, merges, freqs, n_merges, done,
                   unk_id, min_pair_freq):
        # inside shard_map: leading device dim is stripped -> [C] locals
        tok, wid, cnt = tok[0], wid[0], cnt[0]
        length = length[0]

        def cond_fn(carry):
            st, merges, freqs, n_merges, done, steps = carry
            return (~done) & (n_merges < target_merges) & (steps < max_steps)

        def body_fn(carry):
            st, merges, freqs, n_merges, done, steps = carry
            if packed:
                lk, lv = _local_pair_segments(st, unk_id)
                gk = jax.lax.all_gather(lk, axis, tiled=True)
                gv = jax.lax.all_gather(lv, axis, tiled=True)
                a, b, cnt_best = _global_best_pair(gk, gv, min_pair_freq)
            else:
                la, lb, lv = bpe_ops.pair_counts_sorted(st, unk_id)
                ga = jax.lax.all_gather(la, axis, tiled=True)
                gb = jax.lax.all_gather(lb, axis, tiled=True)
                gv = jax.lax.all_gather(lv, axis, tiled=True)
                a, b, cnt_best = _global_best_pair2(ga, gb, gv,
                                                    min_pair_freq)
            no_pair = cnt_best == 0

            def do_merge(args):
                st, merges, freqs, n_merges = args
                new_id = 256 + n_merges
                new_st, _ = bpe_ops.apply_merge(st, a, b, new_id)
                merges = merges.at[n_merges].set(
                    jnp.stack([a, b]).astype(jnp.int32))
                freqs = freqs.at[n_merges].set(cnt_best.astype(jnp.int32))
                return new_st, merges, freqs, n_merges + 1, jnp.bool_(False)

            st, merges, freqs, n_merges, done = jax.lax.cond(
                no_pair,
                lambda args: (*args, jnp.bool_(True)),
                do_merge,
                (st, merges, freqs, n_merges),
            )
            return st, merges, freqs, n_merges, done, steps + 1

        st = _local_state(tok, wid, cnt, length)
        st, merges, freqs, n_merges, done, _ = jax.lax.while_loop(
            cond_fn, body_fn,
            (st, merges, freqs, n_merges, done, jnp.int32(0)))
        return (st.tokens[None], st.word_id[None], st.wcount[None],
                st.length[None], merges, freqs, n_merges, done)

    sharded = P(axis)
    repl = P()
    fn = shard_map(
        shard_body, mesh=mesh,
        in_specs=(sharded, sharded, sharded, sharded,
                  repl, repl, repl, repl, repl, repl),
        out_specs=(sharded, sharded, sharded, sharded,
                   repl, repl, repl, repl),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_train_loop(mesh: Mesh, ts: ShardedTrainState, unk_id: int,
                       min_pair_freq: int, *, target_merges: int,
                       max_steps: int, axis: str = "data",
                       _cache={}) -> ShardedTrainState:
    packed = 256 + target_merges <= bpe_ops.PACK_LIMIT
    key = (mesh_key(mesh), target_merges, max_steps, axis, packed,
           ts.corpus.tokens.shape)
    if key not in _cache:
        _cache[key] = build_sharded_train_loop(
            mesh, target_merges=target_merges, max_steps=max_steps,
            axis=axis, packed=packed)
    fn = _cache[key]
    tok, wid, cnt, lens, merges, freqs, n_merges, done = fn(
        ts.corpus.tokens, ts.corpus.word_id, ts.corpus.wcount,
        ts.corpus.lengths, ts.merges, ts.merge_freqs, ts.n_merges, ts.done,
        jnp.int32(unk_id), jnp.int32(min_pair_freq))
    return ShardedTrainState(ShardedCorpus(tok, wid, cnt, lens),
                             merges, freqs, n_merges, done)


def sharded_train(tokens: np.ndarray, word_id: np.ndarray,
                  wcount: np.ndarray, *, mesh: Mesh | None = None,
                  target_merges: int, unk_id: int = -1,
                  min_pair_freq: int = 2,
                  max_steps_per_call: int = 256,
                  axis: str = "data",
                  n_prev_merges: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Full sharded training driver.  Returns (merges[M,2], freqs[M]).

    Checkpoint resume: the caller replays ``n_prev_merges`` merges into
    ``tokens``; the merge counter seeds at n_prev so new ids continue
    at 256 + n_prev.  Only NEW merges are returned."""
    mesh = mesh or make_mesh()
    n_shards = mesh.devices.size
    sc = shard_corpus(tokens, word_id, wcount, n_shards)
    ts = ShardedTrainState(
        corpus=sc,
        merges=jnp.zeros((max(target_merges, 1), 2), jnp.int32),
        merge_freqs=jnp.zeros(max(target_merges, 1), jnp.int32),
        n_merges=jnp.int32(n_prev_merges),
        done=jnp.bool_(False),
    )
    while True:
        n_before = int(ts.n_merges)
        ts = sharded_train_loop(mesh, ts, unk_id, min_pair_freq,
                                target_merges=target_merges,
                                max_steps=max_steps_per_call, axis=axis)
        n_after = int(ts.n_merges)
        if bool(ts.done) or n_after >= target_merges or n_after == n_before:
            break
    n = int(ts.n_merges)
    return (np.asarray(ts.merges)[n_prev_merges:n],
            np.asarray(ts.merge_freqs)[n_prev_merges:n])
