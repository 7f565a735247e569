"""Sharded table-engine training: the table engine's merge step on
data-parallel word shards with psum-reduced count deltas.

Layout: the by-word matrix [L, W] shards along the word axis over the
`data` mesh axis (words never span shards — no halo exchange).  Every
merge step:

  1. LOCAL  : ``bpe_hist.merge_step`` on this shard (match + select +
              compact + delta vectors) -> dl, dr int32[V]
  2. REDUCE : ``psum`` of the two delta vectors (integer —
              bit-deterministic regardless of shard order)
  3. APPLY  : replicated table row/col updates + argmax — identical on
              every device, so the chosen pair needs no broadcast

The pair table is replicated (V^2 int32, at most 64 MB at the v <= 4096
cap); only 2·V int32 of deltas cross the interconnect per merge — far
less than the gathered pair segments of the flat sharded path
(train.py).  Beyond the cap, parallel/giant.py shards the table rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import bpe_hist
from . import train

MAX_V = 4096


def build_sharded_hist_loop(mesh: Mesh, v: int, *, target_merges: int,
                            max_steps: int, axis: str = "data"):
    def shard_body(tw, wc, hist, merges, freqs, n_merges, done,
                   unk_id, min_pair_freq):
        def cond_fn(carry):
            tw, hist, merges, freqs, n_merges, done, steps = carry
            return ((~done) & (n_merges < target_merges)
                    & (steps < max_steps))

        def body_fn(carry):
            tw, hist, merges, freqs, n_merges, done, steps = carry
            cnt, a, b = bpe_hist.pick_pair(hist, min_pair_freq)
            go = cnt > 0               # masked step: see apply_hist_updates
            new = 256 + n_merges
            t2, dl, dr = bpe_hist.merge_step(tw, wc, a, b, new, unk_id, v)
            dl = jax.lax.psum(dl, axis)
            dr = jax.lax.psum(dr, axis)
            hist = bpe_hist.apply_hist_updates(hist, a, b, new, dl, dr, go)
            merges = merges.at[n_merges].set(jnp.stack([a, b]))
            freqs = freqs.at[n_merges].set(cnt)
            return (jnp.where(go, t2, tw), hist, merges, freqs,
                    n_merges + go.astype(jnp.int32), ~go, steps + 1)

        tw, hist, merges, freqs, n_merges, done, _ = jax.lax.while_loop(
            cond_fn, body_fn,
            (tw, hist, merges, freqs, n_merges, done, jnp.int32(0)))
        return tw, hist, merges, freqs, n_merges, done

    col = P(None, axis)
    repl = P()
    fn = shard_map(
        shard_body, mesh=mesh,
        in_specs=(col, col, repl, repl, repl, repl, repl, repl, repl),
        out_specs=(col, repl, repl, repl, repl, repl),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_hist_train(tokens: np.ndarray, word_id: np.ndarray,
                       wcount: np.ndarray, *, mesh: Mesh,
                       target_merges: int, unk_id: int = -1,
                       min_pair_freq: int = 2,
                       max_steps_per_call: int = 512,
                       axis: str = "data", n_prev_merges: int = 0,
                       _cache={}):
    """Sharded driver.  wcount is per word.  Returns (merges, freqs)
    or None if the vocab exceeds the replicated-table cap or the layout
    does not fit.

    Checkpoint resume: the caller replays the first ``n_prev_merges``
    merges into ``tokens`` host-side; the loop's merge counter seeds at
    n_prev so new ids continue at 256 + n_prev (the loop derives
    new = 256 + n_merges).  Only NEW merges are returned."""
    v = -(-(256 + target_merges) // 128) * 128
    if v > MAX_V:
        return None
    n_shards = mesh.devices.size
    c = bpe_hist.build_layout(tokens, word_id, wcount, n_shards=n_shards)
    if c is None:
        return None
    hist = bpe_hist.init_hist(c, jnp.int32(unk_id), v=v)
    key = (train.mesh_key(mesh), v, target_merges, max_steps_per_call,
           axis)
    if key not in _cache:
        _cache[key] = build_sharded_hist_loop(
            mesh, v, target_merges=target_merges,
            max_steps=max_steps_per_call, axis=axis)
    loop = _cache[key]
    tw, wc = jnp.asarray(c.tw), jnp.asarray(c.wcount)
    merges = jnp.zeros((max(target_merges, 1), 2), jnp.int32)
    freqs = jnp.zeros(max(target_merges, 1), jnp.int32)
    n_merges, done = jnp.int32(n_prev_merges), jnp.bool_(False)
    while True:
        n_before = int(n_merges)
        tw, hist, merges, freqs, n_merges, done = loop(
            tw, wc, hist, merges, freqs, n_merges, done,
            jnp.int32(unk_id), jnp.int32(min_pair_freq))
        n_after = int(n_merges)
        if bool(done) or n_after >= target_merges or n_after == n_before:
            break
    n = int(n_merges)
    return (np.asarray(merges)[n_prev_merges:n],
            np.asarray(freqs)[n_prev_merges:n])
