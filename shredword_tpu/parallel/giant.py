"""Table-sharded giant-vocab training: vocab to 65536 across a mesh.

The single-device table engine caps at v <= 32768 (ops/bpe_hist.py;
a dense [V, V] int32 table is 4.3 GB there and 17 GB at V = 64k).  This
engine shards BOTH axes of the problem over the mesh:

  corpus  [L, W] int32 by-word layout, words sharded over `axis`
          (the same no-halo word sharding as parallel/hist.py)
  table   [V, V] int32 sharded by ROWS: device i owns global rows
          [i*V/n, (i+1)*V/n) — 4.3 GB per device at V = 64k, n = 4

Per merge step (all inside one jitted shard_map while_loop):

  1. PICK    each device takes the lex-first argmax over its row shard;
             the global winner is resolved with three int32
             collectives (pmax freq, then pmin global row among
             frequency winners, then pmin col) — this reproduces the
             exact (freq desc, row asc, col asc) tie-break of the
             single-device engines without 64-bit packing.
  2. LOCAL   ``bpe_hist.merge_step`` on the local corpus shard (greedy
             select + merge + neighbor deltas, bpe_merge_batch
             accounting, reference bpe.cpp:437-470)
  3. REDUCE  psum of the two delta vectors dl/dr int32[V] — 2*V*4
             bytes per merge (512 KB at 64k)
  4. APPLY   row-sharded table updates: every device applies the column
             a/new strips to its own rows; the devices owning rows b/new
             apply the row updates; the owner of row a zeroes the
             merged cell last (apply_hist_updates order)

Conformance: merge sequences are bit-identical to the single-device
table/flat engines at overlapping vocab sizes (tests/test_parallel.py
pattern), and shard-count-invariant by construction (integer psum).

No reference counterpart exists: the reference is single-threaded C++
(SURVEY.md §2.D); BASELINE config 5 is the sharded 64k deployment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import bpe_hist
from . import train

INT32_MAX = jnp.iinfo(jnp.int32).max
MAX_V = 65536


def build_sharded_giant_loop(mesh: Mesh, v: int, *,
                             target_merges: int, max_steps: int,
                             axis: str = "data"):
    n_shards = mesh.devices.size
    rows = v // n_shards

    def shard_body(tw, wc, hist, merges, freqs, n_merges, done,
                   unk_id, min_pair_freq):
        idx = jax.lax.axis_index(axis)
        row_base = idx * rows
        lrow = jax.lax.broadcasted_iota(jnp.int32, (rows, v), 0)
        lcol = jax.lax.broadcasted_iota(jnp.int32, (rows, v), 1)

        def cond_fn(carry):
            tw, hist, merges, freqs, n_merges, done, steps = carry
            return ((~done) & (n_merges < target_merges)
                    & (steps < max_steps))

        def body_fn(carry):
            tw, hist, merges, freqs, n_merges, done, steps = carry
            # ---- 1. pick: lex-first global argmax in 3 collectives
            lcnt, la, lb = bpe_hist.pick_pair(hist, min_pair_freq)
            la = la + row_base
            cnt = jax.lax.pmax(lcnt, axis)
            a = jax.lax.pmin(jnp.where(lcnt == cnt, la, INT32_MAX), axis)
            b = jax.lax.pmin(
                jnp.where((lcnt == cnt) & (la == a), lb, INT32_MAX),
                axis)

            # masked step, no lax.cond: see bpe_hist.apply_hist_updates
            go = cnt > 0
            new = 256 + n_merges
            # ---- 2. local merge + deltas
            t2, dl, dr = bpe_hist.merge_step(tw, wc, a, b, new, unk_id, v)
            # ---- 3. reduce (integer: order-independent, exact)
            dl = jnp.where(go, jax.lax.psum(dl, axis), 0)
            dr = jnp.where(go, jax.lax.psum(dr, axis), 0)
            # ---- 4. row-sharded apply (apply_hist_updates order)
            dl_loc = jax.lax.dynamic_slice(dl, (row_base,), (rows,))
            hist = bpe_hist.add_col(hist, a, -dl_loc)
            hist = bpe_hist.add_col(hist, new, dl_loc)
            own_b = (b >= row_base) & (b < row_base + rows)
            own_n = (new >= row_base) & (new < row_base + rows)
            own_a = go & (a >= row_base) & (a < row_base + rows)
            clb = jnp.clip(b - row_base, 0, rows - 1)
            cln = jnp.clip(new - row_base, 0, rows - 1)
            cla = jnp.clip(a - row_base, 0, rows - 1)
            hist = bpe_hist.add_row(hist, clb, jnp.where(own_b, -dr, 0))
            hist = bpe_hist.add_row(hist, cln, jnp.where(own_n, dr, 0))
            # merged cell zeroed LAST on the owner of row a
            hist = bpe_hist.zero_cell(hist, cla, b, own_a)
            merges = merges.at[n_merges].set(jnp.stack([a, b]))
            freqs = freqs.at[n_merges].set(cnt)
            return (jnp.where(go, t2, tw), hist, merges, freqs,
                    n_merges + go.astype(jnp.int32), ~go, steps + 1)

        tw, hist, merges, freqs, n_merges, done, _ = jax.lax.while_loop(
            cond_fn, body_fn,
            (tw, hist, merges, freqs, n_merges, done, jnp.int32(0)))
        return tw, hist, merges, freqs, n_merges, done

    col = P(None, axis)          # corpus: words sharded
    rowp = P(axis, None)         # table: rows sharded
    repl = P()
    fn = shard_map(
        shard_body, mesh=mesh,
        in_specs=(col, col, rowp, repl, repl, repl, repl, repl, repl),
        out_specs=(col, rowp, repl, repl, repl, repl),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_giant_train(tokens: np.ndarray, word_id: np.ndarray,
                        wcount: np.ndarray, *, mesh: Mesh,
                        target_merges: int, unk_id: int = -1,
                        min_pair_freq: int = 2,
                        max_steps_per_call: int = 256,
                        axis: str = "data", n_prev_merges: int = 0,
                        _cache={}):
    """Sharded driver for vocab beyond one device's table (v <= 65536).
    wcount is per word.  Returns (merges, freqs) or None if the layout
    does not fit.

    Checkpoint resume: the caller replays ``n_prev_merges`` merges into
    ``tokens``; the merge counter seeds at n_prev (new = 256 +
    n_merges) and the embedded init histogram covers the replayed id
    range.  Only NEW merges are returned."""
    n_shards = mesh.devices.size
    v = 256 + target_merges
    v = -(-v // (128 * n_shards)) * (128 * n_shards)   # whole row shards
    if v > MAX_V or unk_id >= 256:
        return None
    c = bpe_hist.build_layout(tokens, word_id, wcount, n_shards=n_shards)
    if c is None:
        return None
    # initial pairs live in [0, 256)^2: build the small table and embed
    # into the giant table CREATED SHARDED (a replicated [64k, 64k]
    # would be 17 GB on one device — it must never materialize whole)
    from jax.sharding import NamedSharding
    # resume: replayed ids reach 256 + n_prev_merges; cover them all
    vi = min(v, -(-max(256 + n_prev_merges, 256) // 128) * 128)
    small = bpe_hist.init_hist(c, jnp.int32(unk_id), v=vi)
    embed = jax.jit(
        lambda s: jnp.zeros((v, v), jnp.int32).at[:vi, :vi].set(s),
        out_shardings=NamedSharding(mesh, P(axis, None)))
    hist = embed(small)
    st_merges = jnp.zeros((max(target_merges, 1), 2), jnp.int32)
    st_freqs = jnp.zeros(max(target_merges, 1), jnp.int32)
    key = (train.mesh_key(mesh), v, target_merges, max_steps_per_call,
           axis)
    if key not in _cache:
        _cache[key] = build_sharded_giant_loop(
            mesh, v, target_merges=target_merges,
            max_steps=max_steps_per_call, axis=axis)
    loop = _cache[key]
    tw, wc = jnp.asarray(c.tw), jnp.asarray(c.wcount)
    merges, freqs = st_merges, st_freqs
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
