"""Sharded Unigram EM: lattice forward-backward on data-parallel word
shards with psum-reduced expected counts.

Layout: each resident slab table [L, W, K] (ops/unigram_ops
DeviceTable) shards along the WORD axis over the `data` mesh axis —
words never span shards, so the per-shard forward-backward is exactly
the single-device computation on its word subset.  Per EM round:

  1. LOCAL  : _fb_core on this shard's [L, W/D, K] slice -> expected
              counts float32[P], log-likelihood scalar
  2. REDUCE : ``psum`` of counts + ll — one float32[P] vector
              per slab per round (the piece tables themselves never
              move after the initial sharded upload)
  3. M-step : replicated on host (identical logp on every shard)

Prune remaps run as sharding-preserving device gathers (the same
_remap_ids as single-device — elementwise over the sharded table, no
collectives).

The reference has no distributed analog (it never shipped a unigram
trainer at all, pyproject.toml:8 notwithstanding); this is the
scale-out of the trainer the package adds.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import unigram_ops
from . import train


def make_sharded_table(mesh: Mesh, table: np.ndarray, wlen: np.ndarray,
                       wcount: np.ndarray, axis: str = "data"
                       ) -> unigram_ops.DeviceTable:
    """Upload one slab's start-indexed table sharded over the word
    axis.  W pads to a power of two >= n_shards, rounded up to a
    multiple of the shard count so non-power-of-two meshes (e.g. 3 or
    6 devices) satisfy the sharding divisibility rule (pad words have
    wlen 0 / wcount 0 / all-absent cells, contributing nothing)."""
    n_shards = mesh.devices.size
    w = table.shape[0]
    wb = unigram_ops._pow2(max(w, n_shards))
    wb = -(-wb // n_shards) * n_shards
    ids_s = np.transpose(table, (1, 0, 2))          # [L, W, K]
    if wb != w:
        ids_s = np.pad(ids_s, ((0, 0), (0, wb - w), (0, 0)),
                       constant_values=-1)
        wlen = np.pad(np.asarray(wlen), (0, wb - w))
        wcount = np.pad(np.asarray(wcount), (0, wb - w))
    sh_tab = NamedSharding(mesh, P(None, axis, None))
    sh_vec = NamedSharding(mesh, P(axis))
    return unigram_ops.DeviceTable(
        jax.device_put(ids_s, sh_tab),
        jax.device_put(np.asarray(wlen, np.int32), sh_vec),
        jax.device_put(np.asarray(wcount, np.float32), sh_vec), w)


def build_sharded_fb(mesh: Mesh, n_pieces_bucket: int,
                     axis: str = "data"):
    """Compile the sharded forward-backward for one (mesh, P-bucket)."""

    def body(ids_s, lp_ext, wlen, wcount):
        counts, ll = unigram_ops._fb_core(
            ids_s, lp_ext, wlen, wcount, n_pieces_bucket)
        return (jax.lax.psum(counts, axis),
                jax.lax.psum(ll, axis))

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(None, axis, None), P(), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False)
    return jax.jit(fn)


def sharded_forward_backward(dt: unigram_ops.DeviceTable,
                             logp: np.ndarray, n_pieces: int, *,
                             mesh: Mesh, axis: str = "data",
                             nb: int | None = None, _cache={}):
    """Expected counts + log likelihood from a mesh-sharded slab.
    Same bucketing contract as forward_backward_resident: n_pieces
    rounds up to a power of two so prune epochs share executables —
    pass a run-constant ``nb`` (seed bucket) to share ONE executable
    across every prune round."""
    nb = unigram_ops._pow2(n_pieces) if nb is None \
        else max(nb, unigram_ops._pow2(n_pieces))
    lp_ext = np.concatenate(
        [np.asarray(logp, np.float32),
         np.full(nb - n_pieces + 1, -np.inf, np.float32)])
    key = (train.mesh_key(mesh), nb, axis)
    if key not in _cache:
        _cache[key] = build_sharded_fb(mesh, nb, axis)
    counts, ll = _cache[key](dt.ids_s, jnp.asarray(lp_ext),
                             dt.wlen, dt.wcount)
    return np.asarray(counts)[:n_pieces], float(ll)


def remap_sharded_table(dt: unigram_ops.DeviceTable,
                        perm: np.ndarray,
                        nb: int | None = None) -> unigram_ops.DeviceTable:
    """Prune renumbering on a sharded table: the elementwise gather
    preserves the table's sharding (XLA keeps P(None, data, None));
    only the tiny perm vector crosses the host link."""
    return unigram_ops.remap_device_table(dt, perm, nb)
