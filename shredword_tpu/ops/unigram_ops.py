"""Device lattice ops for the Unigram trainer: batched forward-backward
and Viterbi over word lattices.

Layout: words padded to length L; piece lookups precomputed host-side
(runtime shred_piece_table) as int32 id tables.  The DP scans positions
with ``lax.scan`` carrying a [n_words, K] window of the last K lattice
scores — no full-lattice gathers inside the loop.  All shapes static;
scores float32 in log space with -inf for missing pieces.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcache import ensure_jax_cache

ensure_jax_cache()

NEG_INF = -jnp.inf
COUNT_LANES = 64      # partial sums per expected count (see _fb_core)


def _tables(table: np.ndarray, logp: np.ndarray):
    """From start-indexed id table [W, L, K] build scan-ready tables:

    TS[j, w, k] : log prob of piece starting at j, length k+1   (ids_s)
    TE[j, w, k] : log prob of piece ending at j+1, length k+1   (ids_e)
    """
    W, L, K = table.shape
    ids_s = np.transpose(table, (1, 0, 2))          # [L, W, K]
    ids_e = np.full_like(ids_s, -1)
    for k in range(K):                              # end j+1 = start + k+1
        ids_e[k:, :, k] = ids_s[: L - k, :, k]
    lp = np.concatenate([logp, [-np.inf]]).astype(np.float32)
    return ids_s, ids_e, lp


def _lse(x, axis):
    m = jnp.max(x, axis=axis)
    safe = jnp.where(jnp.isfinite(m), m, 0.0)
    return jnp.where(
        jnp.isfinite(m),
        safe + jnp.log(jnp.sum(jnp.exp(x - safe[..., None]), axis=axis)),
        NEG_INF)


@partial(jax.jit, static_argnames=("n_pieces",))
def _fb_device(ids_s, lp_ext, wlen, wcount, n_pieces: int):
    return _fb_core(ids_s, lp_ext, wlen, wcount, n_pieces)


def _shift_k(x, fill):
    """y[j, :, k] = x[j - k, :, k] (fill for j < k): the start->end
    reindex shared by ids_e/lp_e, as K static slices instead of a scalar
    gather over the [L, W, K] cells."""
    L, W, K = x.shape
    parts = []
    for k in range(K):
        col = x[: L - k, :, k] if k else x[:, :, k]
        if k:
            col = jnp.concatenate(
                [jnp.full((k, W), fill, x.dtype), col], axis=0)
        parts.append(col)
    return jnp.stack(parts, axis=-1)


def _fb_core(ids_s, lp_ext, wlen, wcount, n_pieces: int):
    L, W, K = ids_s.shape
    lp_s = lp_ext[jnp.where(ids_s >= 0, ids_s, n_pieces)]  # [L, W, K]
    # lp of the piece ENDING at j+1 with length k+1 = lp of the piece
    # starting at j-k — one gather + a static shift instead of a second
    # 16.8M-cell scalar gather
    lp_e = _shift_k(lp_s, NEG_INF)

    # forward: alpha[j] for j = 1..L ; window carries alpha[j-K..j-1]
    # window[:, -1] is alpha[j-1], window[:, -k] is alpha[j-k]
    win0 = jnp.full((W, K), NEG_INF).at[:, -1].set(0.0)

    def fwd(win, lp_e_j):
        # piece of length k+1 ending at j starts at j-k-1 -> win[:, -k-1]
        contrib = win[:, ::-1] + lp_e_j            # [W, K]
        a_j = _lse(contrib, axis=1)
        win = jnp.concatenate([win[:, 1:], a_j[:, None]], axis=1)
        return win, a_j

    _, alpha = jax.lax.scan(fwd, win0, lp_e)       # alpha: [L, W]
    alpha_full = jnp.concatenate([jnp.zeros((1, W)), alpha], 0)  # [L+1, W]
    alpha_n = jnp.take_along_axis(alpha_full, wlen[None, :], axis=0)[0]

    # backward: beta[j] for j = L-1..0 ; beta[wlen] = 0 per word
    j_idx = jnp.arange(L + 1)[:, None]
    beta_end0 = jnp.where(j_idx[1:] == wlen[None, :], 0.0, NEG_INF)  # [L,W]

    def bwd(win, xs):
        lp_s_j, at_end = xs
        # win[:, k] = beta[j+k+1]
        contrib = win + lp_s_j
        b_j = _lse(contrib, axis=1)
        b_j = jnp.where(at_end, 0.0, b_j)          # beta[wlen] = 0
        win = jnp.concatenate([b_j[:, None], win[:, :-1]], axis=1)
        return win, b_j

    # winb0[:, k] = beta[L + k]; beta[L] = 0 for words of length
    # exactly L (the at_end patch below only reaches j <= L-1)
    winb0 = jnp.full((W, K), NEG_INF).at[:, 0].set(
        jnp.where(wlen == L, 0.0, NEG_INF))
    at_end = (j_idx[:-1] == wlen[None, :])         # [L, W]
    _, beta_rev = jax.lax.scan(bwd, winb0, (lp_s[::-1], at_end[::-1]))
    beta = beta_rev[::-1]                          # beta[j], j = 0..L-1
    beta_full = jnp.concatenate([beta, jnp.zeros((1, W))], 0)  # [L+1, W]
    beta_full = jnp.where(j_idx == wlen[None, :], 0.0, beta_full)

    # posteriors: piece at (start j, len k+1): alpha[j] + lp + beta[j+k+1]
    a_j = alpha_full[:-1]                          # [L, W] alpha[j]
    # b_end[j, :, k] = beta_full[min(j + k + 1, L)] — a shift of beta
    # along j as K static slices, NOT a take_along_axis gather
    b_parts = []
    for k in range(K):
        sl = beta_full[k + 1:]                     # [L - k, W]
        if k:
            sl = jnp.concatenate(
                [sl, jnp.broadcast_to(beta_full[L:], (k, W))], axis=0)
        b_parts.append(sl)
    b_end = jnp.stack(b_parts, axis=-1)            # [L, W, K]
    norm = jnp.where(jnp.isfinite(alpha_n), alpha_n, 0.0)
    post = jnp.exp(a_j[:, :, None] + lp_s + b_end - norm[None, :, None])
    post = post * wcount[None, :, None]
    post = jnp.where(ids_s >= 0, post, 0.0)

    # float32 scatter-add into COUNT_LANES partial sums (by word), then
    # one sum over the lanes: a frequent piece collects up to a slab of
    # words' posteriors, and splitting that running sum keeps its
    # rounding error about COUNT_LANES times smaller
    lane = (jnp.arange(W, dtype=jnp.int32) % COUNT_LANES)[None, :, None]
    idx = jnp.where(ids_s >= 0, ids_s, n_pieces) + lane * (n_pieces + 1)
    counts = jnp.zeros(COUNT_LANES * (n_pieces + 1), jnp.float32).at[
        idx.reshape(-1)].add(post.reshape(-1))
    counts = counts.reshape(COUNT_LANES, n_pieces + 1).sum(axis=0)
    ll = jnp.sum(jnp.where(jnp.isfinite(alpha_n), alpha_n * wcount, 0.0))
    return counts[:n_pieces], ll


def _np_lse(x, axis):
    m = np.max(x, axis=axis)
    safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(over="ignore"):
        s = np.sum(np.exp(x - np.expand_dims(safe, axis)), axis=axis)
    with np.errstate(divide="ignore"):
        return np.where(np.isfinite(m), safe + np.log(s), -np.inf)


def _fb_numpy(ids_s, ids_e, lp_ext, wlen, wcount, n_pieces: int):
    """Vectorized host path — same math as _fb_device, no JAX, in
    float64: the E-step of the cpu backend and of CPU-only hosts, and the
    reference the device E-step is compared with."""
    L, W, K = ids_s.shape
    lp_s = lp_ext[np.where(ids_s >= 0, ids_s, n_pieces)]
    lp_e = lp_ext[np.where(ids_e >= 0, ids_e, n_pieces)]
    alpha = np.full((L + 1, W), -np.inf)
    alpha[0] = 0.0
    for j in range(1, L + 1):
        lo = max(0, j - K)
        win = alpha[lo:j][::-1]                      # [k], k=1..j-lo
        alpha[j] = _np_lse(win.T + lp_e[j - 1, :, :j - lo], axis=1)
    wl = wlen.astype(np.int64)
    alpha_n = alpha[wl, np.arange(W)]
    beta = np.full((L + 1, W), -np.inf)
    beta[wl, np.arange(W)] = 0.0
    for j in range(L - 1, -1, -1):
        hi = min(K, L - j)
        win = beta[j + 1:j + 1 + hi]                 # [k, W]
        cand = _np_lse(win.T + lp_s[j, :, :hi], axis=1)
        beta[j] = np.where(j == wl, 0.0, cand)
    norm = np.where(np.isfinite(alpha_n), alpha_n, 0.0)
    end = np.minimum(np.arange(L)[:, None, None] + np.arange(K) + 1, L)
    b_end = beta[end, np.arange(W)[None, :, None]]
    with np.errstate(over="ignore", invalid="ignore")\
            :
        post = np.exp(alpha[:-1, :, None] + lp_s + b_end
                      - norm[None, :, None])
    post = np.where(ids_s >= 0, post * wcount[None, :, None], 0.0)
    # bincount is the C-speed scatter-add (np.add.at costs ~1 s per 10M
    # elements; bincount with weights ~100 ms)
    counts = np.bincount(
        np.where(ids_s >= 0, ids_s, n_pieces).reshape(-1),
        weights=post.reshape(-1), minlength=n_pieces + 1)[:n_pieces + 1]
    ll = float(np.sum(np.where(np.isfinite(alpha_n), alpha_n * wcount, 0.0)))
    return counts[:n_pieces], ll


def _pow2(n: int, floor: int = 256) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


# ---------------------------------------------------------------------
# device-resident tables (the EM fast path)
# ---------------------------------------------------------------------
#
# A slab-per-round formulation pays on the HOST side: rebuilding the
# [W, L, K] piece table every EM round (O(W*L*K) substring hashes) and
# re-uploading BOTH the start- and end-indexed variants (2 * 126 MB per
# 64k-word slab per round).  The piece-id table only changes at prune
# boundaries, and then only by an id PERMUTATION (a pruned piece's cells
# become -1; survivors renumber) — so the table lives on device across
# the whole training run: uploaded once per slab, ids_e DERIVED on
# device (a K static shift of ids_s), and each prune applies a device
# gather remap.

class DeviceTable:
    """Per-slab device-resident lattice table."""

    def __init__(self, ids_s, wlen, wcount, n_words: int):
        self.ids_s = ids_s          # int32 [L, Wb, K], -1 = absent
        self.wlen = wlen            # int32 [Wb]
        self.wcount = wcount        # float32 [Wb]
        self.n_words = n_words      # live words (<= Wb)


def make_device_table(table: np.ndarray, wlen: np.ndarray,
                      wcount: np.ndarray) -> DeviceTable:
    """Upload one slab's start-indexed table (W padded to a power of
    two so every slab shares one executable)."""
    w = table.shape[0]
    wb = _pow2(w)
    ids_s = np.transpose(table, (1, 0, 2))          # [L, W, K]
    if wb != w:
        ids_s = np.pad(ids_s, ((0, 0), (0, wb - w), (0, 0)),
                       constant_values=-1)
        wlen = np.pad(np.asarray(wlen), (0, wb - w))
        wcount = np.pad(np.asarray(wcount), (0, wb - w))
    return DeviceTable(jnp.asarray(ids_s), jnp.asarray(wlen),
                       jnp.asarray(wcount.astype(np.float32)), w)


@jax.jit
def _remap_ids(ids_s, perm_ext):
    safe = jnp.where(ids_s >= 0, ids_s, perm_ext.shape[0] - 1)
    return perm_ext[safe]


def remap_device_table(dt: DeviceTable, perm: np.ndarray,
                       nb: int | None = None) -> DeviceTable:
    """Renumber piece ids after a prune: perm[old] = new id, or -1 for
    pruned pieces.  One device gather; nothing is uploaded but the
    tiny perm vector.  ``nb`` pads the perm vector to a run-constant
    bucket so every prune round reuses ONE compiled gather (each
    distinct shape costs a fresh compile)."""
    cap = max(_pow2(len(perm)) if nb is None else nb, len(perm))
    perm_ext = jnp.asarray(np.concatenate(
        [perm.astype(np.int32),
         np.full(cap - len(perm) + 1, -1, np.int32)]))
    return DeviceTable(_remap_ids(dt.ids_s, perm_ext), dt.wlen,
                       dt.wcount, dt.n_words)


@partial(jax.jit, static_argnames=("n_pieces",))
def _fb_device_resident(ids_s, lp_ext, wlen, wcount, n_pieces: int):
    """Forward-backward over a resident table (end-indexed quantities
    are derived inside _fb_core by static shifts)."""
    return _fb_core(ids_s, lp_ext, wlen, wcount, n_pieces)


def forward_backward_resident(dt: DeviceTable, logp: np.ndarray,
                              n_pieces: int, nb: int | None = None):
    """Expected counts + log likelihood from a device-resident slab.
    n_pieces buckets to a power of two (the -inf padded tail of lp_ext
    makes padded ids unreachable), so prune rounds reuse executables.

    Pass ``nb`` (a run-constant bucket, e.g. the SEED piece count's
    power of two) to share one executable across ALL prune rounds: the
    FB cost is n_pieces-independent (the lattice is [L, W, K]; only
    the final counts scatter is sized by nb), while each distinct nb
    costs a full compile."""
    nb = _pow2(n_pieces) if nb is None else max(nb, _pow2(n_pieces))
    lp_ext = np.concatenate(
        [np.asarray(logp, np.float32),
         np.full(nb - n_pieces + 1, -np.inf, np.float32)])
    counts, ll = _fb_device_resident(dt.ids_s, jnp.asarray(lp_ext),
                                     dt.wlen, dt.wcount, n_pieces=nb)
    return np.asarray(counts)[:n_pieces], float(ll)


def forward_backward(table: np.ndarray, wlen: np.ndarray,
                     wcount: np.ndarray, logp: np.ndarray, n_pieces: int,
                     backend: str = "device"):
    """Expected piece counts + corpus log likelihood.

    table: int32[W, L, K] start-indexed piece ids (-1 = absent)

    Device shapes bucket to powers of two in both W and n_pieces, so EM
    rounds and prune rounds reuse one executable instead of recompiling
    as the piece set shrinks.
    """
    if backend == "cpu":
        ids_s, ids_e, lp_ext = _tables(table, logp)
        return _fb_numpy(ids_s, ids_e, lp_ext, wlen,
                         wcount.astype(np.float64), n_pieces)
    # device path derives end-indexed quantities on device: no host
    # ids_e materialization, no second table upload
    ids_s = np.transpose(table, (1, 0, 2))
    lp_ext = np.concatenate([logp, [-np.inf]]).astype(np.float32)
    w = table.shape[0]
    wb = _pow2(w)
    nb = _pow2(n_pieces)
    if wb != w:
        pad = wb - w
        ids_s = np.pad(ids_s, ((0, 0), (0, pad), (0, 0)),
                       constant_values=-1)
        wlen = np.pad(wlen, (0, pad))
        wcount = np.pad(wcount, (0, pad))
    if nb != n_pieces:
        # lp_ext = [logp..., -inf]; keep the missing-piece slot LAST
        lp_ext = np.concatenate([lp_ext[:-1],
                                 np.full(nb - n_pieces, -np.inf,
                                         np.float32),
                                 lp_ext[-1:]])
        ids_s = np.where(ids_s >= 0, ids_s, nb)
        # _fb_device maps negatives to its own sentinel; ids are already
        # remapped, so pass them through
    dev_args = (jnp.asarray(ids_s), jnp.asarray(lp_ext),
                jnp.asarray(wlen), jnp.asarray(wcount))
    counts, ll = _fb_device(*dev_args, n_pieces=nb)
    return np.asarray(counts)[:n_pieces], float(ll)


@partial(jax.jit, static_argnames=())
def _viterbi_device(ids_s, lp_ext, wlen):
    """Per-word best-path FINAL scores + backpointers.

    Transfers are kept small: lp_e derives from the uploaded
    start-indexed table by a static shift (no ids_e upload),
    backpointers travel as int8 (k < K <= 127), and only the [W]
    final-position scores come back instead of the full [L, W] score
    lattice."""
    L, W, K = ids_s.shape
    n_ext = lp_ext.shape[0] - 1
    lp_s = lp_ext[jnp.where(ids_s >= 0, ids_s, n_ext)]
    lp_e = _shift_k(lp_s, NEG_INF)
    win0 = jnp.full((W, K), NEG_INF).at[:, -1].set(0.0)

    def step(win, lp_e_j):
        contrib = win[:, ::-1] + lp_e_j
        best_k = jnp.argmax(contrib, axis=1)
        a_j = jnp.max(contrib, axis=1)
        win = jnp.concatenate([win[:, 1:], a_j[:, None]], axis=1)
        return win, (a_j, best_k.astype(jnp.int8))

    _, (score, back) = jax.lax.scan(step, win0, lp_e)
    row = jax.lax.broadcasted_iota(jnp.int32, (L, W), 0)
    final = jnp.sum(jnp.where(row == wlen[None, :] - 1, score, 0.0),
                    axis=0)
    return final, back


def viterbi(table: np.ndarray, wlen: np.ndarray, logp: np.ndarray,
            return_scores: bool = False):
    """Batched Viterbi segmentation.  Returns list of piece-id lists
    (plus per-word best-path scores when return_scores).
    W buckets to a power of two (no per-batch-size recompiles)."""
    w = table.shape[0]
    ids_s = np.transpose(table, (1, 0, 2))          # [L, W, K]
    lp_ext = np.concatenate([logp, [-np.inf]]).astype(np.float32)
    wb = _pow2(w)
    ids_up = ids_s
    if wb != w:
        ids_up = np.pad(ids_s, ((0, 0), (0, wb - w), (0, 0)),
                        constant_values=-1)
        wlen = np.pad(np.asarray(wlen), (0, wb - w))
    final_d, back_d = _viterbi_device(
        jnp.asarray(ids_up), jnp.asarray(lp_ext), jnp.asarray(wlen))
    final_np, back = jax.device_get((final_d, back_d))
    ids_s_np = ids_s                   # [L, W, K]
    out = []
    final = np.zeros(table.shape[0])
    for w_i in range(table.shape[0]):
        n_w = int(wlen[w_i])
        final[w_i] = final_np[w_i] if n_w > 0 else 0.0
        if n_w > 0 and not np.isfinite(final[w_i]):
            if return_scores:          # caller handles unsegmentable
                out.append([])
                continue
            from ..errors import EncodeError
            raise EncodeError(
                f"word {w_i} cannot be segmented with this piece set "
                "(missing byte pieces)")
        ids = []
        j = n_w
        while j > 0:
            k = int(back[j - 1, w_i])
            start = j - (k + 1)
            ids.append(int(ids_s_np[start, w_i, k]))
            j = start
        out.append(ids[::-1])
    if return_scores:
        return out, final
    return out
