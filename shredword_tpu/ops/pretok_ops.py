r"""Vectorized GPT-pattern pre-tokenizer (BASELINE config 4).

The reference documents the GPT-style split pattern as data
(base.py:41-56; pretokenize.PATTERN_GPT) and applies it with the host
`regex` module.  This module replaces the backtracking engine with
byte-class arithmetic: analysis of the pattern shows every alternative
is decidable from character-class RUNS with at most two characters of
lookahead, so the whole split is a fixed pipeline of vectorized ops —
the "byte-class DFA" of the north star with the DFA folded into
closed-form run logic.  Pattern alternatives and their closed forms
(all boundaries are MATCH STARTS; a chunk spans start[i]..start[i+1]):

  1. ``'(?i:[sdmt]|ll|ve|re)``  fires at an apostrophe whose suffix
     matches and whose PREVIOUS char is not punct/apostrophe/space
     (those consume the apostrophe first via alts 4/2).
  2. ``[^\r\n\p{L}\p{N}]?+\p{L}+``  a letter run is one chunk; it
     absorbs a single preceding prefix char when that char is a lone
     punct (a length-1 punct run not itself space-prefixed) or any
     space/tab-class whitespace.
  3. ``\p{N}{1,3}``  digit runs split into blocks of 3 anchored at the
     run start (nothing else can consume digits).
  4. `` ?[^\s\p{L}\p{N}]++[\r\n]*``  a punct run is one chunk (the
     possessive ++ forbids splitting), absorbing one preceding space
     and ALL following newline chars.
  5. ``\s*[\r\n]``  a whitespace run is consumed up to its LAST
     newline (greedy \s* backtracks to the final [\r\n]).
  6. ``\s+(?!\S)``  the newline-free remainder: whole at EOF, else all
     but ONE char — the leftover attaches to the next chunk as an
     alt-2/4 prefix or stands alone.
  7. ``\s+``  whatever remains (single whitespace before a non-letter).

Character classes are GROUND TRUTH: every Unicode codepoint is
classified by the `regex` module's own ``\p{L}``/``\p{N}``/``\s`` and
the case-insensitive contraction letters (e.g. U+017F LONG S matches
``(?i:s)``).  The table ships as run-length data (gpt_classes.npz, a
few KB), so the GPT pattern needs no regex engine at run time;
tests/test_pretok_dfa.py rebuilds it with the `regex` module, checks it,
and regenerates the file when run as a script.  Codepoints come from
the text via a zero-copy utf-32 view, so the hot path is pure
vectorized numpy.  Exactness is enforced by differential tests
against ``pretokenize.regex_split`` on adversarial and fuzzed inputs.
"""

from __future__ import annotations

import os

import numpy as np

# class ids
C_OTHER = 0       # matches [^\s\p{L}\p{N}], not apostrophe
C_SPACE = 1       # ' '
C_WS = 2          # \s except space/\r/\n
C_CR = 3
C_LF = 4
C_DIGIT = 5
C_LETTER = 6      # letters with no contraction role
C_APO = 7         # '
C_S, C_D, C_M, C_T, C_L, C_V, C_R, C_E = 8, 9, 10, 11, 12, 13, 14, 15

MAX_CP = 0x110000
TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "gpt_classes.npz")
_TABLE: np.ndarray | None = None


def class_table() -> np.ndarray:
    """int8[MAX_CP] class id of every codepoint, expanded from the
    shipped runs (``starts[i]`` opens a run of ``classes[i]``)."""
    global _TABLE
    if _TABLE is None:
        with np.load(TABLE_PATH) as z:
            starts, classes = z["starts"], z["classes"]
        lens = np.diff(np.append(starts, MAX_CP))
        _TABLE = np.repeat(classes.astype(np.int8), lens)
    return _TABLE


_LETTERISH = np.zeros(17, bool)
_LETTERISH[[C_LETTER, C_S, C_D, C_M, C_T, C_L, C_V, C_R, C_E]] = True
_WSANY = np.zeros(17, bool)
_WSANY[[C_SPACE, C_WS, C_CR, C_LF]] = True
_SDMT = np.zeros(17, bool)
_SDMT[[C_S, C_D, C_M, C_T]] = True
# class index 16 = out-of-text sentinel (False in every mask)


def _PUNCT(c):
    return (c == C_OTHER) | (c == C_APO)


def gpt_starts(cp: np.ndarray) -> np.ndarray:
    """Match-start indices (char space) for PATTERN_GPT; starts[0] == 0.
    Chunk i spans [starts[i], starts[i+1]) with starts[len] == n."""
    n = len(cp)
    if n == 0:
        return np.zeros(0, np.int64)
    cls = class_table()[cp].astype(np.int8)
    nxt = np.full(n, 16, np.int8)
    nxt[:n - 1] = cls[1:]
    nxt2 = np.full(n, 16, np.int8)
    nxt2[:max(n - 2, 0)] = cls[2:]
    prv = np.full(n, 16, np.int8)
    prv[1:] = cls[:-1]

    letter = _LETTERISH[cls]
    wsany = _WSANY[cls]
    nl = (cls == C_CR) | (cls == C_LF)
    punct = (cls == C_OTHER) | (cls == C_APO)
    space = cls == C_SPACE
    tabish = cls == C_WS
    digit = cls == C_DIGIT
    letter_n = _LETTERISH[nxt]
    punct_p = _PUNCT(prv)
    idx = np.arange(n, dtype=np.int64)
    # start is over-allocated so every "mark position p+s for mask at p"
    # is a shifted boolean-mask assignment (one pass, no fancy-index
    # compaction — measured 5x faster at corpus scale)
    start = np.zeros(n + 3, bool)

    def mark(mask, shift=0):
        start[shift:shift + n][mask] = True

    # ---- alt 1: contractions (previous char must not consume the ')
    apo = cls == C_APO
    blocked = punct_p | (prv == C_SPACE)
    con1 = apo & ~blocked & _SDMT[nxt]
    con2 = (apo & ~blocked & ~con1
            & (((nxt == C_L) & (nxt2 == C_L))
               | ((nxt == C_V) & (nxt2 == C_E))
               | ((nxt == C_R) & (nxt2 == C_E))))
    mark(con1)
    mark(con1, 2)                      # next chunk resumes after suffix
    mark(con2)
    mark(con2, 3)
    consumed = np.zeros(n + 2, bool)   # letters eaten by a contraction
    consumed[1:1 + n][con1] = True
    consumed[1:1 + n][con2] = True
    consumed[2:2 + n][con2] = True
    consumed = consumed[:n]
    con = con1 | con2

    # ---- alt 2: letter-run chunks with optional absorbed prefix
    consumed_p = np.zeros(n, bool)
    consumed_p[1:] = consumed[:-1]
    letter_p = _LETTERISH[prv]
    head = letter & ~consumed & (~letter_p | consumed_p)
    # prefix candidates at head-1:
    #   lone punct (length-1 punct run), itself not space-prefixed and
    #   not a contraction apostrophe; or any space/tab-class ws char
    punct_pp = np.full(n, 16, np.int8)             # class at p-2
    punct_pp[1:] = prv[:-1]
    con_p = np.zeros(n, bool)
    con_p[1:] = con[:-1]
    lone_punct_p = (punct_p & ~_PUNCT(punct_pp)
                    & (punct_pp != C_SPACE) & ~con_p)
    ws_prefix_p = (prv == C_SPACE) | (prv == C_WS)
    absorb = head & (lone_punct_p | ws_prefix_p)
    absorb[0] = False
    mark(head & ~absorb)
    if n > 1:
        start[: n - 1][absorb[1:]] = True          # mark position p-1

    # ---- alt 3: digit blocks of 3 anchored at run starts
    if digit.any():
        drs = digit.copy()
        drs[1:] &= ~digit[:-1]
        d_id = np.cumsum(drs) - 1
        d_start = idx[drs]
        off = idx[digit] - d_start[d_id[digit]]
        blk = np.zeros(n, bool)
        blk[idx[digit][off % 3 == 0]] = True
        mark(blk)
        dre = digit.copy()
        dre[:-1] &= ~digit[1:]
        mark(dre, 1)                   # position after each digit run

    # ---- alt 4: punct-run chunks (+space prefix; newline suffix below)
    prs = punct & ~punct_p & ~con
    sp_absorb = prs & (prv == C_SPACE)
    sp_absorb[0] = False
    # a lone punct followed by a letter was absorbed as alt-2 prefix
    lone = punct & ~punct_p & ~_PUNCT(nxt)
    eaten = lone & letter_n & ~con & ~(prv == C_SPACE)
    mark(prs & ~sp_absorb & ~eaten)
    if n > 1:
        start[: n - 1][sp_absorb[1:]] = True

    # ---- alts 5/6/7: whitespace runs
    if wsany.any():
        wrs = wsany & ~np.concatenate([[False], wsany[:-1]])
        wre = wsany & ~np.concatenate([wsany[1:], [False]])
        a = idx[wrs]
        b = idx[wre] + 1
        # per-run last-newline / first-non-newline via searchsorted over
        # the sorted nl / non-nl-ws index lists (ufunc.at is too slow)
        nl_idx = idx[nl]
        if len(nl_idx):
            pos = np.searchsorted(nl_idx, b) - 1
            got = nl_idx[np.maximum(pos, 0)]
            lastnl = np.where((pos >= 0) & (got >= a), got, -1)
        else:
            lastnl = np.full(len(a), -1, np.int64)
        nonnl_idx = idx[wsany & ~nl]
        if len(nonnl_idx):
            pos2 = np.minimum(np.searchsorted(nonnl_idx, a),
                              len(nonnl_idx) - 1)
            got2 = nonnl_idx[pos2]
            first_nonnl = np.where((got2 >= a) & (got2 < b), got2,
                                   np.iinfo(np.int64).max)
        else:
            first_nonnl = np.full(len(a), np.iinfo(np.int64).max)
        lead = np.minimum(first_nonnl, b) - a      # nl-prefix length
        absorb_nl = (a > 0) & punct[np.maximum(a - 1, 0)] & nl[a]
        p0 = np.where(absorb_nl, a + lead, a)
        start[p0[p0 < b]] = True
        rem = np.maximum(p0, np.where(lastnl >= p0, lastnl + 1, p0))
        mark_nl = (lastnl >= p0) & (lastnl + 1 < b)
        start[(lastnl + 1)[mark_nl]] = True
        leftover = (b < n) & (b - rem >= 2)
        start[(b - 1)[leftover]] = True

    start[0] = True
    return np.nonzero(start[:n])[0].astype(np.int64)


def gpt_split_str(text: str) -> list[str]:
    """PATTERN_GPT chunks via the vectorized splitter (host path)."""
    if not text:
        return []
    cp = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    starts = gpt_starts(cp)
    bounds = np.concatenate([starts, [len(cp)]])
    return [text[bounds[i]:bounds[i + 1]] for i in range(len(starts))]


def gpt_chunk_lens_bytes(data: bytes) -> np.ndarray:
    """Chunk byte-lengths of PATTERN_GPT over utf-8 bytes (for the
    device encoder: pairs with the raw byte stream, no str slicing)."""
    if not data:
        return np.zeros(0, np.int64)
    text = data.decode("utf-8")
    cp = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    starts = gpt_starts(cp)
    blen = np.where(cp < 0x80, 1,
                    np.where(cp < 0x800, 2, np.where(cp < 0x10000, 3, 4)))
    byte_off = np.zeros(len(cp) + 1, np.int64)
    np.cumsum(blen, out=byte_off[1:])
    bounds = byte_off[np.concatenate([starts, [len(cp)]])]
    return np.diff(bounds)


# ---------------------------------------------------------------------
# device splitter: the same run logic as gpt_starts, jit-compiled
# ---------------------------------------------------------------------
#
# Fixed-shape formulation for XLA: the dynamic-shape run compactions
# (np.nonzero / searchsorted over run lists) become associative scans
# (forward run-start / last-newline-so-far, reverse run-end /
# next-newline) with run stats broadcast by GATHER through the
# run-start positions, after which every alternative is per-position
# boolean algebra.  Input is the int8 class array padded with the
# sentinel class 16 to a shape bucket; output is the boolean
# match-start mask.  Differential-tested against gpt_starts (and
# therefore against the regex module) on adversarial + fuzzed inputs.
#
# The generic associative scans cost dozens of memory passes, so the
# native single-pass scanner remains the default host path (device
# speed not measured on the H100 yet).  This device path exists for
# fully-on-device pipelines (split feeding encode without a host hop) and as the sharding-ready formulation
# (every op here is data-parallel over the mesh with a 3-char halo).

def _jnp_scan_max(x, reverse=False):
    import jax
    return jax.lax.associative_scan(jax.numpy.maximum, x, reverse=reverse)


def gpt_starts_mask_jnp(cls, n):
    """jnp start mask; cls int8[N] (class 16 = padding), n = true length."""
    import jax
    import jax.numpy as jnp

    N = cls.shape[0]
    cls = cls.astype(jnp.int32)
    idx = jnp.arange(N, dtype=jnp.int32)
    intext = idx < n
    cls = jnp.where(intext, cls, 16)

    def shift_next(x, k, fill):
        return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])

    def shift_prev(x, k, fill):
        return jnp.concatenate([jnp.full((k,), fill, x.dtype), x[:-k]])

    nxt = shift_next(cls, 1, 16)
    nxt2 = shift_next(cls, 2, 16)
    prv = shift_prev(cls, 1, 16)

    letterish = jnp.asarray(_LETTERISH)
    wsany_t = jnp.asarray(_WSANY)
    sdmt_t = jnp.asarray(_SDMT)

    letter = letterish[cls]
    wsany = wsany_t[cls]
    nl = (cls == C_CR) | (cls == C_LF)
    punct = (cls == C_OTHER) | (cls == C_APO)
    digit = cls == C_DIGIT
    letter_n = letterish[nxt]
    punct_p = (prv == C_OTHER) | (prv == C_APO)

    start = jnp.zeros(N + 3, jnp.bool_)

    def mark(start, mask, shift=0):
        pad = jnp.zeros(3, jnp.bool_)
        m = jnp.concatenate([mask, pad])
        if shift:
            m = jnp.concatenate([jnp.zeros(shift, jnp.bool_),
                                 m[:-shift]])
        return start | m

    # ---- alt 1: contractions
    apo = cls == C_APO
    blocked = punct_p | (prv == C_SPACE)
    con1 = apo & ~blocked & sdmt_t[nxt]
    con2 = (apo & ~blocked & ~con1
            & (((nxt == C_L) & (nxt2 == C_L))
               | ((nxt == C_V) & (nxt2 == C_E))
               | ((nxt == C_R) & (nxt2 == C_E))))
    start = mark(start, con1)
    start = mark(start, con1, 2)
    start = mark(start, con2)
    start = mark(start, con2, 3)
    con = con1 | con2
    consumed = (shift_prev(con1, 1, False) | shift_prev(con2, 1, False)
                | shift_prev(con2, 2, False))

    # ---- alt 2: letter runs with optional absorbed prefix
    consumed_p = shift_prev(consumed, 1, False)
    letter_p = letterish[prv]
    head = letter & ~consumed & (~letter_p | consumed_p)
    prv2 = shift_prev(cls, 2, 16)
    con_p = shift_prev(con, 1, False)
    lone_punct_p = (punct_p & ~((prv2 == C_OTHER) | (prv2 == C_APO))
                    & (prv2 != C_SPACE) & ~con_p)
    ws_prefix_p = (prv == C_SPACE) | (prv == C_WS)
    absorb = head & (lone_punct_p | ws_prefix_p) & (idx > 0)
    start = mark(start, head & ~absorb)
    start = start | jnp.concatenate(
        [shift_next(absorb, 1, False), jnp.zeros(3, jnp.bool_)])

    # ---- alt 3: digit blocks of 3 anchored at run starts
    drs = digit & ~shift_prev(digit, 1, False)
    run_start = _jnp_scan_max(jnp.where(drs, idx, -1))
    off = idx - run_start
    blk = digit & (off % 3 == 0)
    start = mark(start, blk)
    dre = digit & ~shift_next(digit, 1, False)
    start = mark(start, dre, 1)

    # ---- alt 4: punct runs (+space prefix)
    prs = punct & ~punct_p & ~con
    sp_absorb = prs & (prv == C_SPACE) & (idx > 0)
    lone = punct & ~punct_p & ~((nxt == C_OTHER) | (nxt == C_APO))
    eaten = lone & letter_n & ~con & ~(prv == C_SPACE)
    start = mark(start, prs & ~sp_absorb & ~eaten)
    start = start | jnp.concatenate(
        [shift_next(sp_absorb, 1, False), jnp.zeros(3, jnp.bool_)])

    # ---- alts 5/6/7: whitespace runs.  Run stats (start a, end b,
    # first non-newline, absorb flag, last newline) broadcast to every
    # position by GATHERING through the run-start/run-end position
    # scans — a value max-scan would leak across runs.
    wrs = wsany & ~shift_prev(wsany, 1, False)
    wre = wsany & ~shift_next(wsany, 1, False)
    big = jnp.int32(N + 8)
    a_of = _jnp_scan_max(jnp.where(wrs, idx, -1))               # run start
    b_of = -_jnp_scan_max(jnp.where(wre, -(idx + 1), -big),
                          reverse=True)                         # run end+1
    a_clip = jnp.clip(a_of, 0, N - 1)
    bm1 = jnp.clip(b_of - 1, 0, N - 1)
    valid = wsany & (a_of >= 0)

    nonnl = wsany & ~nl
    first_nonnl_from = -_jnp_scan_max(jnp.where(nonnl, -idx, -big),
                                      reverse=True)
    fnn = first_nonnl_from[a_clip]
    lead = jnp.minimum(fnn, b_of) - a_of
    prev_punct_a = shift_prev(punct, 1, False)
    absorb_nl_at_a = prev_punct_a & nl & wrs & (idx > 0)
    absorb_nl = absorb_nl_at_a[a_clip]
    p0 = jnp.where(absorb_nl, a_of + lead, a_of)
    # last newline at or before the run's final position (values from
    # BEFORE the run fall below p0 and are rejected by the guards)
    lastnl_upto = _jnp_scan_max(jnp.where(nl, idx, -1))
    lastnl_bc = lastnl_upto[bm1]

    start = start | mark(jnp.zeros(N + 3, jnp.bool_),
                         valid & (idx == p0) & (p0 < b_of))
    mark_nl = valid & (lastnl_bc >= p0) & (idx == lastnl_bc + 1) \
        & (idx < b_of)
    start = start | mark(jnp.zeros(N + 3, jnp.bool_), mark_nl)
    rem = jnp.maximum(p0, jnp.where(lastnl_bc >= p0, lastnl_bc + 1, p0))
    leftover = valid & wre & (b_of < n) & (b_of - rem >= 2)
    start = start | mark(jnp.zeros(N + 3, jnp.bool_), leftover)

    out = start[:N]
    out = out.at[0].set(True)
    return out & intext


def gpt_starts_device(cp: np.ndarray, _cache={}) -> np.ndarray:
    """Match-start indices via the ON-DEVICE splitter (XLA-fused scans;
    the byte-class DFA running as a device program).  Shapes
    bucket to powers of two so steady state never recompiles."""
    import jax
    import jax.numpy as jnp

    n = len(cp)
    if n == 0:
        return np.zeros(0, np.int64)
    cls = class_table()[np.asarray(cp, np.uint32)].astype(np.int8)
    cap = 1024
    while cap < n:
        cap *= 2
    pad = np.full(cap, 16, np.int8)
    pad[:n] = cls
    if cap not in _cache:
        _cache[cap] = jax.jit(gpt_starts_mask_jnp)
    mask = _cache[cap](jnp.asarray(pad), jnp.int32(n))
    return np.nonzero(np.asarray(mask)[:n])[0].astype(np.int64)
