"""Device LZX encode: batched content-sort match finder, gather-free.

Redesign of ops/lz_tpu.py for an accelerator on which data-dependent
gathers cost far more than elementwise work.  The v1 engine spent its time
in ~70 full-block gathers (hash probing + match extension +
pointer-doubling parse); this engine uses NO data-dependent gathers and a
handful of sorts with minimal operand counts (sort time scales with the
number of carried arrays, so values are bit-packed into single i32s):

  1. blocks up to MAX_FLAT stack whole on a batch axis (the flat engine,
     the production path: candidates reach the format's full 24-bit
     distance budget); larger blocks split into overlapping 256 KiB rows
     (192 KiB stride, 64 KiB context window)
  2. two tier sorts order positions by exact 8-byte window content
     (big-endian int32 key pairs; MAX_MLEN//4 content words ride along as
     payload) — tier A's sorted predecessor is the nearest previous
     occurrence of the same 8 bytes, tier B's (1-key stable sort) the most
     RECENT same-4-byte predecessor, the reference's own match model.
     Radius-1..RADIUS probes read neighbors with rolls; byte equality is
     guaranteed by construction, not by hash.  The first differing carried
     word bounds the exact match length, capped at MAX_MLEN=16 (measured:
     the cap was the ratio limiter — 0.5493/0.5316/0.5232 at 8/12/16 vs
     the host parse's 0.5409 on the mixed corpus).  Longer repeats become
     chains of adjacent same-distance tokens that the emitter fuses back
     into single long matches, extended byte-exactly on the host
  3. unsort sorts (idx, pack(cand,mlen)) return to position order
  4. exact one-step-lazy greedy parse with no serial walk: windowed
     entry-state maps composed by associative scan (see _parse_stage)
  5. a compaction sort moves chosen tokens to the front in position order
     for a small device->host fetch
  6. wire emission: native/lz.cpp kz_lzx_emit_tokens (fuse+extend+emit)

The output is a valid v7 LZX section stream (LZCodec.java:144-760
semantics).  The parse differs from the reference's serial hash-chain
greedy parse; the format does not.
"""

from __future__ import annotations

import functools

import numpy as np

from .lz_tpu import MIN_BLOCK_LENGTH, _emit

MAX_DISTANCE1 = (1 << 16) - 2

ROW = 1 << 18                 # 256 KiB rows
STRIDE = 3 * (1 << 16)        # 192 KiB of token positions per row
OV = ROW - STRIDE             # 64 KiB context window (max match distance)
MAX_MLEN = 16                 # device match-length cap: 4 content words ride
#                               the sorts.  Measured mixed-corpus ratio at
#                               cap 8/12/16: 0.5493/0.5316/0.5232 vs host
#                               parse 0.5409 — the cap, not candidate count,
#                               was the ratio limiter; 16 beats the host C++
#                               parse outright (chains/merge go longer still)
EDGE = 16                     # no claims this close to a row end (padding)
TIERB_WORDS = 2               # content words carried by the tier-B sort
#                               (0 = all MAX_MLEN//4 words); tier B serves
#                               short recent matches, so 2 words suffice
RADIUS = 3                    # sorted-neighborhood probe radius (both tiers);
#                               measured: radius 4/6/8 do NOT improve the
#                               mixed-corpus ratio over 3 (0.5493 -> 0.5494)
#                               — candidate count is not the ratio limiter,
#                               the match-length cap is (see MAX_MLEN)
_SIGN = np.int32(-0x80000000)  # two's-complement sign flip: u32 sort order


def _mlen_bits() -> int:
    """Bits for mlen-4 in the unsort pack (MAX_MLEN 8 -> 3, 12/16 -> 4)."""
    return max(3, (MAX_MLEN - 4).bit_length())


def _unpack_tokens(pk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host unpack of the parse's packed (pos << bits | mlen-4) tokens."""
    bits = _mlen_bits()
    pk = pk.astype(np.int64)
    return pk >> bits, (pk & ((1 << bits) - 1)) + 4


def _build_words(bufs, nb):
    """Big-endian 4-byte content windows of the uint8 rows ``bufs`` (nb, n)
    at offsets 0, 4, .., MAX_MLEN-4.  ws[0]/ws[1] are the sort keys (8-byte
    window); later words ride the sorts as payload so probes can measure
    matches up to MAX_MLEN.  XLA fuses the shifted slices into one
    elementwise pass."""
    import jax.numpy as jnp
    b = bufs.astype(jnp.int32)

    def byte_at(k):  # b shifted left by k along the row, zero-filled
        return jnp.concatenate(
            [b[:, k:], jnp.zeros((nb, k), jnp.int32)], axis=1)

    bs = [byte_at(k) for k in range(4)]
    w0 = (bs[0] << 24) | (bs[1] << 16) | (bs[2] << 8) | bs[3]
    ws = [w0]
    for k in range(4, MAX_MLEN - 3, 4):
        ws.append(jnp.concatenate(
            [w0[:, k:], jnp.zeros((nb, k), jnp.int32)], axis=1))
    return ws


SEG_B = 1 << 18  # tier-B scope: 256 Ki position segments.  Tier B serves
#                  SHORT matches; restricting its candidates to the
#                  enclosing 256 Ki segment costs +0.3% ratio on the mixed
#                  corpus (0.5289 -> 0.5305, still well under the host
#                  parse's 0.5365) and shortens the rows of its
#                  sort+unsort.  Tier A stays global: windowing it to even
#                  1 Mi ties the host ratio (0.5364) — too tight.


def _probe_sorted(ws_s, sidx, iota, mask_fn, nrows, n):
    """Radius-1..RADIUS predecessor probe in the current sort order.
    A predecessor equal in all words shares >= 4*len(ws_s) bytes; the
    first differing carried word bounds the exact match length via its
    leading equal bytes (key sign flips cancel in the xor)."""
    import jax.numpy as jnp

    def rolled(x, r):  # sorted predecessor at radius r (row-local shift)
        return jnp.concatenate(
            [jnp.zeros((nrows, r), x.dtype), x[:, :-r]], axis=1)

    cand = jnp.zeros((nrows, n), jnp.int32)
    mlen = jnp.zeros((nrows, n), jnp.int32)
    for r in range(RADIUS, 0, -1):  # nearest radius wins
        k0 = ws_s[0]
        eq0 = (k0 == rolled(k0, r)) & (iota >= r)  # guard the prefix
        c = rolled(sidx, r)
        base = eq0 & mask_fn(sidx, c)
        # exact length from the first differing word, capped 4*len(ws_s)
        acc = None
        for j in range(len(ws_s) - 1, 0, -1):
            x = (ws_s[j] ^ rolled(ws_s[j], r)).astype(jnp.uint32)
            lj = 4 * j + ((x < (1 << 24)).astype(jnp.int32)
                          + (x < (1 << 16)).astype(jnp.int32)
                          + (x < (1 << 8)).astype(jnp.int32))
            full = 4 * (j + 1) if acc is None else acc
            acc = jnp.where(x == 0, full, lj)
        cand = jnp.where(base, c, cand)
        mlen = jnp.where(base, acc, mlen)
    return cand, mlen


def _unsort_results(sidx, cand, mlen, idx, shape):
    """Back to position order; (cand, mlen) packed in one i32
    (cand < 2^(31-bits), mlen-4 in [0, MAX_MLEN-4]).  The sort runs at
    whatever row split ``sidx`` arrived in (tier B: per segment — every
    position stays inside its segment, so segment-local unsorting is
    exact); the result is reshaped back to ``shape``."""
    import jax
    import jax.numpy as jnp

    bits = _mlen_bits()
    pack = (cand << bits) | (mlen - jnp.where(mlen > 0, 4, 0))
    pack = jnp.where(mlen > 0, pack, -1)
    _, pk = jax.lax.sort((sidx, pack), num_keys=1, is_stable=True)
    pk = pk.reshape(shape)
    has = pk >= 0
    cand_p = jnp.where(has, pk >> bits, 0)
    mlen_p = jnp.where(has, (pk & ((1 << bits) - 1)) + 4, 0)
    return jnp.where(has, idx - cand_p, 0), mlen_p


def _probe_tiers(ws, idx, mask_fn, shape, astride: int = 1):
    """Two-tier sorted-neighborhood probe shared by the flat and windowed
    engines.  ``ws`` are the position-order content words, ``idx`` the
    position iota, ``mask_fn(sidx, c)`` the engine\'s candidate-validity
    mask (distance budget, row edges) — it must broadcast over any row
    split of its (nrows, n) shape (per-row constants are repeated when
    tier B reshapes rows into segments).  ``astride`` > 1 anchor-samples
    tier A: only every astride-th position enters (and can be found by)
    the big content sort — the "sort less" experiment (mask_fn must then
    broadcast at width n//astride too).  Returns (dist, mlen) per tier,
    already unsorted to position order."""
    import jax
    import jax.numpy as jnp

    nrows, n = shape

    extras = ws[2:]
    # tier A — content order over the FULL row: sort by the exact 8-byte
    # window; the sorted neighborhood holds the nearest SAME-8-BYTE
    # predecessors (long/far matches the single-entry reference hash often
    # evicts)
    if astride > 1:
        wsA_in = [w[:, ::astride] for w in ws]
        idxA = idx[:, ::astride]
        nA = idxA.shape[1]
        iotaA = jax.lax.broadcasted_iota(jnp.int32, (nrows, nA), 1)
    else:
        wsA_in, idxA, nA = list(ws), idx, n
        iotaA = idx   # the full iota IS the column iota
    sa = jax.lax.sort((wsA_in[0] ^ _SIGN, wsA_in[1] ^ _SIGN,
                       *wsA_in[2:], idxA),
                      num_keys=2, is_stable=True)
    wsA = list(sa[:-1])
    sidxA = sa[-1]
    candA, mlA = _probe_sorted(wsA, sidxA, iotaA, mask_fn, nrows, nA)
    distA, mlenA = _unsort_results(sidxA, candA, mlA, idxA, (nrows, nA))
    if astride > 1:   # re-expand to full position width (non-anchors: 0)
        z = jnp.zeros((nrows, n), jnp.int32)
        distA = z.at[:, ::astride].set(distA)
        mlenA = z.at[:, ::astride].set(mlenA)
    # tier B — position order within equal 4-byte prefixes, per SEG_B
    # segment: the stable 1-key sort leaves ties in idx order, so radius
    # probes yield the most RECENT same-4-byte predecessors — the
    # reference\'s own match model (LZCodec.java:144-151 single-entry
    # hash), which tier A\'s k1-ordered runs miss for short matches.  Tier
    # B exists for SHORT matches, so it carries only the 8-byte window
    # (TIERB_WORDS=2) and its candidates only reach inside the enclosing
    # segment (see SEG_B above for the measured ratio cost).
    nb_words = ws[:TIERB_WORDS] if TIERB_WORDS else ws
    nseg = max(1, n // SEG_B)
    segn = n // nseg

    def seg(x):
        return x.reshape(nrows * nseg, segn)

    iota_b = jax.lax.broadcasted_iota(jnp.int32, (nrows * nseg, segn), 1)
    sb = jax.lax.sort((seg(ws[0]) ^ _SIGN, seg(idx),
                       *(seg(w) ^ _SIGN for w in nb_words[1:])),
                      num_keys=1, is_stable=True)
    wsB = [sb[0], *sb[2:]]
    sidxB = sb[1]
    candB, mlB = _probe_sorted(wsB, sidxB, iota_b, mask_fn,
                               nrows * nseg, segn)
    distB, mlenB = _unsort_results(sidxB, candB, mlB, idx, (nrows, n))
    return (distA, mlenA), (distB, mlenB)


def _merge_tiers(tA, tB):
    """Longer wins, ties prefer the shorter distance; a len-4 match is
    uneconomic at 3-byte distances (token + 3 > the 4 literals)."""
    import jax.numpy as jnp
    (distA, mlenA), (distB, mlenB) = tA, tB
    better = (mlenB > mlenA) | ((mlenB == mlenA) & (distB < distA))
    mlen_p = jnp.where(better, mlenB, mlenA)
    dist_p = jnp.where(better, distB, distA)
    mlen_p = jnp.where((dist_p >= 65536) & (mlen_p <= 4), 0, mlen_p)
    return dist_p, mlen_p


def _match_flat(bufs, src_end, max_dist, mm: int):
    """v3 whole-block match finding: each batch row is one zero-padded
    BLOCK (not a windowed slice), so candidates reach anywhere earlier in
    the block — the full 24-bit distance budget of the format
    (LZCodec.java:152-153 MAX_DISTANCE2), which the 64 KiB-window row
    engine could not express and which cost it the ratio vs the host
    parse.  bufs (B, N) u8; src_end (B,) i32 = count-18 per block;
    max_dist (B,) i32 = 65534 or 2^24-2 by the reference's block-size rule.
    Returns position-order (mlen, dist) of shape (B, N).

    Words of positions past src_end mix in the zero padding, but such
    positions only ever appear as candidates c < p <= src_end, and a
    window starting below src_end ends inside the real data."""
    import jax
    import jax.numpy as jnp

    nb, n = bufs.shape
    ws = _build_words(bufs, nb)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nb, n), 1)

    def mask_fn(sidx, c):
        # per-row constants repeated by the row split (1x for tier A at
        # any column width incl the anchor-strided one, nseg-x for tier
        # B's per-segment rows), then broadcast along columns
        rep = sidx.shape[0] // nb
        se = jnp.repeat(src_end, rep)[:, None]
        md = jnp.repeat(max_dist, rep)[:, None]
        return (sidx < se) & (sidx - c > 0) & (sidx - c <= md)

    import os
    astride = int(os.environ.get("KANZI_TPU_LZ_ANCHOR", "1"))
    tA, tB = _probe_tiers(ws, idx, mask_fn, (nb, n), astride=astride)
    dist_p, mlen_p = _merge_tiers(tA, tB)
    mlen2 = jnp.minimum(mlen_p, jnp.maximum(src_end[:, None] - idx, 0))
    mlen2 = jnp.where(mlen2 >= max(mm, 4), mlen2, 0)
    return mlen2.reshape(-1), dist_p.reshape(-1)


def _analyze_flat(bufs, src_end, max_dist, mm: int):
    mlen, dist = _match_flat(bufs, src_end, max_dist, mm)
    return _parse_stage(mlen, dist, mm)


@functools.lru_cache(maxsize=None)
def _analyze_flat_jit(mm: int):
    import jax
    return jax.jit(functools.partial(_analyze_flat, mm=mm))


MAX_FLAT = 1 << 24   # blocks beyond 16 Mi fall back to the windowed rows
#                      (the flat pos/cand i32 bit-packs and the dispatch
#                      position budget both bound this; see _probe_tiers)


def _flat_bucket(n: int) -> int:
    """Padded whole-block length: a few fixed shapes bound compile count."""
    b = 1 << 18
    while b < n:
        b <<= 1
    return b


def _match_stage(rows, vend, isfirst, mdrow, mm: int):
    """Two-tier match finding over a batch of independent rows (possibly
    spanning several blocks).  rows (B, ROW) uint8; vend (B,) i32 = number
    of valid token positions in the row's token region (clips match ends
    at the block's src_end); isfirst (B,) bool = the row's left context is
    zero padding (block start), so candidates must not reach into it;
    mdrow (B,) i32 = the owning block's distance budget (65534 or 2^24-2,
    LZCodec.java:152-153) — in-row distances reach the full 256 KiB row.
    Returns flat position-order (mlen, dist) arrays of size B*STRIDE."""
    import jax
    import jax.numpy as jnp

    nrows = rows.shape[0]
    ws = _build_words(rows, nrows)
    idx = jax.lax.broadcasted_iota(jnp.int32, (nrows, ROW), 1)
    first = isfirst[:, None]

    def mask_fn(sidx, c):
        # a block's first row has zero padding as left context:
        # candidates there would be wire-invalid.  Per-row constants are
        # expanded then re-split (tier B probes at per-segment row shape).
        fi = jnp.broadcast_to(first, (nrows, ROW)).reshape(sidx.shape)
        md = jnp.broadcast_to(mdrow[:, None],
                              (nrows, ROW)).reshape(sidx.shape)
        return (sidx <= ROW - EDGE) & (~fi | (c >= OV)) \
            & (sidx - c > 0) & (sidx - c <= md)

    tA, tB = _probe_tiers(ws, idx, mask_fn, (nrows, ROW))
    dist_p, mlen_p = _merge_tiers(tA, tB)

    # token region of row g = local [OV, ROW); clip match ends at the
    # row's valid-position budget (block src_end)
    loc = jax.lax.broadcasted_iota(jnp.int32, (nrows, STRIDE), 1)
    mlen2 = jnp.minimum(mlen_p[:, OV:],
                        jnp.maximum(vend[:, None] - loc, 0))
    mlen2 = jnp.where(mlen2 >= max(mm, 4), mlen2, 0)
    return mlen2.reshape(-1), dist_p[:, OV:].reshape(-1)


def _parse_stage(mlen, dist, mm: int):
    """Exact one-step-lazy greedy cover, fully parallel (no serial walk,
    no gathers).

    The greedy walk 'take the match at p, jump to p+len, else advance 1' is
    a chain of jumps; a naive extraction is serial, a pointer-doubling one
    is gather-bound.  Instead: cut positions into windows of W.  A token is
    <= MAX_MLEN bytes, so the walk enters any window at overhang offset
    0..MAX_MLEN — SMAX possible entry states.  Phase A runs the in-window
    walk for ALL entry states at once as a W-step scan over (nwin, SMAX)
    vectors, yielding each window's entry->exit map; the maps compose by
    jax.lax.associative_scan (function composition over an SMAX-point
    domain), giving every window's true entry state in log(nwin) rounds.
    Phase B re-runs the walk once with the known entry, emitting the kept
    mask.  Token values are then compacted by one small sort.

    Returns (pk, dist_c, n_tok): packed token arrays (pos << mlen_bits |
    mlen-4, and distance) compacted to the front in position order, plus
    the token count.
    """
    import jax
    import jax.numpy as jnp

    n = mlen.shape[0]
    W = 64
    SMAX = MAX_MLEN + 1  # overhang states (entry >= W would skip the window)
    nwin = n // W
    ok = mlen >= max(mm, 4)
    mnext = jnp.concatenate([mlen[1:], jnp.zeros(1, jnp.int32)])
    take = ok & ~(mnext > mlen)            # one-step lazy
    take2 = take.reshape(nwin, W)
    ml2 = mlen.reshape(nwin, W)

    states = jax.lax.broadcasted_iota(jnp.int32, (nwin, SMAX), 1)

    # the scans consume one WINDOW COLUMN per step; feeding them the
    # (W, nwin) transposes lets lax.scan slice along the leading axis
    # (contiguous per step) instead of the minor one
    takeT = take2.T                        # (W, nwin)
    mlT = ml2.T
    ts = jnp.arange(W, dtype=jnp.int32)

    # phase A: entry->exit maps for all SMAX states
    def stepA(p, x):
        tk, ml, t = x
        at = p == t
        p2 = jnp.where(at, jnp.where(tk[:, None], t + ml[:, None], t + 1), p)
        return p2, None
    exit_p, _ = jax.lax.scan(stepA, states, (takeT, mlT, ts), unroll=16)
    maps = exit_p - W                      # (nwin, SMAX) in [0, MAX_MLEN]

    def compose(a, b):                     # out[e] = b[a[e]]
        out = jnp.zeros_like(a)
        for j in range(SMAX):
            out = jnp.where(a == j, b[..., j:j + 1], out)
        return out

    prefix = jax.lax.associative_scan(compose, maps, axis=0)
    ident = jax.lax.broadcasted_iota(jnp.int32, (1, SMAX), 1)
    excl = jnp.concatenate([ident, prefix[:-1]], axis=0)
    entry = excl[:, 0]                     # walk starts at position 0

    # phase B: one walk with the true entry state, emitting kept tokens
    def stepB(p, x):
        tk, ml, t = x
        at = (p == t) & tk
        p2 = jnp.where(p == t, jnp.where(tk, t + ml, t + 1), p)
        return p2, at
    _, keptT = jax.lax.scan(stepB, entry, (takeT, mlT, ts), unroll=16)
    kept = keptT.T.reshape(-1)             # (n,) bool

    # ---- sort #3: compact tokens (stable: position order preserved);
    # pos < 2^(31-bits) and mlen-4 in [0, MAX_MLEN-4] pack into one i32.
    # Tokens are >= mm >= 4 positions apart (the walk jumps mlen >= 4), so
    # each ALIGNED 4-group holds at most one token: a grouped max-reduce
    # shrinks the compaction sort to n/4 elements (the full-width 3-operand
    # sort was ~20% of the whole analyze cost). ----
    bits = _mlen_bits()
    pos = jax.lax.iota(jnp.int32, n)
    pk_dense = jnp.where(kept, (pos << bits) | (mlen - 4), -1)
    pk_g = jnp.max(pk_dense.reshape(-1, 4), axis=1)
    dist_g = jnp.max(jnp.where(kept, dist, 0).reshape(-1, 4), axis=1)
    _, pk, dist_c = jax.lax.sort(
        ((pk_g < 0).astype(jnp.int32), pk_g, dist_g),
        num_keys=1, is_stable=True)
    n_tok = jnp.sum(kept.astype(jnp.int32))
    # tokens stay PACKED (pos << bits | mlen-4): the host fetch moves two
    # i32 arrays instead of three; unpack with _unpack_tokens
    return pk, dist_c, n_tok


def _analyze(rows, vend, isfirst, mdrow, mm: int):
    mlen, dist = _match_stage(rows, vend, isfirst, mdrow, mm)
    return _parse_stage(mlen, dist, mm)


@functools.lru_cache(maxsize=None)
def _analyze_jit(mm: int):
    import jax
    return jax.jit(functools.partial(_analyze, mm=mm))


@functools.lru_cache(maxsize=None)
def _match_jit(mm: int):
    import jax
    return jax.jit(functools.partial(_match_stage, mm=mm))


def _extend_tokens_host(src: np.ndarray, p: np.ndarray, l: np.ndarray,
                        d: np.ndarray, src_end: int):
    """Byte-exact vectorized host extension of device-capped matches, in
    16-byte rounds.  A token may only extend into the literal gap before
    the next token (never into the next token's coverage)."""
    if p.size == 0:
        return l
    nxt = np.empty_like(p)
    nxt[:-1] = p[1:]
    nxt[-1] = src_end
    room = np.minimum(nxt, src_end) - (p + l)
    grow = l == MAX_MLEN
    while True:
        sel = np.flatnonzero(grow & (room > 0))
        if sel.size == 0:
            break
        step = np.minimum(room[sel], 16).astype(np.int64)
        # ragged compare of src[p+l : p+l+step] vs the match source
        total = int(step.sum())
        tid = np.repeat(np.arange(sel.size), step)
        intra = np.arange(total) - np.repeat(np.cumsum(step) - step, step)
        a = src[(p[sel] + l[sel])[tid] + intra]
        c = src[(p[sel] + l[sel] - d[sel])[tid] + intra]
        eq = a == c
        # per-token leading-equal count
        neq = np.flatnonzero(~eq)
        firsts = np.full(sel.size, -1, np.int64)
        if neq.size:
            tid_neq = tid[neq]
            off_neq = intra[neq]
            order = np.lexsort((off_neq, tid_neq))
            t_sorted = tid_neq[order]
            first_mask = np.empty(t_sorted.size, bool)
            first_mask[0] = True
            first_mask[1:] = t_sorted[1:] != t_sorted[:-1]
            firsts[t_sorted[first_mask]] = off_neq[order][first_mask]
        adv = np.where(firsts >= 0, firsts, step)
        l[sel] += adv
        room[sel] -= adv
        grow[:] = False
        grow[sel] = (firsts < 0) & (step == 16)
    return l


def _block_rows(src: np.ndarray):
    """Host layout of one block: zero-left-padded buffer + overlapped row
    view (free as_strided), per-row valid-token budgets, first-row flag,
    per-row distance budget (the owning block's wire distance mode)."""
    count = src.size
    nb = -(-count // STRIDE)
    buf = np.zeros(OV + nb * STRIDE, dtype=np.uint8)
    buf[OV:OV + count] = src
    rows = np.lib.stride_tricks.as_strided(
        buf, (nb, ROW), (STRIDE, 1), writeable=False)
    src_end = count - 16 - 2
    vend = np.clip(src_end - STRIDE * np.arange(nb), 0, STRIDE)
    isfirst = np.zeros(nb, bool)
    isfirst[0] = True
    mdrow = np.full(nb, _block_max_dist(count), np.int32)
    return rows, vend.astype(np.int32), isfirst, mdrow


GROUP_ROWS = 24  # fixed dispatch shape: XLA sort compile time grows badly
#                  with shape size, so work is fed in identical 48-row
#                  groups (4.5 MiB of positions) that compile exactly once


def _row_buckets(nb: int):
    """Pad a row count to one of a few fixed shapes (4/12/24/48)."""
    for b in (4, 12, GROUP_ROWS):
        if nb <= b:
            return b
    return GROUP_ROWS


def _block_max_dist(count: int) -> int:
    """The reference's distance-mode rule (LZCodec.java:152-153)."""
    return MAX_DISTANCE1 if count - 18 < 4 * MAX_DISTANCE1 \
        else (1 << 24) - 2


FLAT_GROUP = 8  # blocks per flat dispatch (amortizes the per-sort launch
#                 cost; partial groups pad to a power of two)


def lzx_forward_device_batch(blocks, extra: bool = False,
                             min_match: int = 4):
    """Batched LZX forward on the device.  Blocks up to MAX_FLAT run
    through the whole-block flat engine in FLAT_GROUP-sized batched
    dispatches — full wire distance budget (LZCodec.java:152-153), the
    best measured ratio (beats the host C++ parse at MAX_MLEN=16).
    Larger blocks fall back to the overlapped 256 KiB-row engine (in-row
    distances only).  Returns a list aligned with ``blocks``
    (None = skip)."""
    import jax.numpy as jnp

    mm = min_match if min_match > 0 else 4
    blocks = [np.asarray(b, dtype=np.uint8) for b in blocks]
    out = [None] * len(blocks)
    flat_live = [i for i, b in enumerate(blocks)
                 if MIN_BLOCK_LENGTH <= b.size <= MAX_FLAT]
    if flat_live:
        fn = _analyze_flat_jit(mm)
        # group same-bucket blocks per dispatch (mixing sizes would pad
        # small blocks to the largest bucket and pay for the padding in
        # every sort); bound positions per dispatch (sort workspace in
        # device memory + the i32 pos bit-pack): 64 Mi => 8 blocks at 4 MiB
        by_bucket: dict[int, list[int]] = {}
        for i in flat_live:
            by_bucket.setdefault(_flat_bucket(blocks[i].size), []).append(i)
        pend = []
        for bucket in sorted(by_bucket):
            idxs = by_bucket[bucket]
            gmax = max(1, min(FLAT_GROUP, (1 << 26) // bucket))
            for g0 in range(0, len(idxs), gmax):
                grp = idxs[g0:g0 + gmax]
                gp = 1 << max(len(grp) - 1, 0).bit_length()  # pad pow2
                bufs = np.zeros((gp, bucket), np.uint8)
                send = np.full(gp, -18, np.int32)   # pad rows: no tokens
                mdist = np.zeros(gp, np.int32)
                for j, i in enumerate(grp):
                    bufs[j, :blocks[i].size] = blocks[i]
                    send[j] = blocks[i].size - 18
                    mdist[j] = _block_max_dist(blocks[i].size)
                pend.append((grp, bucket,
                             fn(jnp.asarray(bufs), jnp.asarray(send),
                                jnp.asarray(mdist))))
        # fetch each group's PACKED tokens (2 i32 arrays, 8 B/token) and
        # emit on host worker threads while later groups' fetches proceed
        # — the C++ emitter releases the GIL, so emit overlaps both the
        # device analyze and the next fetch
        import concurrent.futures as _cf

        def _emit_one(i, pi, li, di):
            src = blocks[i]
            md = _block_max_dist(src.size)
            res = _emit_native(src, mm, pi, li, di, md)
            if res is False:  # no native library: numpy path
                li = _extend_tokens_host(src, pi, li, di, src.size - 18)
                res = _emit(src, src.size, mm, md, pi, li, di)
            out[i] = res

        with _cf.ThreadPoolExecutor(2) as pool:
            futs = []
            for grp, bucket, (pk_c, dist_c, n_tok) in pend:
                k = int(n_tok)
                if k == 0:
                    continue
                kpad = min(1 << max(k - 1, 1).bit_length(), pk_c.shape[0])
                p, l_ = _unpack_tokens(np.asarray(pk_c[:kpad])[:k])
                d = np.asarray(dist_c[:kpad])[:k].astype(np.int64)
                for j, i in enumerate(grp):
                    lo, hi = np.searchsorted(
                        p, [j * bucket, (j + 1) * bucket])
                    pi = p[lo:hi] - j * bucket
                    li, di = l_[lo:hi].copy(), d[lo:hi]
                    if pi.size:
                        futs.append(pool.submit(_emit_one, i, pi, li, di))
            for f in futs:
                f.result()
    parts = [(_block_rows(b) if b.size > MAX_FLAT else None)
             for b in blocks]
    live = [i for i, p in enumerate(parts) if p is not None]
    if not live:
        return out
    rows = np.concatenate([parts[i][0] for i in live])
    vend = np.concatenate([parts[i][1] for i in live])
    isfirst = np.concatenate([parts[i][2] for i in live])
    mdrow = np.concatenate([parts[i][3] for i in live])
    nb = rows.shape[0]

    # dispatch fixed-shape groups; keep results as device arrays so groups
    # pipeline (async dispatch) before any host fetch forces a sync
    fn = _analyze_jit(mm)
    pend = []
    for g0 in range(0, nb, GROUP_ROWS):
        g1 = min(g0 + GROUP_ROWS, nb)
        bkt = _row_buckets(g1 - g0)
        r = rows[g0:g1]
        v = vend[g0:g1]
        f = isfirst[g0:g1]
        m = mdrow[g0:g1]
        if bkt != g1 - g0:
            pad = bkt - (g1 - g0)
            r = np.concatenate([r, np.zeros((pad, ROW), np.uint8)])
            v = np.concatenate([v, np.zeros(pad, np.int32)])
            f = np.concatenate([f, np.ones(pad, bool)])
            m = np.concatenate([m, np.zeros(pad, np.int32)])
        pend.append((g0, fn(jnp.asarray(r), jnp.asarray(v),
                            jnp.asarray(f), jnp.asarray(m))))

    ps, ls, ds = [], [], []
    for g0, (pk_c, dist_c, n_tok) in pend:
        k = int(n_tok)
        if k == 0:
            continue
        kpad = min(1 << max(k - 1, 1).bit_length(), pk_c.shape[0])
        p, l_ = _unpack_tokens(np.asarray(pk_c[:kpad])[:k])
        ps.append(p + g0 * STRIDE)
        ls.append(l_)
        ds.append(np.asarray(dist_c[:kpad])[:k].astype(np.int64))
    if not ps:
        return out
    p = np.concatenate(ps)
    l = np.concatenate(ls)
    d = np.concatenate(ds)
    base = 0
    for i in live:
        nrows_i = parts[i][0].shape[0]
        span = nrows_i * STRIDE
        lo, hi = np.searchsorted(p, [base, base + span])
        pi, li, di = p[lo:hi] - base, l[lo:hi].copy(), d[lo:hi]
        src = blocks[i]
        if pi.size:
            md = _block_max_dist(src.size)
            out[i] = _emit_native(src, mm, pi, li, di, md)
            if out[i] is False:  # no native library: numpy path
                li = _extend_tokens_host(src, pi, li, di, src.size - 18)
                out[i] = _emit(src, src.size, mm, md, pi, li, di)
        base += span
    return out


def _emit_native(src: np.ndarray, mm: int, p, l, d,
                 max_dist: int = MAX_DISTANCE1):
    """C++ fuse+extend+emit (native/lz.cpp kz_lzx_emit_tokens); returns
    False when the library is unavailable, None when the block gains
    nothing, else the stream bytes."""
    from ..utils.native import as_u8p, get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "kz_lzx_emit_tokens"):
        return False
    import ctypes as c
    if not getattr(lib, "_lz_emit_sig", False):
        i32p = c.POINTER(c.c_int32)
        u8p = c.POINTER(c.c_uint8)
        lib.kz_lzx_emit_tokens.restype = c.c_int64
        lib.kz_lzx_emit_tokens.argtypes = [u8p, c.c_int64, i32p, i32p, i32p,
                                           c.c_int64, c.c_int32, c.c_int32,
                                           u8p]
        lib._lz_emit_sig = True
    spad = np.zeros(src.size + 16, np.uint8)
    spad[:src.size] = src
    dst = np.zeros(src.size + 64, np.uint8)
    pi = np.ascontiguousarray(p, np.int32)
    li = np.ascontiguousarray(l, np.int32)
    di = np.ascontiguousarray(d, np.int32)
    # the C++ emitter trusts its tokens; a malformed device batch (e.g. a
    # mis-sliced shard) must fail loudly here, not scribble over memory
    src_end = src.size - 18
    if pi.size and not (
            np.all(np.diff(pi) >= 4) and 0 <= pi[0]
            and pi[-1] < src_end and np.all(li >= mm)
            and np.all(pi + li <= src_end) and np.all(di > 0)
            and np.all(di <= np.minimum(pi, max_dist))):
        raise ValueError("lzx emit: malformed device token batch")

    def _i32p(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    n = lib.kz_lzx_emit_tokens(as_u8p(spad), src.size, _i32p(pi), _i32p(li),
                               _i32p(di), pi.size, mm, max_dist, as_u8p(dst))
    if n < 0:
        return None
    return dst[:n].copy()


def lzx_forward_device_v2(src: np.ndarray, extra: bool = False,
                          min_match: int = 4) -> np.ndarray | None:
    """LZX forward with the sort-based match engine on the JAX device.

    ``extra`` (LZ vs LZX hash width in the reference) is accepted for
    interface parity; the content sort is exact, so there is no table to
    size.  Returns None when the block should be skipped.
    """
    return lzx_forward_device_batch([src], extra, min_match)[0]
