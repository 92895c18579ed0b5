"""Exact-integer numpy oracle of the rANS order-0 lane scan.

An implementation independent of JAX (ANSRangeEncoder.java:337-407
semantics) against which the tests and chip_smoke.py compare every device
route of ops/route.py with tolerance 0.
"""

from __future__ import annotations

import numpy as np

ANS_TOP = 1 << 15
LOG_RANGE = 12
SCALE = 1 << LOG_RANGE


def ans0_encode_oracle(chunks: np.ndarray, freq: np.ndarray, cum: np.ndarray):
    """(payload u16 [N, C] front-packed, n_emit [N], states [N, 4]) for
    uint8 chunks [N, C] under per-chunk tables freq/cum [N, 256]."""
    n, c = chunks.shape
    s = c // 4
    fcap = np.minimum(freq, SCALE - 1).astype(np.int64)
    g = chunks.reshape(n, s, 4).astype(np.int64)
    syms = g[:, ::-1, ::-1]
    st = np.full((4, n), ANS_TOP, np.int64)
    flags = np.zeros((s, 4, n), bool)
    vals = np.zeros((s, 4, n), np.int64)
    rows = np.arange(n)[None, :]
    for i in range(s):
        sym = syms[:, i, :].T
        f = fcap[rows, sym]
        cm = cum[rows, sym].astype(np.int64)
        em = (st >> 19) >= f
        vals[i] = st & 0xFFFF
        flags[i] = em
        st1 = np.where(em, st >> 16, st)
        q = st1 // f
        st = (q << LOG_RANGE) + (st1 - q * f) + cm
    flags_f = flags.transpose(2, 0, 1)[:, ::-1, ::-1].reshape(n, -1)
    vals_f = vals.transpose(2, 0, 1)[:, ::-1, ::-1].reshape(n, -1)
    n_emit = flags_f.sum(1)
    pay = np.zeros((n, c), np.uint16)
    for i in range(n):
        pay[i, :n_emit[i]] = vals_f[i][flags_f[i]].astype(np.uint16)
    return pay, n_emit, st.T


def payload_bytes(payload: np.ndarray, n_emit: np.ndarray, width: int):
    """Big-endian byte rows [N, width] of the first n_emit words of each
    payload row: the decoder's input layout."""
    out = np.zeros((payload.shape[0], width), np.uint8)
    for i, ne in enumerate(n_emit):
        out[i, :2 * ne] = payload[i, :ne].astype(">u2").view(np.uint8)
    return out
