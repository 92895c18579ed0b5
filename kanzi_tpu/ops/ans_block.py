"""Host glue for the device ANS0 lane scan: produces the exact
ANSRangeEncoder wire bytes (entropy/ans.py) with the symbol scan + payload
packing on the JAX device (ops/route.py picks the kernel).

Division of labor:
  host:   per-chunk histograms, the reference's exact frequency
          normalization (wire-identical headers), header/varint assembly,
          tail (<16 KiB) chunks
  device: the 4-lane rANS scan over all chunks in lockstep + payload pack

Row counts and payload widths are padded to powers of two, so a stream of
4 MiB blocks compiles a handful of shapes instead of one per block.
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter
from ..core.errors import BitStreamError
from ..entropy import ans as hans
from ..entropy import utils as eu
from . import ans as jans
from .route import ans0_kernels

CHUNK = jans.CHUNK


def _chunk_stats(chunks: np.ndarray):
    """(freq[N,256], cum[N,256], alphabet sizes, alphabets) with exact
    reference normalization per chunk."""
    n = chunks.shape[0]
    # per-row histograms; a row loop avoids a (n, CHUNK) temporary
    hist = np.stack([np.bincount(r, minlength=256) for r in chunks])
    freq = eu.normalize_frequencies_batch(hist, chunks.shape[1],
                                          1 << jans.LOG_RANGE)
    nz = hist > 0
    nsym = nz.sum(axis=1)
    alphabets = [np.flatnonzero(nz[i]).astype(np.int32) for i in range(n)]
    cum = np.concatenate([np.zeros((n, 1), dtype=np.int64),
                          np.cumsum(freq, axis=1)[:, :-1]], axis=1)
    return freq, cum, nsym, alphabets


def bucket(n: int, lo: int) -> int:
    """Smallest power of two >= max(n, lo)."""
    return max(lo, 1 << max(n - 1, 0).bit_length())


def pad_tables(freq: np.ndarray, cum: np.ndarray, rows: int):
    """int32 (freq, cum) padded to ``rows``; pad rows hold a valid
    one-symbol table (freq[0] = 4096), so the kernels never divide by 0."""
    f = np.zeros((rows, 256), np.int32)
    f[:, 0] = jans.SCALE
    f[:len(freq)] = freq
    c = np.zeros((rows, 256), np.int32)
    c[:len(cum)] = cum
    return f, c


def assemble_ans0_wire(bw: BitWriter, freq: np.ndarray, nsym: np.ndarray,
                       alphabets: list, n_emit: np.ndarray,
                       states: np.ndarray, payload: np.ndarray,
                       rowmap: np.ndarray) -> None:
    """Serialize per-chunk ANS0 wire records (lr, freq header, varint size,
    4x32-bit states, big-endian u16 payload — ANSRangeEncoder.java:263-305)
    from device-produced arrays.  ``rowmap[i]`` is the payload row for chunk
    ``i`` (single-symbol chunks have no payload and are skipped)."""
    for i in range(len(nsym)):
        bw.write_bits(jans.LOG_RANGE - 8, 3)
        hans._write_freqs_header(bw, alphabets[i], freq[i], jans.LOG_RANGE)
        if nsym[i] <= 1:
            continue  # skipped chunk (single symbol)
        k = rowmap[i]
        ne = int(n_emit[k])
        pay = payload[k, :ne].astype(">u2").tobytes()
        eu.write_varint(bw, len(pay))
        for j in range(4):
            bw.write_bits(int(states[k, j]), 32)
        bw.write_bytes(pay)


def ans0_encode(block: np.ndarray, bw: BitWriter) -> int:
    """Drop-in for ANSRangeEncoder(order=0).encode with the scan on the
    JAX device."""
    import jax.numpy as jnp
    block = np.asarray(block, dtype=np.uint8)
    count = block.size
    if count <= 32:
        bw.write_bytes(block.tobytes())
        return count
    nfull = count // CHUNK
    tail = count - nfull * CHUNK
    if nfull > 0:
        chunks = block[:nfull * CHUNK].reshape(nfull, CHUNK)
        freq, cum, nsym, alphabets = _chunk_stats(chunks)
        sel = np.flatnonzero(nsym > 1)
        rowmap = np.full(nfull, -1)
        rowmap[sel] = np.arange(sel.size)
        payload = n_emit = states = None
        if sel.size:
            rows = bucket(sel.size, 8)
            ch = np.zeros((rows, CHUNK), np.uint8)
            ch[:sel.size] = chunks[sel]
            fr, cm = pad_tables(freq[sel], cum[sel], rows)
            out = ans0_kernels().encode(jnp.asarray(ch), jnp.asarray(fr),
                                        jnp.asarray(cm))
            payload, n_emit, states = (np.asarray(x) for x in out)
        assemble_ans0_wire(bw, freq, nsym, alphabets, n_emit, states,
                           payload, rowmap)
    if tail:
        enc = hans.ANSRangeEncoder(bw, 0)
        enc._encode_chunk(block[nfull * CHUNK:], bw)
    return count


def ans0_decode(count: int, br: BitReader) -> np.ndarray:
    """Drop-in for ANSRangeDecoder(order=0).decode with the scan on the
    JAX device."""
    import jax.numpy as jnp
    if count <= 32:
        return br.read_bytes(count)
    out = np.empty(count, dtype=np.uint8)
    nfull = count // CHUNK
    tail = count - nfull * CHUNK
    # stage 1 (host, sequential): parse per-chunk headers and slice payloads
    metas = []  # (start, freq, cum, states, payload_bytes) or (start, symbol)
    host_resume = None  # (first host chunk index, its already-read log range)
    for i in range(nfull):
        lr = 8 + br.read_bits(3)
        if lr != jans.LOG_RANGE:
            # valid streams may use any lr in [8,15]; the device kernel is
            # specialized to the default 12, so decode the rest on the host
            if not 8 <= lr <= 15:
                raise BitStreamError("invalid ANS range",
                                     BitStreamError.INVALID_STREAM)
            host_resume = (i, lr)
            break
        alpha, freqs = hans._read_freqs_header(br, lr)
        if len(alpha) <= 1:
            metas.append((i * CHUNK, int(alpha[0]) if len(alpha) else 0))
            continue
        sz = eu.read_varint(br)
        if sz >= hans.MAX_CHUNK_SIZE:
            raise BitStreamError("invalid ANS chunk size",
                                 BitStreamError.INVALID_STREAM)
        states = [br.read_bits(32) for _ in range(4)]
        pay = br.read_bytes(sz)
        metas.append((i * CHUNK, freqs, states, pay))
    full = [m for m in metas if len(m) == 4]
    if full:
        rows = bucket(len(full), 8)
        maxp = bucket(max(len(m[3]) for m in full) + 8, 256)
        pay = np.zeros((rows, maxp), dtype=np.uint8)
        freq = np.zeros((len(full), 256), dtype=np.int64)
        states = np.full((rows, 4), jans.ANS_TOP, dtype=np.int64)
        for k, m in enumerate(full):
            pay[k, :len(m[3])] = m[3]
            freq[k] = m[1]
            states[k] = m[2]
        cum = np.concatenate([np.zeros((len(full), 1), dtype=np.int64),
                              np.cumsum(freq, axis=1)[:, :-1]], axis=1)
        fr, cm = pad_tables(freq, cum, rows)
        res, consumed = ans0_kernels().decode(
            jnp.asarray(pay), jnp.asarray(states.astype(np.int32)),
            jnp.asarray(fr), jnp.asarray(cm))
        res = np.asarray(res)
        consumed = np.asarray(consumed)
        for k, m in enumerate(full):
            if int(consumed[k]) != len(m[3]):
                raise BitStreamError("ANS payload size mismatch (device decode)",
                                     BitStreamError.INVALID_STREAM)
            out[m[0]:m[0] + CHUNK] = res[k]
    for m in metas:
        if len(m) == 2:
            out[m[0]:m[0] + CHUNK] = m[1]
    if host_resume is not None:
        i0, lr0 = host_resume
        dec = hans.ANSRangeDecoder(br, 0)
        dec._decode_chunk(out, i0 * CHUNK, min((i0 + 1) * CHUNK, count),
                          br, lr=lr0)
        for i in range(i0 + 1, nfull):
            dec._decode_chunk(out, i * CHUNK, (i + 1) * CHUNK, br)
        if tail:
            dec._decode_chunk(out, nfull * CHUNK, count, br)
        return out
    if tail:
        dec = hans.ANSRangeDecoder(br, 0)
        dec._decode_chunk(out, nfull * CHUNK, count, br)
    return out
