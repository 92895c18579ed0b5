"""rANS order-0 lane scan in plain JAX: chunk-parallel encode/decode.

The wire format (see entropy/ans.py) fixes 4 interleaved states per chunk and
16 KiB chunks; parallelism comes from running ALL chunks of a block (and all
blocks of a batch) in lockstep: one lax.scan over the 4096 symbol steps with
(4, num_chunks) vector lanes.  Emissions are resolved in two passes: the scan
records per-step emit flags + 16-bit values, then a prefix sum and a scatter
pack the payload to the front of each row.

This is the CPU path and the reference for the CUDA kernel
(ops/ans_cuda.py); ops/route.py picks between them.  Host responsibilities
(ops/ans_block.py): per-chunk histogram + exact reference normalization
(wire-identical headers), tail chunks, and bitstream assembly.

Encode state update: st >= f<<19 -> emit low 16 bits, st >>= 16;
st' = (st/f)<<12 + st%f + cum  (logRange 12, ANS_TOP 1<<15).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

ANS_TOP = 1 << 15
LOG_RANGE = 12
SCALE = 1 << LOG_RANGE
CHUNK = 16384


@jax.jit
def ans0_encode_chunks(chunks: jax.Array, freq: jax.Array, cum: jax.Array):
    """Encode chunks of any (multiple-of-4) size in lockstep.

    Args:
      chunks: uint8 [N, C]
      freq:   int32 [N, 256] normalized frequencies (sum = 4096, capped here)
      cum:    int32 [N, 256] exclusive cumulative frequencies
    Returns:
      payload_u16: uint16 [N, C] emitted 16-bit words in forward order
                   (entries past n_emit are unspecified)
      n_emit:      int32 [N] number of emitted words per chunk
      states:      int32 [N, 4] final ANS states (st0..st3)
    """
    n, c = chunks.shape
    steps = c // 4
    sym = chunks.astype(jnp.int32)
    f_all = jnp.take_along_axis(jnp.minimum(freq, SCALE - 1), sym, axis=1)
    c_all = jnp.take_along_axis(cum, sym, axis=1)

    def scan_layout(x):  # step t, lane j encodes position 4*(S-1-t) + 3-j
        return jnp.transpose(x.reshape(n, steps, 4)[:, ::-1, ::-1], (1, 2, 0))

    def step(st, x):
        f, cm = x                                         # (4, N) each
        em = (st >> 19) >= f                              # st >= f << 19
        val = st & 0xFFFF
        st1 = jnp.where(em, st >> 16, st)
        q = st1 // f
        return (q << LOG_RANGE) + (st1 - q * f) + cm, (em, val)

    st0 = jnp.full((4, n), ANS_TOP, dtype=jnp.int32)
    states_t, (flags, vals) = jax.lax.scan(
        step, st0, (scan_layout(f_all), scan_layout(c_all)))
    # forward payload order: reverse steps, lanes 3..0; emitted words
    # scatter to their rank, the rest to an out-of-range slot (dropped)
    flags_f = jnp.transpose(flags, (2, 0, 1))[:, ::-1, ::-1].reshape(n, -1)
    vals_f = jnp.transpose(vals, (2, 0, 1))[:, ::-1, ::-1].reshape(n, -1)
    posn = jnp.cumsum(flags_f, axis=1, dtype=jnp.int32)
    dest = jnp.where(flags_f, posn - 1, c)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, c), 0)
    payload = jnp.zeros((n, c), jnp.uint16).at[rows, dest].set(
        vals_f.astype(jnp.uint16), mode="drop")
    return payload, posn[:, -1], states_t.T


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def ans0_decode_chunks(payload: jax.Array, states: jax.Array,
                       freq: jax.Array, cum: jax.Array,
                       chunk_size: int = CHUNK):
    """Decode chunks of ``chunk_size`` bytes in lockstep.

    Args:
      payload: uint8 [N, P] renorm byte pairs (big-endian u16s), zero padded
      states:  int32 [N, 4] initial states (st0..st3 as read from the stream)
      freq, cum: int32 [N, 256]
    Returns:
      out: uint8 [N, chunk_size]; consumed: int32 [N] bytes per chunk
    """
    n = payload.shape[0]
    freq_cap = jnp.minimum(freq, SCALE - 1)
    # freq->symbol LUT per chunk via searchsorted over cumulative bounds
    bounds = cum + freq  # inclusive upper bounds per symbol
    slots = jnp.arange(SCALE, dtype=jnp.int32)
    f2s = jax.vmap(lambda b: jnp.searchsorted(b, slots, side="right"))(bounds)
    f2s = f2s.astype(jnp.int32)  # (N, 4096)
    pay = payload.astype(jnp.int32)

    def step(carry, _):
        st, ptr = carry                                    # (N,4), (N,)
        cur = jnp.take_along_axis(f2s, st & (SCALE - 1), axis=1)
        f = jnp.take_along_axis(freq_cap, cur, axis=1)
        c = jnp.take_along_axis(cum, cur, axis=1)
        st1 = f * (st >> LOG_RANGE) + (st & (SCALE - 1)) - c
        need = st1 < ANS_TOP
        # consumption order: lane 3 first
        need_rev = need[:, ::-1].astype(jnp.int32)
        off_rev = jnp.cumsum(need_rev, axis=1) - need_rev
        off = off_rev[:, ::-1]
        pos = ptr[:, None] + 2 * off
        b0 = jnp.take_along_axis(pay, jnp.minimum(pos, pay.shape[1] - 1), axis=1)
        b1 = jnp.take_along_axis(pay, jnp.minimum(pos + 1, pay.shape[1] - 1), axis=1)
        rd = (b0 << 8) | b1
        st2 = jnp.where(need, (st1 << 16) | rd, st1)
        ptr2 = ptr + 2 * jnp.sum(need.astype(jnp.int32), axis=1)
        return (st2, ptr2), cur

    carry0 = (states, jnp.zeros(n, dtype=jnp.int32))
    (st_f, consumed), syms = jax.lax.scan(step, carry0, None, length=chunk_size // 4)
    # syms: (S, N, 4) with lane order st0..st3; block order = lane3 first
    out = jnp.transpose(syms, (1, 0, 2))[:, :, ::-1].reshape(n, chunk_size)
    return out.astype(jnp.uint8), consumed
