"""Device suffix array via prefix doubling over batched XLA sorts.

The reference's DivSufSort (DivSufSort.java:75-2398) is 2.4k lines of
irregular serial code; the SA is unique, so ANY correct construction gives
the identical BWT (SURVEY §7).  The device construction is the classic
prefix-doubling formulation mapped onto sorts, the data-reorganization
primitive XLA provides on every backend:

  rank_1[i] = byte[i]+1 (0 = virtual sentinel padding, strictly smallest,
  which reproduces the standard shorter-suffix-first convention)
  round k:  sort (rank_k[i], rank_k[i+k], i)  ->  pairs in suffix order
            new ranks = prefix count of pair changes     (cumsum)
            sort back by position                        (2-operand sort)
  stop when all ranks are unique (converged) or k >= n.

rank_k[i+k] is a static shift — elementwise, not a gather.  Each round is
two sorts + scans inside ONE jax.lax.while_loop body (compiles once per
shape bucket).  Text converges in ~12-16 rounds; the worst case is log2(n).
A 4 MiB block pads to npad <= 6 Mi positions; each round sorts 3 operands
on 2 keys at that width.  Device time against the host SA-IS: docs/kernels.md.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["suffix_array_device"]


def _bucket(n: int) -> int:
    """Pad to a power of two or 1.5x a power of two (waste <= 25%)."""
    p = 1 << max(n - 1, 1).bit_length()
    if n <= (p >> 2) * 3:
        return (p >> 2) * 3
    return p


_SIGN = np.int32(-0x80000000)


@functools.lru_cache(maxsize=None)
def _sa_jit(npad: int):
    import jax
    import jax.numpy as jnp

    def run(glob, n):
        iota = jax.lax.iota(jnp.int32, npad)
        real = iota < n

        # seed: dense ranks of the exact 8-byte windows (one sort pays for
        # three doubling rounds); pads then get UNIQUE sub-real ranks so the
        # convergence check can actually fire (equal all-zero pad suffixes
        # would otherwise stay tied until k >= npad)
        b = glob.astype(jnp.int32)

        def sh(x, k):
            return jnp.concatenate([x[k:], jnp.zeros(k, jnp.int32)])

        w0 = (b << 24) | (sh(b, 1) << 16) | (sh(b, 2) << 8) | sh(b, 3)
        w1 = sh(w0, 4)
        r1s, r2s, sa0 = jax.lax.sort((w0 ^ _SIGN, w1 ^ _SIGN, iota),
                                     num_keys=2, is_stable=True)
        neq0 = (r1s != jnp.roll(r1s, 1)) | (r2s != jnp.roll(r2s, 1))
        neq0 = neq0.at[0].set(False)
        seed = jnp.cumsum(neq0.astype(jnp.int32))
        _, rank = jax.lax.sort((sa0, seed), num_keys=1, is_stable=True)
        # reals above all pads; pads mutually distinct and DESCENDING with
        # position: a real suffix reading a pad rank at i+k stands in for
        # "i+k past the end", and later (shorter) suffixes must compare
        # smaller, exactly like the masked 0 for i+k past the pad buffer
        rank = jnp.where(real, rank + npad, npad - iota)

        def cond(state):
            k, converged, _rank, _sa = state
            return (~converged) & (k < npad)

        def body(state):
            k, _, rank, _ = state
            # rank at i+k: dynamic shift via roll + mask (not a gather)
            shifted = jnp.where(iota + k < npad, jnp.roll(rank, -k), 0)
            r1, r2, sa = jax.lax.sort((rank, shifted, iota),
                                      num_keys=2, is_stable=True)
            neq = (r1 != jnp.roll(r1, 1)) | (r2 != jnp.roll(r2, 1))
            neq = neq.at[0].set(False)
            newr = jnp.cumsum(neq.astype(jnp.int32))
            converged = newr[-1] == npad - 1
            _, rank2 = jax.lax.sort((sa, newr), num_keys=1, is_stable=True)
            return (k * 2, converged, rank2, sa)

        state = body((jnp.int32(8), jnp.bool_(False), rank,
                      jnp.zeros(npad, jnp.int32)))
        _, _, _, sa = jax.lax.while_loop(cond, body, state)
        return sa

    return jax.jit(run)


def suffix_array_device(src: np.ndarray) -> np.ndarray:
    """Suffix array of ``src`` (uint8) computed on the JAX device."""
    import jax.numpy as jnp

    src = np.asarray(src, dtype=np.uint8)
    n = src.size
    if n <= 2:
        return np.argsort([src[i:].tobytes() for i in range(n)]).astype(
            np.int32) if n else np.zeros(0, np.int32)
    npad = _bucket(n + 1)
    glob = np.zeros(npad, np.uint8)
    glob[:n] = src
    sa = np.asarray(_sa_jit(npad)(jnp.asarray(glob), jnp.int32(n)))
    # padding positions sort first (strictly smallest ranks)
    return sa[npad - n:].astype(np.int32)
