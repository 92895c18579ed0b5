"""Hopper rANS order-0 lane scan (native/ans_cuda.cu) as JAX operations.

Drop-in for ``ops.ans.ans0_encode_chunks`` / ``ans0_decode_chunks`` on a
GPU: same arguments, same results (the payload row past ``n_emit`` is
unspecified in both).  The library is built with nvcc at first use
(utils/native.build_cuda) and registered as two XLA FFI targets.  There is
no CPU or interpret mode: the XLA versions in ops/ans.py are the reference.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp

_ENCODE = "kanzi_ans0_encode"
_DECODE = "kanzi_ans0_decode"


@functools.lru_cache(maxsize=None)
def load() -> str:
    """Build (if needed), load and register the library; returns its path."""
    from ..utils.native import build_cuda
    so = build_cuda(jax.devices()[0].device_kind)
    lib = ctypes.CDLL(so)
    jax.ffi.register_ffi_target(_ENCODE, jax.ffi.pycapsule(lib.KzAns0Encode),
                                platform="CUDA")
    jax.ffi.register_ffi_target(_DECODE, jax.ffi.pycapsule(lib.KzAns0Decode),
                                platform="CUDA")
    return so


def encode_result_types(n: int, c: int):
    """(payload u16 [N, C], n_emit i32 [N], states i32 [N, 4])."""
    return (jax.ShapeDtypeStruct((n, c), jnp.uint16),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n, 4), jnp.int32))


def decode_result_types(n: int, chunk_size: int):
    """(out u8 [N, chunk_size], consumed i32 [N])."""
    return (jax.ShapeDtypeStruct((n, chunk_size), jnp.uint8),
            jax.ShapeDtypeStruct((n,), jnp.int32))


@jax.jit
def ans0_encode_chunks(chunks: jax.Array, freq: jax.Array, cum: jax.Array):
    n, c = chunks.shape
    load()
    return jax.ffi.ffi_call(_ENCODE, encode_result_types(n, c))(
        chunks.astype(jnp.uint8), freq.astype(jnp.int32),
        cum.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def ans0_decode_chunks(payload: jax.Array, states: jax.Array,
                       freq: jax.Array, cum: jax.Array,
                       chunk_size: int = 16384):
    n = payload.shape[0]
    load()
    return jax.ffi.ffi_call(_DECODE, decode_result_types(n, chunk_size))(
        payload.astype(jnp.uint8), states.astype(jnp.int32),
        freq.astype(jnp.int32), cum.astype(jnp.int32))
