"""The one place that chooses a device implementation from the platform.

A gated device stage (``KANZI_TPU_DEVICE_*``) runs through JAX on JAX's
default device.  Only the rANS lane scan has a hand-written kernel, for
NVIDIA GPUs; every other device stage is plain XLA on any platform.
"""

from __future__ import annotations

from typing import Callable, NamedTuple


class Ans0Kernels(NamedTuple):
    encode: Callable   # (chunks, freq, cum) -> (payload, n_emit, states)
    decode: Callable   # (payload, states, freq, cum, chunk_size=) -> (out, consumed)
    name: str


def ans0_kernels() -> Ans0Kernels:
    """rANS order-0 scan for ``jax.devices()[0].platform``: the CUDA
    kernel on ``gpu``, the XLA scan on ``cpu``."""
    import jax
    platform = jax.devices()[0].platform
    if platform == "gpu":
        from . import ans_cuda
        return Ans0Kernels(ans_cuda.ans0_encode_chunks,
                           ans_cuda.ans0_decode_chunks, "cuda")
    if platform == "cpu":
        from . import ans
        return Ans0Kernels(ans.ans0_encode_chunks, ans.ans0_decode_chunks,
                           "xla")
    raise RuntimeError(f"no rANS implementation for JAX platform {platform!r}")
