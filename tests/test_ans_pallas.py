"""Tests for the device rANS order-0 lane scan: the XLA scan (ops/ans.py),
the CUDA kernel (ops/ans_cuda.py, ``gpu`` marker), the host glue around
them (ops/ans_block.py, ops/route.py) and the batched frequency
normalization.  Every device result is compared with the exact-integer
numpy oracle (ops/ans_oracle.py) with tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

from kanzi_tpu.entropy.utils import (normalize_frequencies,
                                     normalize_frequencies_batch)
from kanzi_tpu.ops.ans_oracle import ans0_encode_oracle, payload_bytes

CHUNK = 16384
SCALE = 4096


def _random_hists(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hists = []
    for _ in range(n):
        k = int(rng.integers(1, 257))
        syms = rng.choice(256, k, replace=False)
        w = rng.pareto(rng.uniform(0.2, 3.0), k) + 1e-9
        h = np.zeros(256, np.int64)
        h[syms] = 1 + rng.multinomial(CHUNK - k, w / w.sum())
        hists.append(h)
    return np.array(hists)


def _zipf_chunks(n: int, seed: int, a: float = 1.3, mod: int = 200):
    """Zipf-ish chunks (emits at varying densities) + their exact tables."""
    from kanzi_tpu.ops.ans_block import _chunk_stats
    rng = np.random.default_rng(seed)
    chunks = (rng.zipf(a, (n, CHUNK)) % mod).astype(np.uint8)
    freq, cum, _, _ = _chunk_stats(chunks)
    return chunks, freq, cum


def _check_encode(encode, chunks, freq, cum):
    import jax.numpy as jnp
    po, no, so = ans0_encode_oracle(chunks, freq, cum)
    p, ne, st = (np.asarray(x) for x in encode(
        jnp.asarray(chunks), jnp.asarray(freq, jnp.int32),
        jnp.asarray(cum, jnp.int32)))
    assert np.array_equal(ne, no)
    assert np.array_equal(st.astype(np.int64), so)
    for i in range(len(chunks)):
        assert np.array_equal(p[i, :no[i]], po[i, :no[i]])
    return po, no, so


def _check_decode(decode, chunks, freq, cum, po, no, so):
    import jax.numpy as jnp
    width = ((int(no.max()) * 2 + 130) // 128 + 2) * 128
    out, used = decode(jnp.asarray(payload_bytes(po, no, width)),
                       jnp.asarray(so, jnp.int32),
                       jnp.asarray(freq, jnp.int32),
                       jnp.asarray(cum, jnp.int32))
    assert np.array_equal(np.asarray(out), chunks)
    assert np.array_equal(np.asarray(used), no * 2)


def test_normalize_batch_matches_scalar():
    hists = _random_hists(500)
    batch = normalize_frequencies_batch(hists, CHUNK, SCALE)
    for i in range(len(hists)):
        f = hists[i].copy()
        normalize_frequencies(f, CHUNK, SCALE)
        assert np.array_equal(f, batch[i]), f"row {i}"


def test_normalize_batch_irregular_rows():
    hists = _random_hists(8, seed=3)
    hists[:, 11] += 5  # break the row-sum invariant -> scalar fallback
    batch = normalize_frequencies_batch(hists, CHUNK, SCALE)
    for i in range(len(hists)):
        f = hists[i].copy()
        normalize_frequencies(f, int(hists[i].sum()), SCALE)
        assert np.array_equal(f, batch[i])


@pytest.mark.parametrize("n", [32, 45])
def test_xla_encode_matches_oracle(n):
    from kanzi_tpu.ops.ans import ans0_encode_chunks
    _check_encode(ans0_encode_chunks, *_zipf_chunks(n, seed=7))


def test_xla_decode_inverts_encode():
    from kanzi_tpu.ops.ans import ans0_decode_chunks, ans0_encode_chunks
    chunks, freq, cum = _zipf_chunks(24, seed=5, a=1.4, mod=230)
    res = _check_encode(ans0_encode_chunks, chunks, freq, cum)
    _check_decode(ans0_decode_chunks, chunks, freq, cum, *res)


def test_route_picks_xla_on_cpu():
    from kanzi_tpu.ops import ans, route
    k = route.ans0_kernels()
    assert k.name == "xla"
    assert k.encode is ans.ans0_encode_chunks
    assert k.decode is ans.ans0_decode_chunks


def test_host_padding_and_shapes():
    """Rows and payload widths bucket to powers of two; pad rows carry a
    valid one-symbol table; the CUDA results have the XLA shapes."""
    import jax.numpy as jnp

    from kanzi_tpu.ops.ans_block import bucket, pad_tables
    from kanzi_tpu.ops.ans_cuda import decode_result_types, encode_result_types
    assert [bucket(n, 8) for n in (0, 1, 8, 9, 255, 256, 257)] == \
        [8, 8, 8, 16, 256, 256, 512]
    assert bucket(16394, 256) == 32768
    freq = np.full((3, 256), 16, np.int64)
    cum = np.cumsum(freq, axis=1) - freq
    fr, cm = pad_tables(freq, cum, 8)
    assert fr.dtype == cm.dtype == np.int32 and fr.shape == cm.shape == (8, 256)
    assert np.array_equal(fr[:3], freq) and np.array_equal(cm[:3], cum)
    assert (fr[3:].sum(axis=1) == SCALE).all() and (fr[3:, 0] == SCALE).all()
    assert not cm[3:].any()
    assert [(t.shape, t.dtype) for t in encode_result_types(8, CHUNK)] == [
        ((8, CHUNK), jnp.uint16), ((8,), jnp.int32), ((8, 4), jnp.int32)]
    assert [(t.shape, t.dtype) for t in decode_result_types(8, CHUNK)] == [
        ((8, CHUNK), jnp.uint8), ((8,), jnp.int32)]


def test_cuda_build_command_targets_hopper():
    import jax.ffi

    from kanzi_tpu.utils.native import cuda_build_command
    cmd = cuda_build_command()
    assert cmd[0].endswith("nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd
    assert cmd[-1].endswith("native/ans_cuda.cu")


def test_ans_block_wire_matches_host_encoder():
    """The device-glue wire (XLA scan on the CPU) equals the host
    ANSRangeEncoder(order=0) bytes — incl. a single-symbol chunk and a
    tail — and decodes back through the device decode route."""
    from kanzi_tpu.core.bits import BitReader, BitWriter
    from kanzi_tpu.entropy.ans import ANSRangeEncoder
    from kanzi_tpu.ops.ans_block import ans0_decode, ans0_encode

    rng = np.random.default_rng(1)
    data = (rng.zipf(1.5, 9 * CHUNK + 333) % 251).astype(np.uint8)
    data[2 * CHUNK:3 * CHUNK] = 17
    bw = BitWriter()
    ans0_encode(data.copy(), bw)
    bw2 = BitWriter()
    ANSRangeEncoder(bw2, 0).encode(data.copy())
    assert bw.getvalue() == bw2.getvalue()
    out = ans0_decode(data.size, BitReader(bw.getvalue()))
    assert np.array_equal(np.asarray(out, np.uint8), data)


def test_huffman_native_tables_match_python():
    from kanzi_tpu.core.bits import BitWriter
    from kanzi_tpu.entropy.huffman import HuffmanEncoder, build_tables_batch
    from kanzi_tpu.utils.native import get_lib

    if get_lib() is None:
        pytest.skip("native lib unavailable")
    hists = _random_hists(200, seed=9)
    hists = hists[(hists > 0).sum(1) >= 2]   # count<=1 rows bypass tables
    s, c, n = build_tables_batch(hists)
    enc = HuffmanEncoder(BitWriter())
    import kanzi_tpu.entropy.huffman as H
    for i in range(len(hists)):
        # force the pure-Python table computation
        f = hists[i].copy()
        alphabet = np.nonzero(f > 0)[0].astype(np.int64)
        sizes = np.zeros(256, np.int64)
        ranks = (f[alphabet] << 8) | alphabet
        fcopy = f.copy()
        ml = H._compute_code_lengths(sizes, ranks)
        if ml > H.MAX_SYMBOL_SIZE:
            ml = H._limit_code_lengths(alphabet, fcopy, sizes, ranks)
        if ml > H.MAX_SYMBOL_SIZE:
            codes = np.zeros(256, np.int64)
            codes[alphabet] = np.arange(len(alphabet))
            sizes[:] = 0
            sizes[alphabet] = 8
        else:
            ranks2 = (fcopy[alphabet] << 8) | alphabet
            codes = H._canonical_codes(sizes, np.sort(ranks2) & 0xFF)
        assert np.array_equal(sizes, s[i]), f"sizes row {i}"
        assert np.array_equal(codes, c[i]), f"codes row {i}"


def test_ans1_per_row_normalization_matches_scalar():
    from kanzi_tpu.entropy import utils as eu

    rng = np.random.default_rng(3)
    hist = np.zeros((300, 256), dtype=np.int64)
    for i in range(300):
        k = rng.integers(0, 257)
        if k:
            idx = rng.choice(256, size=k, replace=False)
            hist[i, idx] = rng.integers(1, 5000, size=k)
    totals = hist.sum(axis=1)
    out = eu.normalize_frequencies_batch(hist, totals, 2048)
    for i in range(300):
        f = hist[i].copy()
        eu.normalize_frequencies(f, int(totals[i]), 2048)
        assert np.array_equal(out[i], f)


# ---------------------------------------------------------------------------
# the CUDA kernel: only on an NVIDIA GPU (no interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 45, 256])
def test_cuda_encode_matches_oracle(gpu, n):
    from kanzi_tpu.ops.ans_cuda import ans0_encode_chunks
    _check_encode(ans0_encode_chunks, *_zipf_chunks(n, seed=11))


@pytest.mark.gpu
def test_cuda_decode_inverts_encode(gpu):
    from kanzi_tpu.ops.ans_cuda import ans0_decode_chunks, ans0_encode_chunks
    chunks, freq, cum = _zipf_chunks(48, seed=5, a=1.4, mod=230)
    res = _check_encode(ans0_encode_chunks, chunks, freq, cum)
    _check_decode(ans0_decode_chunks, chunks, freq, cum, *res)


@pytest.mark.gpu
def test_cuda_route_and_gate_round_trip(gpu, monkeypatch):
    from kanzi_tpu.core.bits import BitReader, BitWriter
    from kanzi_tpu.entropy.ans import ANSRangeDecoder, ANSRangeEncoder
    from kanzi_tpu.ops.route import ans0_kernels

    assert ans0_kernels().name == "cuda"
    rng = np.random.default_rng(23)
    data = (rng.zipf(1.4, 9 * CHUNK + 777) % 230).astype(np.uint8)
    host = BitWriter()
    ANSRangeEncoder(host, order=0).encode(data)
    monkeypatch.setenv("KANZI_TPU_DEVICE_ANS", "1")
    bw = BitWriter()
    ANSRangeEncoder(bw, order=0).encode(data)
    assert bw.getvalue() == host.getvalue()
    dec = ANSRangeDecoder(BitReader(bw.getvalue()), order=0)
    assert dec._device_decode_ok(len(data))
    assert np.array_equal(dec.decode(len(data)), data)
