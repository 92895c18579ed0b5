"""Canonical Huffman codec, chunked with 4 interleaved streams.

Wire format re-derived from K/entropy/HuffmanEncoder.java:44-511,
HuffmanDecoder.java:42-605 and HuffmanCommon.java:26-111:

  per 16 KiB chunk (tail chunk may be smaller):
    if chunk < 32 bytes: raw bytes
    else:
      alphabet (EntropyUtils format)
      code lengths as signed Exp-Golomb deltas from previous length (start 2)
      if alphabet size > 1:
        4 varints: per-stream payload bit counts
        4 bit-packed streams, stream j encoding symbols of fragment j
          (fragment size = chunk//4)
        chunk%4 leftover symbols as raw bytes

Code lengths come from the Moffat–Katajainen in-place minimum-redundancy
algorithm, limited to 12 bits via the reference's bit-debt repayment scheme.
Canonical codes assign increasing codes over symbols ordered by
(length, value).

Implementation is array-first: encoding a chunk is a table lookup + one
vectorized MSB-first pack; decoding builds a 4096-entry (len,symbol) LUT and
follows the bit-offset chain with logarithmic pointer-doubling instead of a
serial bit loop.
"""

from __future__ import annotations

import numpy as np

from ..core.bits import BitReader, BitWriter, pack_msb
from ..core.errors import BitStreamError
from ..core.globals import histogram_order0
from . import utils as eu
from .expgolomb import ExpGolombDecoder, ExpGolombEncoder

LOG_MAX_CHUNK_SIZE = 14
MAX_CHUNK_SIZE = 1 << LOG_MAX_CHUNK_SIZE
MIN_CHUNK_SIZE = 1024
MAX_SYMBOL_SIZE = 12  # bitstream version >= 4
_TABLE_MASK = (1 << MAX_SYMBOL_SIZE) - 1


# --------------------------------------------------------------------------
# code length computation (Moffat–Katajainen) + length limiting
# --------------------------------------------------------------------------

def _mk_phase1(data: list[int], n: int) -> None:
    s = r = 0
    for t in range(n - 1):
        total = 0
        for _ in range(2):
            if s >= n or (r < t and data[r] < data[s]):
                total += data[r]
                data[r] = t
                r += 1
            else:
                total += data[s]
                if s > t:
                    data[s] = 0
                s += 1
        data[t] = total


def _mk_phase2(data: list[int], n: int) -> int:
    if n < 2:
        return 0
    level_top = n - 2
    depth = 1
    i = n
    nodes_at_level = 2
    while i > 0:
        k = level_top
        while k > 0 and data[k - 1] >= level_top:
            k -= 1
        internal = level_top - k
        leaves = nodes_at_level - internal
        for _ in range(leaves):
            i -= 1
            data[i] = depth
        nodes_at_level = internal << 1
        level_top = k
        depth += 1
    return depth - 1


def _compute_code_lengths(sizes: np.ndarray, ranks: np.ndarray) -> int:
    """ranks: (freq<<8)|symbol packed; sorts in place semantics of the spec."""
    order = np.sort(ranks)
    freqs = [int(x) >> 8 for x in order]
    syms = [int(x) & 0xFF for x in order]
    if any(f == 0 for f in freqs):
        return 0
    n = len(freqs)
    _mk_phase1(freqs, n)
    max_len = _mk_phase2(freqs, n)
    for i in range(n):
        sizes[syms[i]] = freqs[i]
    return max_len


def _limit_code_lengths(alphabet: np.ndarray, freqs: np.ndarray,
                        sizes: np.ndarray, ranks: np.ndarray) -> int:
    """Cap lengths at MAX_SYMBOL_SIZE repaying bit debt
    (HuffmanEncoder.java:191-273)."""
    count = len(alphabet)
    order = [int(x) & 0xFF for x in np.sort(ranks)]
    n = 0
    debt = 0
    while n < count and sizes[order[n]] >= MAX_SYMBOL_SIZE:
        debt += int(sizes[order[n]]) - MAX_SYMBOL_SIZE
        sizes[order[n]] = MAX_SYMBOL_SIZE
        n += 1
    ll: list[list[int]] = [[] for _ in range(6)]
    while n < count:
        idx = MAX_SYMBOL_SIZE - 1 - int(sizes[order[n]])
        if idx >= len(ll) or debt < (1 << idx):
            break
        ll[idx].append(order[n])
        n += 1
    idx = len(ll) - 1
    while debt > 0 and idx >= 0:
        if not ll[idx] or debt < (1 << idx):
            idx -= 1
            continue
        r = ll[idx].pop(0)
        sizes[r] += 1
        debt -= 1 << idx
    idx = 0
    while debt > 0 and idx < len(ll):
        if not ll[idx]:
            idx += 1
            continue
        r = ll[idx].pop(0)
        sizes[r] += 1
        debt -= 1 << idx
    if debt > 0:
        # Slow path: renormalize to a smaller scale and recompute
        f = freqs[alphabet].astype(np.int64)
        total = int(f.sum())
        fr = f.copy()
        eu.normalize_frequencies(fr, total, MAX_CHUNK_SIZE >> 3)
        freqs[alphabet] = fr
        new_ranks = (fr.astype(np.int64) << 8) | alphabet.astype(np.int64)
        return _compute_code_lengths(sizes, new_ranks)
    return MAX_SYMBOL_SIZE


def _canonical_codes(sizes: np.ndarray, symbols: np.ndarray,
                     max_size: int = MAX_SYMBOL_SIZE) -> np.ndarray | None:
    """Canonical code assignment over (length, value)-sorted symbols
    (HuffmanCommon.java:71-111)."""
    codes = np.zeros(256, dtype=np.int64)
    syms = np.asarray(symbols, dtype=np.int64)
    if np.any(sizes[syms] > max_size) or np.any(sizes[syms] < 1):
        return None
    order = syms[np.lexsort((syms, sizes[syms]))]
    code = 0
    cur_len = int(sizes[order[0]])
    for s in order:
        code <<= int(sizes[s]) - cur_len
        cur_len = int(sizes[s])
        codes[s] = code
        code += 1
    return codes


def build_tables_batch(hists: np.ndarray):
    """Batch (sizes, codes, alphabet counts) for (N, 256) histograms —
    C++ fast path with a bit-exact Python fallback."""
    n = hists.shape[0]
    hists = np.ascontiguousarray(hists, dtype=np.int64)
    try:
        from ..utils.native import get_lib
        lib = get_lib()
    except Exception:
        lib = None
    if lib is not None and hasattr(lib, "huffman_build_tables"):
        import ctypes
        codes = np.zeros((n, 256), dtype=np.uint16)
        sizes = np.zeros((n, 256), dtype=np.uint8)
        nsym = np.zeros(n, dtype=np.int32)
        rc = lib.huffman_build_tables(
            hists.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(n),
            codes.ctypes.data_as(ctypes.c_void_p),
            sizes.ctypes.data_as(ctypes.c_void_p),
            nsym.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return sizes.astype(np.int64), codes.astype(np.int64), nsym
        raise BitStreamError("invalid Huffman code length 0",
                             BitStreamError.INVALID_STREAM)
    # Python fallback: reuse the single-chunk machinery
    sizes = np.zeros((n, 256), dtype=np.int64)
    codes = np.zeros((n, 256), dtype=np.int64)
    nsym = np.zeros(n, dtype=np.int32)
    enc = HuffmanEncoder(BitWriter())
    for i in range(n):
        nsym[i] = enc._update_frequencies(hists[i].copy())
        sizes[i] = enc.sizes
        codes[i] = enc.codes
    return sizes, codes, nsym


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

class HuffmanEncoder:
    def __init__(self, bw: BitWriter, chunk_size: int = MAX_CHUNK_SIZE) -> None:
        if not MIN_CHUNK_SIZE <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("invalid Huffman chunk size")
        self.bw = bw
        self.chunk_size = chunk_size
        self.codes = np.zeros(256, dtype=np.int64)
        self.sizes = np.zeros(256, dtype=np.int64)

    def _update_frequencies(self, freqs: np.ndarray) -> int:
        bw = self.bw
        self.codes[:] = 0
        alphabet = np.nonzero(freqs > 0)[0].astype(np.int64)
        count = len(alphabet)
        eu.encode_alphabet(bw, alphabet)
        if count == 0:
            return 0
        try:
            from ..utils.native import get_lib
            _lib = get_lib()
            native = _lib is not None and hasattr(_lib, "huffman_build_tables")
        except Exception:
            native = False
        if native and count > 1:
            s, c, _n = build_tables_batch(freqs[None].astype(np.int64))
            self.sizes[:] = s[0]
            self.codes = c[0]
            eg = ExpGolombEncoder(bw, True)
            deltas = np.diff(np.concatenate(
                [[2], self.sizes[alphabet]])).astype(np.int64)
            eg.encode(deltas.astype(np.uint8))
            return count
        sizes = self.sizes
        sizes[:] = 0
        if count == 1:
            self.codes[alphabet[0]] = 0
            sizes[alphabet[0]] = 1
        else:
            ranks = (freqs[alphabet].astype(np.int64) << 8) | alphabet
            fcopy = freqs.astype(np.int64).copy()
            max_len = _compute_code_lengths(sizes, ranks)
            if max_len == 0:
                raise BitStreamError("invalid Huffman code length 0",
                                     BitStreamError.INVALID_STREAM)
            if max_len > MAX_SYMBOL_SIZE:
                max_len = _limit_code_lengths(alphabet, fcopy, sizes, ranks)
                if max_len == 0:
                    raise BitStreamError("invalid Huffman code length 0",
                                         BitStreamError.INVALID_STREAM)
            if max_len > MAX_SYMBOL_SIZE:
                # last resort: fixed 8-bit codes (HuffmanEncoder.java:146-155)
                for n, s in enumerate(alphabet):
                    self.codes[s] = n
                    sizes[s] = 8
            else:
                ranks2 = (fcopy[alphabet] << 8) | alphabet
                c = _canonical_codes(sizes, np.sort(ranks2) & 0xFF)
                if c is None:
                    raise BitStreamError("Huffman code gen failed",
                                         BitStreamError.INVALID_STREAM)
                self.codes = c
        # transmit lengths as signed deltas, ExpGolomb (prev starts at 2)
        eg = ExpGolombEncoder(bw, True)
        deltas = np.diff(np.concatenate([[2], sizes[alphabet]])).astype(np.int64)
        eg.encode(deltas.astype(np.uint8))
        return count

    def encode(self, block: np.ndarray, bw: BitWriter | None = None) -> int:
        bw = bw or self.bw
        block = np.asarray(block, dtype=np.uint8)
        count = block.size
        if count == 0:
            return 0
        # whole-block native fast path: all histograms, tables, chunk
        # headers and the 4 packed streams in one C++ call
        from ..utils.native_coders import huffman_block_encode_native
        if huffman_block_encode_native(block, self.chunk_size, bw):
            return count
        start = 0
        while start < count:
            sz = min(self.chunk_size, count - start)
            chunk = block[start:start + sz]
            if sz < 32:
                bw.write_bytes(chunk.tobytes())
            else:
                freqs = histogram_order0(chunk)
                if self._update_frequencies(freqs) > 1:
                    self._encode_chunk(chunk, bw)
            start += sz
        return count

    def _encode_chunk(self, chunk: np.ndarray, bw: BitWriter) -> None:
        n = chunk.size
        frag = n // 4
        lens = self.sizes[chunk]
        vals = self.codes[chunk].astype(np.uint64)
        streams = []
        for j in range(4):
            sl = slice(j * frag, (j + 1) * frag)
            bits = pack_msb(vals[sl], lens[sl])
            streams.append(bits)
        for bits in streams:
            eu.write_varint(bw, bits.size)
        for bits in streams:
            bw.write_bit_array(bits)
        # leftover symbols as raw bytes
        for i in range(4 * frag, n):
            bw.write_bits(int(chunk[i]), 8)

    def dispose(self) -> None:
        pass


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

class HuffmanDecoder:
    def __init__(self, br: BitReader, chunk_size: int = MAX_CHUNK_SIZE,
                 bs_version: int = 7) -> None:
        if not MIN_CHUNK_SIZE <= chunk_size <= MAX_CHUNK_SIZE:
            raise ValueError("invalid Huffman chunk size")
        self.bs_version = bs_version
        self.br = br
        self.chunk_size = chunk_size
        self.sizes = np.full(256, 8, dtype=np.int64)
        self.alphabet = np.zeros(0, dtype=np.int64)

    def _read_lengths(self) -> int:
        br = self.br
        alphabet = eu.decode_alphabet(br).astype(np.int64)
        count = len(alphabet)
        self.alphabet = alphabet
        if count == 0:
            return 0
        eg = ExpGolombDecoder(br, True)
        cur = 2
        for s in alphabet:
            d = eg.decode_byte()
            if d >= 128:
                d -= 256
            cur += d
            if cur <= 0 or cur > MAX_SYMBOL_SIZE:
                raise BitStreamError(f"invalid Huffman length {cur}",
                                     BitStreamError.INVALID_STREAM)
            self.sizes[s] = cur
        return count

    def _build_luts(self) -> tuple[np.ndarray, np.ndarray]:
        codes = _canonical_codes(self.sizes, self.alphabet)
        if codes is None:
            raise BitStreamError("Huffman table build failed",
                                 BitStreamError.INVALID_STREAM)
        sym_lut = np.full(1 << MAX_SYMBOL_SIZE, 7, dtype=np.int64)
        len_lut = np.zeros(1 << MAX_SYMBOL_SIZE, dtype=np.int64)
        for s in self.alphabet:
            ln = int(self.sizes[s])
            lo = int(codes[s]) << (MAX_SYMBOL_SIZE - ln)
            hi = lo + (1 << (MAX_SYMBOL_SIZE - ln))
            sym_lut[lo:hi] = s
            len_lut[lo:hi] = ln
        return sym_lut, len_lut

    def decode(self, count: int, br: BitReader | None = None) -> np.ndarray:
        br = br or self.br
        out = np.empty(count, dtype=np.uint8)
        start = 0
        if self.bs_version < 6:
            # single-stream legacy layout (HuffmanDecoder.java:213, :231-345)
            while start < count:
                sz = min(self.chunk_size, count - start)
                n_sym = self._read_lengths()
                if n_sym == 0:
                    raise BitStreamError("empty Huffman alphabet",
                                         BitStreamError.INVALID_STREAM)
                if n_sym == 1:
                    out[start:start + sz] = self.alphabet[0]
                else:
                    if br.read_bits(2) != 0:
                        raise BitStreamError(
                            "unsupported Huffman stream count",
                            BitStreamError.INVALID_STREAM)
                    sz_bits = eu.read_varint(br)
                    if sz_bits != 0:
                        sym_lut, len_lut = self._build_luts()
                        bits = br.read_bit_array(sz_bits)
                        # the last codes may rely on zero padding past the
                        # declared bit count; _chain_decode zero-pads
                        syms, _ = _chain_decode(bits, sz, sym_lut, len_lut)
                        out[start:start + sz] = syms
                start += sz
            return out
        # whole-block native fast path: all chunk headers + canonical
        # tables + 4-stream interleaved decode in one C++ call
        # (HuffmanDecoder.java:213-345 ILP shape)
        from ..utils.native_coders import huffman_block_decode_native
        res = huffman_block_decode_native(br, count, self.chunk_size)
        if res is not None:
            return res
        while start < count:
            sz = min(self.chunk_size, count - start)
            if sz < 32:
                out[start:start + sz] = br.read_bytes(sz)
            else:
                n_sym = self._read_lengths()
                if n_sym == 0:
                    raise BitStreamError("empty Huffman alphabet",
                                         BitStreamError.INVALID_STREAM)
                if n_sym == 1:
                    out[start:start + sz] = self.alphabet[0]
                else:
                    self._decode_chunk(out, start, sz, br)
            start += sz
        return out

    def _decode_chunk(self, out: np.ndarray, start: int, sz: int,
                      br: BitReader) -> None:
        from ..utils.native_coders import huffman_decode_native
        sym_lut, len_lut = self._build_luts()
        sz_bits = [eu.read_varint(br) for _ in range(4)]
        frag = sz // 4
        for j in range(4):
            packed = br.read_packed(sz_bits[j])
            res = huffman_decode_native(packed, sz_bits[j], frag,
                                        sym_lut, len_lut)
            if res is not None:
                syms, end_pos = res
            else:  # no library: unpack for the numpy chain decode
                bits = np.unpackbits(packed)[:sz_bits[j]]
                syms, end_pos = _chain_decode(bits, frag, sym_lut, len_lut)
            if end_pos != sz_bits[j]:
                raise BitStreamError("Huffman stream length mismatch",
                                     BitStreamError.INVALID_STREAM)
            out[start + j * frag:start + (j + 1) * frag] = syms
        for i in range(4 * frag, sz):
            out[start + i] = br.read_bits(8)

    def dispose(self) -> None:
        pass


def _chain_decode(bits: np.ndarray, n_sym: int, sym_lut: np.ndarray,
                  len_lut: np.ndarray) -> tuple[np.ndarray, int]:
    """Decode ``n_sym`` symbols from an MSB-first bit array via pointer
    doubling: every bit offset's 12-bit window is classified in parallel,
    then the offset chain 0 -> +len -> ... is materialized in log2(n) gathers.
    """
    nbits = bits.size
    padded = np.concatenate([bits, np.zeros(MAX_SYMBOL_SIZE, dtype=np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, MAX_SYMBOL_SIZE)[:nbits + 1]
    weights = (1 << np.arange(MAX_SYMBOL_SIZE - 1, -1, -1)).astype(np.int64)
    windows = win.astype(np.int64) @ weights
    lens = np.maximum(len_lut[windows], 1)  # avoid 0-step cycles on corrupt data
    dom = nbits + 1 + MAX_SYMBOL_SIZE
    jump = np.arange(dom, dtype=np.int64)
    jump[:nbits + 1] = np.minimum(np.arange(nbits + 1) + lens, dom - 1)
    # enumerate the orbit of 0 under `jump` (first n_sym positions)
    pos = np.zeros(1, dtype=np.int64)
    j = jump
    while pos.size < n_sym:
        nxt = j[pos]
        pos = np.concatenate([pos, nxt])
        if pos.size < n_sym:
            j = j[j]
    pos = pos[:n_sym]
    end_pos = int(jump[pos[-1]]) if n_sym > 0 else 0
    syms = sym_lut[windows[np.minimum(pos, nbits)]]
    return syms.astype(np.uint8), end_pos
