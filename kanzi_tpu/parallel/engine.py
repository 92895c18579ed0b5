"""Device-mesh block engine: data-parallel compression over jax.sharding.

The reference's only parallel axis is independent blocks over a thread pool
(K/io/CompressedOutputStream.java:512-586, spin-wait ordered commit).  The
mesh equivalent shards the chunk axis of a block batch across a 1-D
``blocks`` mesh: every device runs the rANS scan on its shard, collective
metadata (per-chunk payload lengths) is all-gathered (NCCL over NVLink
between GPUs), and the host serializes blocks in order — same contract,
mesh instead of threads.

The per-device kernels come from ops/route.py.  A CUDA kernel behind the
FFI cannot be auto-partitioned, so every stage runs under ``shard_map``.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ans as jans
from ..ops.route import ans0_kernels


def _shard_map(fn, mesh: Mesh, *, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(n_devices: int | None = None, axis: str = "blocks") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            # a silent short mesh invalidates every scaling measurement
            # built on it (and did, in one debugging session) — fail loud
            raise ValueError(
                f"make_mesh({n_devices}): only {len(devs)} devices visible "
                f"on platform '{devs[0].platform}'")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@functools.lru_cache(maxsize=None)
def make_encode_step(mesh: Mesh):
    """Jitted block-batch ANS0 scan over the mesh.

    step(chunks u8 [N, C], freq i32 [N, 256], cum i32 [N, 256]) ->
    (payload [N, C] u16, lengths [N] i32 replicated, states [N, 4]), with
    N a multiple of the mesh size.  Histograms and the exact frequency
    normalization run on the host (ops/ans_block._chunk_stats).
    """
    axis = mesh.axis_names[0]
    enc = ans0_kernels().encode

    def local(ch, fr, cm):
        payload, n_emit, states = enc(ch, fr, cm)
        lengths = jax.lax.all_gather(n_emit, axis, tiled=True)
        return payload, lengths, states

    return jax.jit(_shard_map(local, mesh,
                              in_specs=(P(axis), P(axis), P(axis)),
                              out_specs=(P(axis), P(), P(axis))))


def mesh_ans0_compress(mesh: Mesh, block: np.ndarray,
                       chunk: int = 16384) -> bytes:
    """Compress ``block`` through the full mesh ANS0 pipeline and return the
    exact ANSRangeEncoder wire bytes (decodable by entropy.ans
    .ANSRangeDecoder with ``chunk_size=chunk``).  Full chunks run on the
    mesh; the tail chunk (and the <=32-byte degenerate case) run on host."""
    from ..core.bits import BitWriter
    from ..entropy import ans as hans
    from ..ops.ans_block import (_chunk_stats, assemble_ans0_wire, bucket,
                                 pad_tables)

    block = np.asarray(block, dtype=np.uint8)
    count = block.size
    bw = BitWriter()
    if count <= 32:
        bw.write_bytes(block.tobytes())
        return bw.getvalue()
    nfull = count // chunk
    tail = count - nfull * chunk
    if nfull:
        chunks = block[:nfull * chunk].reshape(nfull, chunk)
        freq, cum, nsym, alphabets = _chunk_stats(chunks)
        # pad the batch to a power-of-two multiple of the mesh size;
        # padded rows are dropped
        ndev = mesh.devices.size
        rows = bucket(nfull, 8)
        rows += (-rows) % ndev
        ch = np.zeros((rows, chunk), np.uint8)
        ch[:nfull] = chunks
        fr, cm = pad_tables(freq, cum, rows)
        pay_d, len_d, st_d = make_encode_step(mesh)(
            jnp.asarray(ch), jnp.asarray(fr), jnp.asarray(cm))
        assemble_ans0_wire(bw, freq, nsym, alphabets, np.asarray(len_d),
                           np.asarray(st_d), np.asarray(pay_d),
                           np.arange(nfull))
    if tail:
        enc = hans.ANSRangeEncoder(bw, 0, chunk_size=chunk)
        enc._encode_chunk(block[nfull * chunk:], bw)
    return bw.getvalue()


@functools.lru_cache(maxsize=None)
def make_decode_step(mesh: Mesh, maxp: int, chunk: int = 16384):
    """Jitted sharded ANS0 entropy-stage DECODE over the mesh — the mesh
    analogue of the reference's concurrent DecodingTasks
    (K/io/CompressedInputStream.java:1106-1191): the bitstream is parsed
    sequentially on the host (the format makes chunk headers sequential),
    then payload decode — the expensive part — fans out across the
    ``blocks`` axis, with per-chunk consumed-byte counts all-gathered so
    the host can verify stream integrity in order.

    ``maxp`` is the padded payload width.  step(payload u8 [N, maxp],
    states i32 [N, 4], freq i32 [N, 256], cum i32 [N, 256]) ->
    (out u8 [N, chunk], consumed i32 [N] replicated).
    """
    axis = mesh.axis_names[0]
    dec = ans0_kernels().decode

    def local(pay, st, fr, cm):
        out, used = dec(pay, st, fr, cm, chunk_size=chunk)
        used_all = jax.lax.all_gather(used, axis, tiled=True)
        return out, used_all

    fn = _shard_map(local, mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(axis)),
                    out_specs=(P(axis), P()))
    return jax.jit(fn)


def mesh_ans0_decompress(mesh: Mesh, wire: bytes, count: int,
                         chunk: int = 16384) -> np.ndarray:
    """Decode an ANSRangeEncoder order-0 stream with the chunk payloads
    sharded across the mesh (standalone-buffer wrapper around
    mesh_ans0_decode_stream)."""
    from ..core.bits import BitReader
    return mesh_ans0_decode_stream(mesh, BitReader(wire), count, chunk)


def mesh_ans0_decode_stream(mesh: Mesh, br, count: int,
                            chunk: int = 16384) -> np.ndarray:
    """Decode an ANSRangeEncoder order-0 stream from ``br`` (any bit
    position) with the chunk payloads sharded across the mesh — the mesh
    analogue of the reference's concurrent DecodingTasks
    (K/io/CompressedInputStream.java:1106-1191), callable mid-stream so
    the v7 reader's entropy stage can fan out.  Exact inverse of
    mesh_ans0_compress / entropy.ans.ANSRangeEncoder(order=0); chunk
    headers are parsed host-side in stream order, full standard chunks
    decode on the mesh, degenerate chunks (single-symbol) and the tail
    chunk on the host."""
    from ..core.errors import BitStreamError
    from ..entropy import ans as hans
    from ..entropy import utils as eu

    if count <= 32:
        return br.read_bytes(count)
    out = np.empty(count, dtype=np.uint8)
    nfull = count // chunk
    tail = count - nfull * chunk
    metas = []
    for i in range(nfull):
        lr = 8 + br.read_bits(3)
        if lr != jans.LOG_RANGE:
            raise BitStreamError("mesh decode: non-default log range",
                                 BitStreamError.INVALID_STREAM)
        alpha, freqs = hans._read_freqs_header(br, lr)
        if len(alpha) == 0:
            raise BitStreamError("empty ANS alphabet",
                                 BitStreamError.INVALID_STREAM)
        if len(alpha) == 1:
            out[i * chunk:(i + 1) * chunk] = int(alpha[0])
            continue
        sz = eu.read_varint(br)
        if sz >= hans.MAX_CHUNK_SIZE:
            raise BitStreamError("invalid ANS chunk size",
                                 BitStreamError.INVALID_STREAM)
        states = [br.read_bits(32) for _ in range(4)]
        pay = br.read_bytes(sz)
        metas.append((i, freqs, states, pay))
    if metas:
        ndev = mesh.devices.size
        nrows = len(metas) + ((-len(metas)) % ndev)
        maxp = 256
        while maxp < max(len(m[3]) for m in metas) + 8:
            maxp <<= 1
        pay = np.zeros((nrows, maxp), dtype=np.uint8)
        freq = np.zeros((nrows, 256), dtype=np.int64)
        freq[:, 0] = 1 << jans.LOG_RANGE     # valid tables for pad rows
        states = np.zeros((nrows, 4), dtype=np.int64)
        for k, m in enumerate(metas):
            pay[k, :len(m[3])] = m[3]
            freq[k] = m[1]
            states[k] = m[2]
        cum = np.concatenate([np.zeros((nrows, 1), dtype=np.int64),
                              np.cumsum(freq, axis=1)[:, :-1]], axis=1)
        step = make_decode_step(mesh, maxp, chunk)
        res_d, used_d = step(jnp.asarray(pay),
                             jnp.asarray(states, dtype=jnp.int32),
                             jnp.asarray(freq, dtype=jnp.int32),
                             jnp.asarray(cum, dtype=jnp.int32))
        res = np.asarray(res_d)
        used = np.asarray(used_d)
        for k, m in enumerate(metas):
            if int(used[k]) != len(m[3]):
                raise BitStreamError("ANS payload size mismatch (mesh)",
                                     BitStreamError.INVALID_STREAM)
            out[m[0] * chunk:(m[0] + 1) * chunk] = res[k]
    if tail:
        dec = hans.ANSRangeDecoder(br, 0, chunk_size=chunk)
        dec._decode_chunk(out, nfull * chunk, count, br)
    return out


import threading

# Serializes mesh dispatches issued from the stream writer's/reader's
# worker threads (the entropy-stage hooks in entropy/ans.py).  The lock is
# held once per block dispatch; batching every in-flight block into one
# make_encode_step / make_decode_step call would hold it once per batch.
MESH_DISPATCH_LOCK = threading.Lock()


def mesh_decompress(mesh: Mesh, blob: bytes, jobs: int | None = None) -> bytes:
    """Decode a complete v7 .knz stream with the ANS0 entropy stage
    sharded over the mesh — the decode-side counterpart of
    mesh_l5_compress / mesh_ans0_compress.  The standard reader drives
    block framing, transform inverses and checksums; every ANS0 entropy
    payload fans its chunk decode out across the ``blocks`` axis via the
    ctx hook (entropy/ans.ANSRangeDecoder.decode).  Match:
    K/io/CompressedInputStream.java:1106-1191 DecodingTask concurrency."""
    import io as _io

    from ..io.stream import CompressedInputStream

    ctx: dict = {"_ans0_mesh": mesh}
    if jobs:
        ctx["jobs"] = jobs
    return CompressedInputStream(_io.BytesIO(blob), ctx).read(-1)


@functools.lru_cache(maxsize=None)
def make_sa_step(mesh: Mesh, npad: int):
    """Sharded suffix-array stage (the level-5 BWT forward's heavy part):
    a batch of zero-right-padded blocks (rows of ``npad``, data first, pad
    zeros after — pad suffixes sort first, so the real positions are the
    LAST n SA entries) shards over the ``blocks`` axis; every device runs
    the prefix-doubling SA (ops/bwt_tpu) on its shard.  Any correct SA
    produces the identical BWT, so the wire does not depend on which
    engine built it."""
    from ..ops import bwt_tpu
    axis = mesh.axis_names[0]
    run = bwt_tpu._sa_jit(npad)

    def local(glob, n):
        return jax.vmap(run)(glob, n)

    fn = _shard_map(local, mesh, in_specs=(P(axis), P(axis)),
                    out_specs=P(axis))
    return jax.jit(fn)


def mesh_l5_compress(mesh: Mesh, data: np.ndarray,
                     block_size: int = 4 << 20, checksum: int = 0,
                     jobs: int | None = None) -> bytes:
    """Compress ``data`` at level 5 (TEXT+UTF+BWT+RANK+ZRLT + ANS0,
    BlockCompressor.java:539 row 5) with BOTH heavy per-block stages
    sharded over the mesh — the suffix array of every block's BWT input
    batches across devices up front, and each block's ANS0 entropy stage
    runs the sharded rANS pipeline — committed in block order through the
    standard v7 writer.  This is the EncodingTask scope
    (CompressedOutputStream.java:512-586) for a level with a REAL entropy
    codec, not just the NONE-entropy level 1.

    The light content filters (TEXT/UTF — and RANK/ZRLT after the BWT)
    stay on the host: RANK is serial by definition (SBRT.java:129-146)
    and the filters are linear scans; the mesh carries the O(n log n)
    suffix sort and the rANS scan.  TEXT+UTF run twice per block (once to
    derive the SA input, once inside the writer's chain) — they are cheap
    native filters and the duplication keeps the writer's Sequence
    semantics (skip flags, revert-on-failure) exactly stock."""
    import io as _io

    from ..core.types import TransformSkip
    from ..io.stream import MAX_CONCURRENCY, CompressedOutputStream
    from ..ops import bwt_tpu
    from ..transforms import factory as tf
    from ..utils.xxhash import xxhash64

    data = np.asarray(data, dtype=np.uint8)
    nblocks = max(1, -(-data.size // block_size))

    # pass A (host): each block's TEXT+UTF prefix — the exact bytes the
    # writer's chain will feed the BWT (same ctx: the text codec variant
    # is chosen by the ENTROPY id, TransformFactory.java:276-286).  The
    # outputs + skip flags go into a chain-prefix cache so the writer's
    # Sequence REUSES them instead of recomputing TEXT+UTF per block.
    pre = []
    prefix_map: dict = {}
    for bid in range(nblocks):
        blk = data[bid * block_size:(bid + 1) * block_size]
        ctx_a = {"entropy": "ANS0", "blockSize": block_size,
                 "size": blk.size}
        seq_a = tf.new_function(ctx_a, tf.get_type("TEXT+UTF"))
        try:
            tub = seq_a.forward(blk)
        except TransformSkip:
            tub = blk
        tub = np.asarray(tub, dtype=np.uint8)
        pre.append(tub)
        prefix_map[(blk.size, xxhash64(blk.tobytes(), 0))] = \
            (tub, seq_a.skip_flags, 2)

    # pass B (mesh): suffix arrays, one padded block per device row,
    # bucketed by padded length so each bucket is one fixed-shape dispatch
    sa_map: dict[tuple[int, int], np.ndarray] = {}
    ndev = mesh.devices.size
    by_bucket: dict[int, list[int]] = {}
    for bid, tub in enumerate(pre):
        if tub.size >= 4:
            by_bucket.setdefault(bwt_tpu._bucket(tub.size + 1),
                                 []).append(bid)
    for npad, bids in sorted(by_bucket.items()):
        step = make_sa_step(mesh, npad)
        for g0 in range(0, len(bids), ndev):  # one row per device per step
            grp = bids[g0:g0 + ndev]
            rows = len(grp) + ((-len(grp)) % ndev)
            glob = np.zeros((rows, npad), np.uint8)
            ns = np.full(rows, pre[grp[-1]].size, np.int32)  # pad rows
            for k, bid in enumerate(grp):
                glob[k, :pre[bid].size] = pre[bid]
                ns[k] = pre[bid].size
            if rows > len(grp):   # pad rows repeat the last real block
                glob[len(grp):] = glob[len(grp) - 1]
            sa_rows = np.asarray(step(jnp.asarray(glob), jnp.asarray(ns)))
            for k, bid in enumerate(grp):
                n = pre[bid].size
                sa = sa_rows[k][npad - n:].astype(np.int64)
                sa_map[(n, xxhash64(pre[bid].tobytes(), 0))] = sa

    # pass C: the standard v7 writer; BWT picks its SA from the map, the
    # ANS0 stage dispatches to the mesh (both via ctx hooks)
    sink = _io.BytesIO()
    cos = CompressedOutputStream(sink, {
        "entropy": "ANS0", "transform": "TEXT+UTF+BWT+RANK+ZRLT",
        "blockSize": block_size,
        "jobs": min(jobs or MAX_CONCURRENCY, MAX_CONCURRENCY, nblocks),
        "checksum": checksum, "fileSize": data.size})
    cos.ctx["_bwt_sa_map"] = sa_map
    cos.ctx["_ans0_mesh"] = mesh
    cos.ctx["_chain_prefix"] = prefix_map
    cos.write(data.tobytes())
    cos.close()
    return sink.getvalue()


# ---------------------------------------------------------------------------
# full level-1 pipeline on the mesh
# ---------------------------------------------------------------------------
#
# The reference's unit of parallelism is the whole EncodingTask — transform
# chain + entropy per block (CompressedOutputStream.java:512-586).  Level 1
# is LZX + NONE (BlockCompressor.java:539), so the sharded stage is the LZX
# match+parse engine (ops/lz_sort): every device analyzes its shard of the
# 256 KiB content rows, per-shard token counts are all-gathered (the
# ordered-commit metadata riding the collective), and the host commits
# blocks in order through the standard v7 writer — producing a
# byte-for-byte valid .knz stream that CompressedInputStream decodes.



def make_l1_step(mesh: Mesh, mm: int = 4):
    return _make_l1_step(mesh, mm)


@functools.lru_cache(maxsize=None)
def _make_l1_step(mesh: Mesh, mm: int):
    """Jitted sharded LZX analyze (v3 whole-block engine): blocks
    (B, bucket) u8 with B a multiple of the mesh size shard over the
    ``blocks`` axis; returns per-shard front-compacted token arrays
    (pos, mlen, dist) — positions are SHARD-local — plus the all-gathered
    per-shard token counts (the ordered-commit metadata).  Memoized per
    (mesh, mm) so repeated callers share one jit cache (XLA:CPU pays a
    large lazy kernel-codegen cost on an executable's first run)."""
    from ..ops import lz_sort as L
    axis = mesh.axis_names[0]

    def local(bufs, send, mdist):
        pk, dist, ntok = L._analyze_flat(bufs, send, mdist, mm)
        counts = jax.lax.all_gather(ntok[None], axis, tiled=True)
        return pk, dist, counts

    fn = _shard_map(local, mesh,
                    in_specs=(P(axis), P(axis), P(axis)),
                    out_specs=(P(axis), P(axis), P()))
    return jax.jit(fn)


def _l1_batch_arrays(blocks, live, ndev):
    """Fixed-shape (bufs, send, mdist, bucket, nb) batch for the sharded
    LZX stage over the ``live`` block indices."""
    from ..ops import lz_sort as L
    bucket = L._flat_bucket(max(blocks[i].size for i in live))
    nb = len(live) + ((-len(live)) % ndev)  # zero pad rows: no tokens
    bufs = np.zeros((nb, bucket), np.uint8)
    send = np.full(nb, -18, np.int32)
    mdist = np.zeros(nb, np.int32)
    for j, i in enumerate(live):
        bufs[j, :blocks[i].size] = blocks[i]
        send[j] = blocks[i].size - 18
        mdist[j] = L._block_max_dist(blocks[i].size)
    return bufs, send, mdist, bucket, nb


def tokens_to_hints(blocks, live, hints, pk, dist, counts, bucket, nb,
                    ndev, mm: int):
    """Reconstruct per-block stream-writer hints from the sharded stage's
    gathered token arrays (pk/dist: full front-compacted arrays; counts:
    per-shard token counts — the ordered-commit metadata).  Host-side
    numpy only, so it serves both the single-process fetch path and the
    multi-host process_allgather path."""
    from ..ops import lz_sort as L
    from ..ops.lz_tpu import _emit

    bps = nb // ndev                      # blocks per shard
    span = bps * bucket                   # positions per shard
    span_out = span // 4                  # compacted token slots per shard
    #                                       (the parse's aligned-4-group
    #                                       reduction: <=1 token per group)
    ps, ls, ds = [], [], []
    for s in range(ndev):
        k = int(counts[s])
        if k == 0:
            continue
        p_s, l_s = L._unpack_tokens(
            np.asarray(pk[s * span_out:s * span_out + k]))
        ps.append(p_s + s * span)
        ls.append(l_s)
        ds.append(np.asarray(
            dist[s * span_out:s * span_out + k]).astype(np.int64))
    if not ps:
        return hints
    p = np.concatenate(ps)
    l = np.concatenate(ls)
    d = np.concatenate(ds)
    for j, i in enumerate(live):
        lo, hi = np.searchsorted(p, [j * bucket, (j + 1) * bucket])
        pi, li, di = p[lo:hi] - j * bucket, l[lo:hi].copy(), d[lo:hi]
        src = blocks[i]
        if pi.size:
            md = L._block_max_dist(src.size)
            out = L._emit_native(src, mm, pi, li, di, md)
            if out is False:  # no native library: numpy emission path
                li = L._extend_tokens_host(src, pi, li, di, src.size - 18)
                out = _emit(src, src.size, mm, md, pi, li, di)
            hints[i] = (mm, out)
    return hints


def _l1_mesh_hints(mesh, chunks, mm: int = 4, step=None):
    """Run the sharded LZX stage over all ``chunks`` (one batch of blocks)
    and return per-block stream-writer hints [(mm, payload-or-None)]."""
    import jax.numpy as jnp

    from ..ops import lz_sort as L
    from ..ops.lz_tpu import MIN_BLOCK_LENGTH

    ndev = mesh.devices.size
    blocks = [np.asarray(b, dtype=np.uint8) for b in chunks]
    hints = [(mm, None)] * len(blocks)
    live = [i for i, b in enumerate(blocks)
            if MIN_BLOCK_LENGTH <= b.size <= L.MAX_FLAT]
    if not live:
        return hints
    bufs, send, mdist, bucket, nb = _l1_batch_arrays(blocks, live, ndev)
    if step is None:
        step = make_l1_step(mesh, mm)
    pk_d, dist_d, counts_d = step(
        jnp.asarray(bufs), jnp.asarray(send), jnp.asarray(mdist))
    return tokens_to_hints(blocks, live, hints, pk_d, dist_d,
                           np.asarray(counts_d), bucket, nb, ndev, mm)


def mesh_l1_compress(mesh: Mesh, data: np.ndarray,
                     block_size: int = 4 << 20, checksum: int = 0,
                     jobs: int | None = None) -> bytes:
    """Compress ``data`` at level 1 (LZX + NONE) with the per-block
    transform stage sharded over the mesh, returning a complete v7 .knz
    stream (header, block framing, copy fallbacks, optional checksums)
    byte-decodable by io.stream.CompressedInputStream.  ``jobs`` bounds
    the blocks per mesh dispatch (default: all blocks at once up to the
    stream cap; pass the mesh size to keep per-step shapes minimal)."""
    import io as _io

    from ..io.stream import MAX_CONCURRENCY, CompressedOutputStream

    data = np.asarray(data, dtype=np.uint8)
    nblocks = max(1, -(-data.size // block_size))
    sink = _io.BytesIO()
    cos = CompressedOutputStream(sink, {
        "entropy": "NONE", "transform": "LZX", "blockSize": block_size,
        "jobs": min(jobs or MAX_CONCURRENCY, MAX_CONCURRENCY, nblocks),
        "checksum": checksum, "fileSize": data.size})
    step = make_l1_step(mesh)
    cos._lz_hint_fn = lambda chunks: _l1_mesh_hints(mesh, chunks, 4, step)
    cos.write(data.tobytes())
    cos.close()
    return sink.getvalue()
