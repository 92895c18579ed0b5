"""Multi-host (multi-process) mesh dryrun — the SURVEY §2.9 north-star
contract made executable on one machine.

The reference has no network layer at all (its only parallelism is a
shared-memory thread pool, K/app/BlockCompressor.java:206); the mesh
equivalent prescribed by SURVEY §2.9 is: ``jax.distributed`` + a mesh
spanning every host's devices; the codec config (stream-header fields) is
known to all hosts; per-block (length, payload) pairs are all-gathered in
block order over the interconnect; host 0 serializes the bitstream.

This module proves that contract on CPU: two OS processes, each owning 4
virtual XLA:CPU devices, form one 8-device mesh.  The ANS0 entropy stage
(level 5's stage 2, the same jitted scan the single-process mesh path
uses — parallel/engine.make_encode_step) runs sharded across BOTH
processes; per-chunk payload lengths ride a cross-process all_gather;
payload shards are brought to every host with process_allgather; process 0
assembles the exact ANSRangeEncoder wire and verifies it decodes
byte-exactly (and matches the host encoder's bytes).

Run as a module (one process per host):

    python -m kanzi_tpu.parallel.multihost --process-id I --num-processes N \
        --coordinator localhost:PORT --out RESULT_FILE

or via ``__graft_entry__.dryrun_multihost()`` which spawns both processes.
"""

from __future__ import annotations

import argparse
import sys


def worker_main(process_id: int, num_processes: int, coordinator: str,
                out_path: str | None) -> None:
    import jax

    # fresh process, backend not yet initialized: pin the CPU platform
    # BEFORE distributed init, so these workers never open an accelerator
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    import numpy as np

    import jax.numpy as jnp
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..core.bits import BitWriter
    from ..entropy import ans as hans
    from ..ops.ans_block import _chunk_stats, assemble_ans0_wire
    from ..utils.corpus import mixed_corpus
    from .engine import make_encode_step

    devs = jax.devices()
    ndev = len(devs)
    assert ndev == num_processes * len(jax.local_devices()), \
        f"global {ndev} != {num_processes} x local"
    mesh = Mesh(np.array(devs), ("blocks",))

    # the "config broadcast": every host derives the identical codec config
    # (entropy id, chunk size, block count) — in a real deployment this is
    # the stream-header fields sent to all hosts (SURVEY §2.9)
    chunk = 16384
    nblocks = ndev * 2                       # 2 chunks per device
    data = mixed_corpus(nblocks * chunk, seed=42)   # deterministic everywhere
    chunks = data.reshape(nblocks, chunk)

    # each process feeds ONLY its local shard of the global batch
    sharding = NamedSharding(mesh, P("blocks"))
    rows_per_proc = nblocks // num_processes
    local_rows = chunks[process_id * rows_per_proc:
                        (process_id + 1) * rows_per_proc]
    garr = jax.make_array_from_process_local_data(sharding, local_rows,
                                                  chunks.shape)
    # histograms + exact normalization on each host for its own rows
    freq, cum, nsym, alphabets = _chunk_stats(chunks)
    lo, hi = process_id * rows_per_proc, (process_id + 1) * rows_per_proc
    gfreq, gcum = (jax.make_array_from_process_local_data(
        sharding, x[lo:hi].astype(np.int32), x.shape) for x in (freq, cum))

    pay_d, len_d, st_d = make_encode_step(mesh)(garr, gfreq, gcum)

    # per-chunk payload lengths are ALL-GATHERED inside the step (the
    # ordered-commit metadata riding the collective): replicated output,
    # addressable on every process
    lengths = np.asarray(jax.device_get(
        [s.data for s in len_d.addressable_shards][0]))
    assert lengths.shape == (nblocks,), lengths.shape

    # bring the sharded payloads to every host (the cross-host form of the
    # ordered variable-length gather); block order is the row order
    payload = np.asarray(mhu.process_allgather(pay_d, tiled=True))
    states = np.asarray(mhu.process_allgather(st_d, tiled=True))

    result = "FAIL"
    detail = ""
    try:
        if process_id == 0:
            # host 0 serializes the bitstream in block order
            bw = BitWriter()
            assemble_ans0_wire(bw, freq, nsym, alphabets, lengths, states,
                               payload, np.arange(nblocks))
            wire = bw.getvalue()
            # byte-exact vs the single-process host encoder on the same data
            hw = BitWriter()
            enc = hans.ANSRangeEncoder(hw, 0, chunk_size=chunk)
            enc.encode(data)
            host_wire = hw.getvalue()
            assert wire == host_wire, \
                f"multi-host wire differs: {len(wire)} vs {len(host_wire)}"
            # ... and it decodes back to the input
            from ..core.bits import BitReader
            dec = hans.ANSRangeDecoder(
                BitReader(np.frombuffer(wire, dtype=np.uint8)), 0,
                chunk_size=chunk)
            got = dec.decode(data.size)
            assert np.array_equal(got, data), "multi-host decode mismatch"
            detail = (f"{num_processes} processes x "
                      f"{len(jax.local_devices())} devices; "
                      f"{data.size} B -> {len(wire)} B wire, byte-exact "
                      f"vs host encoder, decode verified")
        else:
            detail = "worker shard contributed; lengths replicated ok"
        # every process must agree on the replicated lengths (the ordered
        # commit depends on it)
        mhu.assert_equal(jnp.asarray(lengths),
                         "per-chunk lengths diverged across processes")

        # ---- phase 2: the FULL level-1 transform stage (LZX sort engine)
        # sharded across both processes — the whole per-block EncodingTask
        # scope (CompressedOutputStream.java:512-586), not just entropy.
        import io as _io

        from ..io.stream import CompressedInputStream, CompressedOutputStream
        from .engine import (_l1_batch_arrays, make_l1_step,
                             tokens_to_hints)

        blk = 256 << 10
        l1_data = mixed_corpus(ndev * blk, seed=43)
        blocks = [l1_data[i * blk:(i + 1) * blk] for i in range(ndev)]
        live = list(range(ndev))
        bufs, send, mdist, bucket, nb = _l1_batch_arrays(blocks, live, ndev)
        gb = jax.make_array_from_process_local_data(
            sharding, bufs[process_id * (nb // num_processes):
                           (process_id + 1) * (nb // num_processes)],
            bufs.shape)
        sh1 = NamedSharding(mesh, P("blocks"))
        rows = nb // num_processes
        gs = jax.make_array_from_process_local_data(
            sh1, send[process_id * rows:(process_id + 1) * rows],
            send.shape)
        gm = jax.make_array_from_process_local_data(
            sh1, mdist[process_id * rows:(process_id + 1) * rows],
            mdist.shape)
        step1 = make_l1_step(mesh, 4)
        pk_d, dist_d, counts_d = step1(gb, gs, gm)
        counts = np.asarray(jax.device_get(
            [s.data for s in counts_d.addressable_shards][0]))
        pk = np.asarray(mhu.process_allgather(pk_d, tiled=True))
        dist = np.asarray(mhu.process_allgather(dist_d, tiled=True))
        if process_id == 0:
            hints = tokens_to_hints(blocks, live, [(4, None)] * ndev,
                                    pk, dist, counts, bucket, nb, ndev, 4)
            sink = _io.BytesIO()
            cos = CompressedOutputStream(sink, {
                "entropy": "NONE", "transform": "LZX", "blockSize": blk,
                "jobs": 2, "fileSize": l1_data.size})
            done = {"i": 0}

            def hint_fn(chs):
                base = done["i"]
                done["i"] += len(chs)
                return hints[base:base + len(chs)]

            cos._lz_hint_fn = hint_fn
            cos.write(l1_data.tobytes())
            cos.close()
            wire1 = sink.getvalue()
            got1 = CompressedInputStream(_io.BytesIO(wire1),
                                         {"jobs": 2}).read(-1)
            assert got1 == l1_data.tobytes(), "multihost l1 round-trip"
            detail += (f"; l1 transform stage sharded across processes: "
                       f"{l1_data.size} B -> {len(wire1)} B, round-trip ok")
        result = "OK"
    finally:
        if out_path:
            with open(out_path, "w") as f:
                f.write(f"{result} p{process_id}: {detail}\n")
    if result != "OK":
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    worker_main(a.process_id, a.num_processes, a.coordinator, a.out)


if __name__ == "__main__":
    main()
