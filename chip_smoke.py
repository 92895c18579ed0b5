"""Smoke test of kanzi_tpu on an NVIDIA GPU: the quickest proof that the
system starts on the card and that its device stages give exact results.

    python chip_smoke.py              # one card: phases 0, 1 and 2
    python chip_smoke.py --cards 4    # four cards: phase 0 and the mesh phase

Phase 0  environment: JAX's default device is a GPU (no CPU fallback), the
         card's name and power limit, the compile cache, and the native C++
         library built on this machine from the tracked sources.
Phase 1  the rANS order-0 encode and decode routes the card takes
         (ops/route.py), and the XLA scan, against the exact-integer numpy
         oracle at 256 and 4096 chunks of 16 KiB, tolerance 0; the device
         wire of one 4 MiB block against the host encoder's bytes.
Phase 2  the main path: levels 1 and 5 through CompressedOutputStream and
         CompressedInputStream on mixed_corpus(211_957_760, seed) (the size
         of silesia.tar), with the KANZI_TPU_DEVICE_* gates on and off.
Mesh     levels 1 and 5 through parallel/engine's mesh functions on 4 cards
         against the same functions on 1 card, byte for byte.

Every check raises on failure, so any failed phase exits non-zero.  The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

CHUNK = 16384
SILESIA_BYTES = 211_957_760
GATES = {1: ("KANZI_TPU_DEVICE_LZ",),
         5: ("KANZI_TPU_DEVICE_BWT", "KANZI_TPU_DEVICE_ANS")}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def gates(level: int, on: bool):
    """Set (or clear) the level's device gates for the duration."""
    names = GATES[level] if on else ()
    old = {g: os.environ.pop(g, None) for gs in GATES.values() for g in gs}
    os.environ.update({g: "1" for g in names})
    try:
        yield
    finally:
        for g, v in old.items():
            os.environ.pop(g, None)
            if v is not None:
                os.environ[g] = v


def best_of(fn, reps: int = 5) -> float:
    """Best wall time of ``reps`` warm calls; fn must block on its result."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def phase_env(cards: int):
    import jax

    import kanzi_tpu  # noqa: F401  (sets the compile cache if unset)
    from kanzi_tpu.utils import native

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default device is "
                         f"{devs[0].platform!r}, not a GPU")
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: {cards} cards asked, {len(devs)} seen")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"phase 0: device_kind={devs[0].device_kind!r} count={len(devs)}")
    log(f"phase 0: nvidia-smi: {smi}")
    log(f"phase 0: compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    lib = native.get_lib()
    if lib is None or lib._name != native._SO or not os.path.exists(native._SO):
        raise SystemExit("chip_smoke: native library did not build or load")
    log(f"phase 0: native library {os.path.basename(lib._name)} "
        f"(key {native.build_key()}: tracked sources on this machine)")
    return devs, card


def phase_kernels(card: str, seed: int, counts=(256, 4096)) -> None:
    import jax
    import jax.numpy as jnp

    from kanzi_tpu.core.bits import BitWriter
    from kanzi_tpu.entropy.ans import ANSRangeEncoder
    from kanzi_tpu.ops import ans as xla
    from kanzi_tpu.ops.ans_block import _chunk_stats, ans0_encode
    from kanzi_tpu.ops.ans_oracle import ans0_encode_oracle, payload_bytes
    from kanzi_tpu.ops.route import ans0_kernels
    from kanzi_tpu.utils.corpus import mixed_corpus

    route = ans0_kernels()
    impls = {route.name: route}
    impls.setdefault("xla", type(route)(xla.ans0_encode_chunks,
                                        xla.ans0_decode_chunks, "xla"))
    data = mixed_corpus(max(max(counts) * CHUNK, 4 << 20), seed=seed)
    for n in counts:
        chunks = data[:n * CHUNK].reshape(n, CHUNK)
        freq, cum, _, _ = _chunk_stats(chunks)
        po, no, so = ans0_encode_oracle(chunks, freq, cum)
        width = 1 << int(2 * no.max() + 8 - 1).bit_length()
        args = (jnp.asarray(chunks), jnp.asarray(freq, jnp.int32),
                jnp.asarray(cum, jnp.int32))
        dargs = (jnp.asarray(payload_bytes(po, no, width)),
                 jnp.asarray(so, jnp.int32)) + args[1:]
        for name, k in impls.items():
            p, ne, st = (np.asarray(x) for x in k.encode(*args))
            assert np.array_equal(ne, no), f"{name} n_emit != oracle"
            assert np.array_equal(st.astype(np.int64), so), \
                f"{name} states != oracle"
            mask = np.arange(CHUNK)[None, :] < no[:, None]
            assert np.array_equal(np.where(mask, p, 0), po), \
                f"{name} payload != oracle"
            out, used = (np.asarray(x) for x in k.decode(*dargs))
            assert np.array_equal(out, chunks), f"{name} decode != input"
            assert np.array_equal(used, 2 * no), f"{name} consumed != oracle"
            t_enc = best_of(lambda: jax.block_until_ready(k.encode(*args)))
            t_dec = best_of(lambda: jax.block_until_ready(k.decode(*dargs)))
            log(f"phase 1: {name} ans0 n={n} chunks exact vs oracle; "
                f"encode {t_enc * 1e3:.3f} ms, decode {t_dec * 1e3:.3f} ms "
                f"(warm, best of 5) on {card}")
    block = data[:4 << 20]
    bw = BitWriter()
    ans0_encode(block, bw)
    hw = BitWriter()
    ANSRangeEncoder(hw, 0).encode(block)
    assert bw.getvalue() == hw.getvalue(), "device ANS0 wire != host wire"
    log(f"phase 1: ans_block.ans0_encode wire == ANSRangeEncoder(order=0) "
        f"wire ({len(bw.getvalue())} B for a 4 MiB block)")


def _compress(level: int, raw: bytes, jobs: int) -> bytes:
    from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
    t, e, b = LEVELS[level]
    return BlockCompressor(transform=t, entropy=e, block_size=b,
                           jobs=jobs).compress_bytes(raw)


def _decompress(wire: bytes, jobs: int) -> bytes:
    from kanzi_tpu.io.stream import CompressedInputStream
    return CompressedInputStream(io.BytesIO(wire), {"jobs": jobs}).read(-1)


def phase_main(dev, card: str, size: int, seed: int) -> None:
    from kanzi_tpu.utils.corpus import mixed_corpus

    jobs = min(os.cpu_count() or 1, 64)
    t0 = time.perf_counter()
    raw = mixed_corpus(size, seed=seed).tobytes()
    log(f"phase 2: mixed_corpus({size}, seed={seed}) in "
        f"{time.perf_counter() - t0:.1f} s; jobs={jobs}")
    for level in (1, 5):
        wires = {}
        for on in (True, False):
            tag = "gates on " if on else "gates off"
            with gates(level, on):
                t0 = time.perf_counter()
                wire = _compress(level, raw, jobs)
                t_enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = _decompress(wire, jobs)
                t_dec = time.perf_counter() - t0
            assert out == raw, f"level {level} {tag}: round trip differs"
            wires[on] = wire
            peak = ""
            if on:
                peak = (f"; device peak_bytes_in_use "
                        f"{dev.memory_stats()['peak_bytes_in_use']}")
            log(f"phase 2: level {level} {tag}: {size} -> {len(wire)} B "
                f"round trip byte-exact; compress {t_enc:.2f} s, "
                f"decompress {t_dec:.2f} s (smoke timings, first run "
                f"includes compilation) on {card}{peak}")
        if level == 5:
            assert wires[True] == wires[False], "level 5 gated != host"
            log("phase 2: level 5 gated output == host output")
        else:
            assert len(wires[True]) <= len(wires[False]), \
                "level 1 gated output larger than host output"
            log(f"phase 2: level 1 gated {len(wires[True])} B <= host "
                f"{len(wires[False])} B")


def phase_mesh(card: str, size: int, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from kanzi_tpu.ops import lz_sort
    from kanzi_tpu.ops.ans_block import _chunk_stats
    from kanzi_tpu.parallel import engine
    from kanzi_tpu.utils.corpus import mixed_corpus

    data = mixed_corpus(size, seed=seed)
    raw = data.tobytes()
    meshes = {n: engine.make_mesh(n) for n in (4, 1)}
    mesh = meshes[4]
    # where the shards of each sharded stage land
    chunks = data[:64 * CHUNK].reshape(64, CHUNK)
    freq, cum, _, _ = _chunk_stats(chunks)
    pay, _, _ = engine.make_encode_step(mesh)(
        jnp.asarray(chunks), jnp.asarray(freq, jnp.int32),
        jnp.asarray(cum, jnp.int32))
    blk = 1 << 20
    blocks = [data[i * blk:(i + 1) * blk] for i in range(4)]
    bufs, send, mdist, _, _ = engine._l1_batch_arrays(blocks, range(4), 4)
    pk, _, _ = engine.make_l1_step(mesh)(
        jnp.asarray(bufs), jnp.asarray(send), jnp.asarray(mdist))
    for name, arr in (("ans0 encode step", pay), ("l1 LZX step", pk)):
        jax.block_until_ready(arr)
        log(f"mesh: {name} output shards on device ids "
            f"{[s.device.id for s in arr.addressable_shards]}")
    assert lz_sort.MAX_FLAT >= blk
    wires = {}
    for n, m in meshes.items():
        for level, fn in ((1, engine.mesh_l1_compress),
                          (5, engine.mesh_l5_compress)):
            t0 = time.perf_counter()
            wire = fn(m, data)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = engine.mesh_decompress(m, wire)
            t_dec = time.perf_counter() - t0
            assert out == raw, f"mesh({n}) level {level} round trip differs"
            wires[n, level] = wire
            log(f"mesh: make_mesh({n}) level {level}: {size} -> {len(wire)} "
                f"B, mesh_decompress byte-exact; compress {t_enc:.2f} s, "
                f"decompress {t_dec:.2f} s (first run includes compilation) "
                f"on {card}")
    for level in (1, 5):
        assert wires[4, level] == wires[1, level], \
            f"level {level}: make_mesh(4) wire != make_mesh(1) wire"
        log(f"mesh: level {level} make_mesh(4) wire == make_mesh(1) wire")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh phase over 4 cards")
    ap.add_argument("--mib", type=float, default=None,
                    help="data size in MiB (default: 211,957,760 bytes on "
                         "one card, 64 MiB for the mesh phase)")
    ap.add_argument("--seed", type=int, default=42)
    a = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    devs, card = phase_env(a.cards)
    if a.cards == 4:
        size = int(a.mib * (1 << 20)) if a.mib else 64 << 20
        phase_mesh(card, size, a.seed)
    else:
        size = int(a.mib * (1 << 20)) if a.mib else SILESIA_BYTES
        phase_kernels(card, a.seed)
        phase_main(devs[0], card, size, a.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
