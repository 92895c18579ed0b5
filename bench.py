"""Benchmark driver — prints ONE JSON line with the headline metric.

Headline: the level-1 block pipeline (LZX transform + NONE entropy + block
payload assembly — BlockCompressor.java:539 row 1) over a frozen 64 MiB
MIXED corpus (kanzi_tpu.utils.corpus: text/xml/exe/dna/numeric/random),
measured end-to-end on the host path.  vs_baseline compares against the
reference's own end-to-end silesia -l1 encode rate (0.416 GB/s on a
16-core Ryzen 9950X, BASELINE.md).

Secondaries on stderr:
  * RATIO + SPEED SCOREBOARD — per level 1..9, compressed size, ENCODE
    and DECODE GB/s (best-of-N) on the frozen synthetic corpus, host
    path + device gates (device size must be <= host)
  * the same scoreboard on the REAL-FILE corpus (utils/corpus.real_corpus)
  * device rows (an NVIDIA GPU is required; without one they fail): the
    level-1 LZX analyze, the level-5 suffix array against the host SA-IS,
    and the level-5 round trip with the CUDA rANS kernel against the XLA
    scan — each with the card's name and power limit beside it

    python bench.py            # everything
    python bench.py --device   # the device rows only
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import numpy as np


BASELINE = {1: 0.416, 3: 0.237, 5: 0.123, 8: 0.036, 9: 0.014}
# silesia e2e enc GB/s, BASELINE.md
# full per-level reference silesia ENCODE rates (GB/s, BASELINE.md)
BASELINE_ENC = {1: 0.416, 2: 0.302, 3: 0.237, 4: 0.165, 5: 0.123,
                6: 0.111, 7: 0.126, 8: 0.036, 9: 0.014}
REF_CORES = 16          # the reference numbers come from a 16-core 9950X
# reference silesia DECODE rates (GB/s) from BASELINE.md enc/dec ms pairs
BASELINE_DEC = {1: 1.158, 2: 0.669, 3: 0.451, 4: 0.285, 5: 0.282,
                6: 0.269, 7: 0.203, 8: 0.035, 9: 0.014}
# reference silesia compression ratios per level.  NOTE: a DIFFERENT
# dataset from both bench corpora — trend context only, NOT a comparable
# target (silesia.tar = 211,957,760 B, README.md:69-94)
SILESIA_RATIO = {1: 0.374, 2: 0.324, 3: 0.302, 4: 0.289, 5: 0.254,
                 6: 0.233, 7: 0.223, 8: 0.203, 9: 0.196}
CORPUS_MB = 64          # the l1 end-to-end loops
SCORE_MB = 16           # scoreboards
BLOCK = 4 << 20


def _corpus(size: int, seed: int = 0) -> np.ndarray:
    from kanzi_tpu.utils.corpus import mixed_corpus
    return mixed_corpus(size, seed=seed) if seed else mixed_corpus(size)


def device_info() -> dict:
    """The device every device row names; fails unless it is a GPU."""
    import subprocess

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"device rows need a GPU, found {dev.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": smi.strip().splitlines()[0]}


def _best(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_l1_device(data: np.ndarray) -> dict:
    """Level-1 LZX on the device: the batched analyze alone (blocks
    already on the device, FLAT_GROUP whole blocks per dispatch) and the
    full per-block path incl. the host emit, against the host C++ LZX."""
    import jax
    import jax.numpy as jnp

    from kanzi_tpu.ops import lz_sort as L
    from kanzi_tpu.utils import native_transforms as nt

    blocks = [data[i:i + BLOCK] for i in range(0, data.size, BLOCK)]
    G = L.FLAT_GROUP
    bucket = L._flat_bucket(BLOCK)
    groups = []
    for g0 in range(0, len(blocks) - len(blocks) % G, G):
        grp = blocks[g0:g0 + G]
        bufs = np.zeros((G, bucket), np.uint8)
        send = np.full(G, -18, np.int32)
        mdist = np.zeros(G, np.int32)
        for j, b in enumerate(grp):
            bufs[j, :b.size] = b
            send[j] = b.size - 18
            mdist[j] = L._block_max_dist(b.size)
        groups.append((jnp.asarray(bufs), jnp.asarray(send),
                       jnp.asarray(mdist)))
    fn = L._analyze_flat_jit(4)
    t_an = _best(lambda: jax.block_until_ready([fn(*g) for g in groups]))
    t_dev = _best(lambda: L.lzx_forward_device_batch(blocks))
    t_host = _best(lambda: [nt.lzx_forward_native(b, False, 0)
                            for b in blocks])
    n = len(groups) * G * BLOCK
    return {"analyze_gbps": n / t_an / 1e9,
            "device_path_gbps": data.size / t_dev / 1e9,
            "host_lzx_one_thread_gbps": data.size / t_host / 1e9}


def bench_sa_device(data: np.ndarray) -> dict:
    """Level-5 suffix array of one 4 MiB block: the device prefix doubling
    (ops/bwt_tpu) against the host C++ SA-IS on one thread."""
    from kanzi_tpu.ops.bwt_tpu import suffix_array_device
    from kanzi_tpu.transforms.bwt import suffix_array

    blk = data[:BLOCK]
    assert np.array_equal(suffix_array_device(blk), suffix_array(blk))
    return {"device_s": _best(lambda: suffix_array_device(blk)),
            "host_sais_s": _best(lambda: suffix_array(blk))}


def bench_l5_ans_routes(data: np.ndarray) -> dict:
    """Level-5 round trip with the device gates on, the rANS scan as the
    CUDA kernel against the XLA scan (same process, same card)."""
    import os

    import kanzi_tpu.ops.ans_block as AB
    from kanzi_tpu.ops import ans as xla
    from kanzi_tpu.ops.route import Ans0Kernels, ans0_kernels

    raw = data.tobytes()
    routes = {"cuda": ans0_kernels,
              "xla": lambda: Ans0Kernels(xla.ans0_encode_chunks,
                                         xla.ans0_decode_chunks, "xla")}
    gates = ("KANZI_TPU_DEVICE_BWT", "KANZI_TPU_DEVICE_ANS")
    out = {}
    old = AB.ans0_kernels
    os.environ.update({g: "1" for g in gates})
    try:
        for name in ("cuda", "xla", "xla", "cuda"):   # in turns
            AB.ans0_kernels = routes[name]
            t_enc = _best(lambda: _l5(raw, "enc"), reps=1)
            wire = _l5(raw, "enc")
            t_dec = _best(lambda: _l5(wire, "dec"), reps=1)
            assert _l5(wire, "dec") == raw
            out.setdefault(name, []).append((t_enc, t_dec))
    finally:
        AB.ans0_kernels = old
        for g in gates:
            os.environ.pop(g, None)
    return {k: {"enc_s": min(v[0] for v in r), "dec_s": min(v[1] for v in r)}
            for k, r in out.items()}


def _l5(buf: bytes, op: str) -> bytes:
    from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
    from kanzi_tpu.io.stream import CompressedInputStream
    t, e, b = LEVELS[5]
    jobs = min(os.cpu_count() or 1, 64)
    if op == "enc":
        return BlockCompressor(transform=t, entropy=e, block_size=b,
                               jobs=jobs).compress_bytes(buf)
    return CompressedInputStream(io.BytesIO(buf), {"jobs": jobs}).read(-1)


def device_rows(err) -> dict:
    info = device_info()
    card = info["card"]
    data = _corpus(CORPUS_MB << 20)
    l1 = bench_l1_device(data)
    print(f"device: l1 LZX analyze {l1['analyze_gbps']:.4f} GB/s, device "
          f"path incl. host emit {l1['device_path_gbps']:.4f} GB/s, host "
          f"C++ LZX one thread {l1['host_lzx_one_thread_gbps']:.4f} GB/s "
          f"({CORPUS_MB} MiB) on {card}", file=err)
    sa = bench_sa_device(data)
    print(f"device: l5 suffix array of a 4 MiB block {sa['device_s']:.4f} s "
          f"on the device vs {sa['host_sais_s']:.4f} s host SA-IS on {card}",
          file=err)
    l5 = bench_l5_ans_routes(data)
    for k, v in l5.items():
        print(f"device: l5 round trip, gates on, rANS {k}: compress "
              f"{v['enc_s']:.3f} s, decompress {v['dec_s']:.3f} s "
              f"({CORPUS_MB} MiB) on {card}", file=err)
    return {"device": info, "l1": l1, "sa": sa, "l5_ans_routes": l5}


def bench_cpu_level(data: np.ndarray, level: int, jobs: int = 0,
                    iters: int = 2) -> tuple[float, float, float]:
    """Host path for one level: returns (enc GB/s, dec GB/s, ratio)."""
    import os

    from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
    from kanzi_tpu.io.stream import CompressedInputStream
    t, e, b = LEVELS[level]
    jobs = jobs or (os.cpu_count() or 2)
    bc = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=jobs)
    raw = data.tobytes()
    blob = bc.compress_bytes(raw)  # warmup
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        blob = bc.compress_bytes(raw)
        best = min(best, time.perf_counter() - t0)
    best_d = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = CompressedInputStream(io.BytesIO(blob),
                                    {"jobs": jobs}).read(-1)
        best_d = min(best_d, time.perf_counter() - t0)
    assert out == raw, f"level {level} round-trip mismatch"
    return (data.size / best / 1e9, data.size / best_d / 1e9,
            len(blob) / data.size)


def scoreboard(data: np.ndarray, err, tag: str, device_gates: bool) -> dict:
    """Per level 1..9: compressed size + encode/decode GB/s, host path vs
    device gates (a device engine must never produce a larger stream than
    the host path it replaces).  Measurement rules: best-of-N timing per
    cell; levels whose block size exceeds
    the slice get enough data for TWO blocks so both jobs stay busy (the
    reference's numbers come from 13+ blocks over 16 cores); l8/l9 run a
    4 MiB slice (TPAQ/TPAQX are ~15 MB/s-class by design).
    Device gates: LZ/LZX sort engine (l1), device SA + ANS0 (l5)."""
    import os

    from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
    from kanzi_tpu.io.stream import CompressedInputStream

    board = {}
    for level in range(1, 10):
        t, e, b = LEVELS[level]
        if level >= 8:
            d = data[:4 << 20]
            iters_e, iters_d = 1, 1     # TPAQ at ~4 MiB: one timed pass
            jobs = 1                    # one block => one active core; a
            #                             2-job pool would halve the
            #                             per-core normalization unfairly
        else:
            # at least two blocks so both jobs stay busy (l7's 16 MiB
            # block would otherwise serialize on a 16 MiB slice)
            want = max(SCORE_MB << 20, 2 * b)
            d = data[:min(want, data.size)]
            iters_e, iters_d = 2, 3
            jobs = 2
        raw = d.tobytes()
        bc = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=jobs)
        t_host = float("inf")
        for _ in range(iters_e):
            t0 = time.perf_counter()
            blob = bc.compress_bytes(raw)
            t_host = min(t_host, time.perf_counter() - t0)
        host = len(blob)
        t_dec = float("inf")
        for _ in range(iters_d):
            t0 = time.perf_counter()
            out = CompressedInputStream(io.BytesIO(blob),
                                        {"jobs": jobs}).read(-1)
            t_dec = min(t_dec, time.perf_counter() - t0)
        assert out == raw, f"{tag} l{level} round-trip mismatch"
        dev = None
        gates = {1: {"KANZI_TPU_DEVICE_LZ": "1"},
                 5: {"KANZI_TPU_DEVICE_BWT": "1", "KANZI_TPU_DEVICE_ANS": "1"}}
        if device_gates and level in gates:
            env = gates[level]
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                dev = len(bc.compress_bytes(raw))
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        enc_g = d.size / t_host / 1e9
        dec_g = d.size / t_dec / 1e9
        board[level] = {"host": host, "device": dev,
                        "slice_mb": d.size >> 20, "jobs": jobs,
                        "ratio": round(host / d.size, 4),
                        "host_gbps": round(enc_g, 4),
                        "host_dec_gbps": round(dec_g, 4)}
        flag = ""
        if dev is not None:
            flag = " DEVICE>HOST!" if dev > host else " ok"
        print(f"{tag} l{level}: host {host} ratio {host/d.size:.4f}"
              + (f" device {dev}{flag}" if dev is not None else "")
              + f" (enc {enc_g:.3f} / dec {dec_g:.3f} GB/s host, "
              + f"{d.size >> 20} MiB best-of-{iters_e}/{iters_d})",
              file=err)
    return board


def box_calibration(data: np.ndarray, err) -> dict:
    """Single-core speed of THIS box vs the reference's 9950X, measured
    with bzip2 -9 (always single-threaded, BWT+Huffman — the same workload
    family as levels 5-7).  BASELINE.md pins bzip2 -9 on silesia on the
    reference box at 8223 ms enc / 3453 ms dec for 211,957,760 bytes
    (reference README.md:69-94): 0.0258 enc / 0.0614 dec GB/s.  The factor
    carries a data-mix caveat (silesia vs this corpus) but anchors the
    \"x ref/core\" proxy columns to a measured core-speed ratio instead of
    assuming equal cores.
    """
    import shutil
    import subprocess
    import tempfile
    if shutil.which("bzip2") is None:
        return {}
    REF_ENC, REF_DEC = 0.02578, 0.06139  # GB/s, 9950X on silesia
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "c.bin")
        bz = os.path.join(td, "c.bz2")
        blob = data[: 16 << 20].tobytes()
        with open(raw, "wb") as f:
            f.write(blob)
        enc_t = dec_t = 1e9
        for _ in range(2):
            t0 = time.perf_counter()
            with open(raw, "rb") as fi, open(bz, "wb") as fo:
                subprocess.run(["bzip2", "-9", "-c"], stdin=fi, stdout=fo,
                               check=True)
            enc_t = min(enc_t, time.perf_counter() - t0)
            t0 = time.perf_counter()
            with open(bz, "rb") as fi:
                subprocess.run(["bzip2", "-d", "-c"], stdin=fi,
                               stdout=subprocess.DEVNULL, check=True)
            dec_t = min(dec_t, time.perf_counter() - t0)
    enc_g = len(blob) / enc_t / 1e9
    dec_g = len(blob) / dec_t / 1e9
    out = {"bzip2_box_enc_gbps": round(enc_g, 4),
           "bzip2_box_dec_gbps": round(dec_g, 4),
           "core_speed_vs_ref_enc": round(enc_g / REF_ENC, 3),
           "core_speed_vs_ref_dec": round(dec_g / REF_DEC, 3)}
    print(f"calibration: bzip2 -9 single-core on this box "
          f"{enc_g:.4f} enc / {dec_g:.4f} dec GB/s vs the reference "
          f"9950X's {REF_ENC:.4f}/{REF_DEC:.4f} on silesia -> this core "
          f"runs the BWT workload family at {enc_g / REF_ENC:.2f}x enc / "
          f"{dec_g / REF_DEC:.2f}x dec of a reference core "
          f"(x-ref/core proxies divide by this to compare like-for-like)",
          file=err)
    return out


def main() -> None:
    err = sys.stderr
    if "--device" in sys.argv[1:]:
        print(json.dumps({"metric": "device_rows", **device_rows(err)}))
        return
    data = _corpus(CORPUS_MB << 20)
    host, host_dec, ratio_h = bench_cpu_level(data[:32 << 20], 1)
    print(f"secondary: l1 cpu e2e enc {host:.3f} / dec {host_dec:.3f} "
          f"GB/s ratio {ratio_h:.3f} (ref e2e {BASELINE[1]} enc / "
          f"{BASELINE_DEC[1]} dec GB/s)", file=err)
    dev = device_rows(err)
    # 32 MiB so the l7 row gets two 16 MiB blocks (both jobs busy)
    board = scoreboard(_corpus(32 << 20, seed=0), err, "scoreboard",
                       device_gates=True)
    # the REAL-FILE corpus (silesia-style, frozen by SHA)
    from kanzi_tpu.utils.corpus import real_corpus
    rdata, real_sha, breakdown = real_corpus(64 << 20)
    print(f"real corpus sha256 {real_sha[:16]}.. sections {breakdown}",
          file=err)
    real_board = scoreboard(rdata[:32 << 20], err, "real",
                            device_gates=False)
    for lv, tgt in SILESIA_RATIO.items():
        if lv in real_board:
            real_board[lv]["silesia_ratio_other_dataset"] = tgt
    calib = box_calibration(data, err)
    # annotate scoreboard rows with per-core parity, raw AND calibrated
    # (raw divides by the reference's per-core rate as if cores were
    # equal; calibrated divides that by the measured bzip2 core factor)
    for b in (board, real_board):
        for lv, row in b.items():
            jobs = row.get("jobs", 1) or 1
            row["x_ref_core_enc"] = round(
                row["host_gbps"] / jobs / (BASELINE_ENC[lv] / REF_CORES), 3)
            row["x_ref_core_dec"] = round(
                row["host_dec_gbps"] / jobs / (BASELINE_DEC[lv] / REF_CORES),
                3)
            if calib:
                row["x_ref_core_enc_calibrated"] = round(
                    row["x_ref_core_enc"] / calib["core_speed_vs_ref_enc"], 2)
                row["x_ref_core_dec_calibrated"] = round(
                    row["x_ref_core_dec"] / calib["core_speed_vs_ref_dec"], 2)
    dev_le_host = all(v["device"] is None or v["device"] <= v["host"]
                      for v in board.values())
    print(json.dumps({
        "metric": "l1_encode_e2e",
        "value": round(host, 4), "unit": "GB/s",
        "vs_baseline": round(host / BASELINE[1], 3),
        "ratio": round(ratio_h, 4),
        "host_cpu_dec_gbps": round(host_dec, 4),
        "device_rows": dev,
        "ratio_scoreboard": {f"l{k}": v for k, v in board.items()},
        "real_corpus": {"sha256": real_sha,
                        "levels": {f"l{k}": v
                                   for k, v in real_board.items()}},
        "device_ratio_le_host": dev_le_host,
        "box_calibration": calib}))


if __name__ == "__main__":
    main()
