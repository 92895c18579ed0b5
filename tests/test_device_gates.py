"""The KANZI_TPU_DEVICE_* gates through the stream writer and reader: a
gated level gives the same stream as the host path (level 5) or one no
larger (level 1), round-trips byte-exactly, and a failing device stage
raises instead of falling back quietly.  Runs the XLA versions on the CPU.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from kanzi_tpu.app.block_compressor import LEVELS, BlockCompressor
from kanzi_tpu.io.stream import CompressedInputStream
from kanzi_tpu.utils.corpus import mixed_corpus

GATES = {1: ("KANZI_TPU_DEVICE_LZ",),
         5: ("KANZI_TPU_DEVICE_BWT", "KANZI_TPU_DEVICE_ANS")}


def _compress(level: int, data: np.ndarray, block: int) -> bytes:
    t, e, _ = LEVELS[level]
    return BlockCompressor(transform=t, entropy=e, block_size=block,
                           jobs=2).compress_bytes(data.tobytes())


def _gated(monkeypatch, level: int, data, block):
    with monkeypatch.context() as m:
        for g in GATES[level]:
            m.setenv(g, "1")
        wire = _compress(level, data, block)
        out = CompressedInputStream(io.BytesIO(wire), {"jobs": 2}).read(-1)
    return wire, out


def test_gated_level5_matches_host(monkeypatch):
    data = mixed_corpus(600_000, seed=5)
    host = _compress(5, data, 256 << 10)
    wire, out = _gated(monkeypatch, 5, data, 256 << 10)
    assert out == data.tobytes()
    assert wire == host


def test_gated_level1_round_trip_no_larger(monkeypatch):
    data = mixed_corpus(1 << 20, seed=6)
    host = _compress(1, data, 512 << 10)
    wire, out = _gated(monkeypatch, 1, data, 512 << 10)
    assert out == data.tobytes()
    assert len(wire) <= len(host)


@pytest.mark.parametrize("level,target", [
    (1, "kanzi_tpu.ops.lz_sort.lzx_forward_device_batch"),
    (5, "kanzi_tpu.ops.ans_block.ans0_encode"),
])
def test_gated_stage_error_raises(monkeypatch, level, target):
    def broken(*a, **k):
        raise RuntimeError("device stage failed")

    monkeypatch.setattr(target, broken)
    data = mixed_corpus(300_000, seed=7)
    with pytest.raises(RuntimeError, match="device stage failed"):
        _gated(monkeypatch, level, data, 256 << 10)
