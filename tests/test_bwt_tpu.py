"""Device suffix array (ops/bwt_tpu): exact agreement with the native
SA-IS on every data shape (the SA is unique, so this also pins the BWT
wire), and the KANZI_TPU_DEVICE_BWT gate produces identical blocks."""

import os

import numpy as np
import pytest

from kanzi_tpu.ops.bwt_tpu import suffix_array_device
from kanzi_tpu.transforms.bwt import BWT
from kanzi_tpu.utils import native_transforms as nt
from kanzi_tpu.utils.corpus import dna_like, mixed_corpus, text_like


def _native_sa(x):
    sa = np.zeros(x.size, np.int32)
    lib = nt._lib()
    if lib is None:
        pytest.skip("native library unavailable")
    lib.kz_suffix_array(nt.as_u8p(np.ascontiguousarray(x)),
                        nt._i32p(sa), x.size)
    return sa


@pytest.mark.parametrize("case", ["text", "zeros", "dna", "random",
                                  "periodic", "tiny"])
def test_device_sa_matches_native(case):
    rng = np.random.default_rng(3)
    data = {
        "text": text_like(80_000),
        "zeros": np.zeros(4096, np.uint8),
        "dna": dna_like(50_000),
        "random": rng.integers(0, 256, 65537).astype(np.uint8),
        "periodic": np.tile(np.frombuffer(b"abcab", np.uint8), 10_000),
        "tiny": np.frombuffer(b"banana", np.uint8),
    }[case]
    assert np.array_equal(suffix_array_device(data), _native_sa(data))


def test_device_bwt_gate_wire_exact(monkeypatch):
    monkeypatch.setenv("KANZI_TPU_DEVICE_BWT", "1")
    x = mixed_corpus(200_000)
    b1 = BWT()
    d1 = b1.forward(x.copy())
    monkeypatch.delenv("KANZI_TPU_DEVICE_BWT")
    b2 = BWT()
    d2 = b2.forward(x.copy())
    assert np.array_equal(d1, d2)
    assert b1.primary_indexes == b2.primary_indexes
    assert np.array_equal(b1.inverse(d1), x)
