"""Loader for the native libraries built from the sources under ``native/``.

The C++ runtime (``libkanzi_native``) is compiled on first use with
``g++ -O3 -march=native``; its entry points are optional, and every caller
has a pure-Python/NumPy fallback (``KANZI_TPU_NO_NATIVE=1`` selects it).  A
failed build prints the compiler's messages before falling back.

The CUDA library (``libkanzi_cuda``, the rANS lane scan for Hopper) is
compiled with ``nvcc`` on first use on a GPU host; there it is required, so
a failed build raises.

Both land in the git-ignored ``native/_build``.  Each file name carries a
key hashed from the compiler command, the sources and the machine it is
built for, so a library built elsewhere or from older sources is never
loaded.  A file lock lets concurrent processes share one build.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import sys
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE = os.path.join(_ROOT, "native")
_SRCS = [os.path.join(_NATIVE, f)
         for f in ("kanzi_native.cpp", "coders.cpp", "transforms.cpp", "lz.cpp",
                   "bwt.cpp", "text.cpp", "exe.cpp", "rolz.cpp", "ans.cpp",
                   "huffman.cpp")]
_BUILD_DIR = os.path.join(_NATIVE, "_build")
_CXX = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread"]
_CUDA_SRC = os.path.join(_NATIVE, "ans_cuda.cu")
_NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.processor() or platform.machine()


def _key(cmd: list[str], srcs: list[str], machine: str) -> str:
    h = hashlib.sha256("\0".join(cmd + [machine]).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_key() -> str:
    """Key of the C++ library for these sources on this machine."""
    return _key(_CXX, _SRCS, _cpu_model())


_SO = os.path.join(_BUILD_DIR, f"libkanzi_native-{build_key()}.so")


@contextlib.contextmanager
def _build_lock():
    import fcntl
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(cmd: list[str], out: str) -> subprocess.CompletedProcess:
    """Run ``cmd + ['-o', tmp]`` and move the result to ``out``."""
    with _build_lock():
        if os.path.exists(out):
            return subprocess.CompletedProcess(cmd, 0, "", "")
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True,
                             timeout=600)
        if res.returncode == 0:
            os.replace(tmp, out)
        return res


def _build() -> str | None:
    try:
        res = _compile(_CXX + _SRCS, _SO)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"kanzi_tpu: native build failed: {e}", file=sys.stderr)
        return None
    if res.returncode != 0:
        print(f"kanzi_tpu: native build failed ({' '.join(res.args)}):\n"
              f"{res.stderr}", file=sys.stderr)
        return None
    return _SO


def get_lib():
    """Return the loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        if os.environ.get("KANZI_TPU_NO_NATIVE"):
            _TRIED = True
            return None
        so = _build()
        if so is None:
            _TRIED = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            print(f"kanzi_tpu: cannot load {so}: {e}", file=sys.stderr)
            _TRIED = True
            return None
        c = ctypes
        u8p = c.POINTER(c.c_uint8)
        lib.kz_xxhash32.restype = c.c_uint32
        lib.kz_xxhash32.argtypes = [c.c_char_p, c.c_int64, c.c_uint32]
        lib.kz_xxhash64.restype = c.c_uint64
        lib.kz_xxhash64.argtypes = [c.c_char_p, c.c_int64, c.c_uint64]
        if hasattr(lib, "kz_cm_encode"):
            for fn in (lib.kz_cm_encode, lib.kz_fpaq_encode):
                fn.restype = c.c_int64
                fn.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
            for fn in (lib.kz_cm_decode, lib.kz_fpaq_decode):
                fn.restype = c.c_int64
                fn.argtypes = [u8p, c.c_int64, u8p, c.c_int64, c.POINTER(c.c_int64)]
            lib.kz_tpaq_encode.restype = c.c_int64
            lib.kz_tpaq_encode.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                           c.c_int32, c.c_int64, c.c_int64]
            lib.kz_tpaq_decode.restype = c.c_int64
            lib.kz_tpaq_decode.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                           c.POINTER(c.c_int64), c.c_int32,
                                           c.c_int64, c.c_int64]
            lib.kz_tpaq_set_tables.restype = None
            lib.kz_tpaq_set_tables.argtypes = [u8p, u8p, c.POINTER(c.c_int32),
                                               c.POINTER(c.c_int32)]
            # push the TPAQ wire tables (single source of truth in Python)
            import numpy as np
            from ..models._tpaq_tables import MATCH_PRED, STATE_MAP, STATE_TRANSITIONS
            t0 = np.ascontiguousarray(STATE_TRANSITIONS[0], dtype=np.uint8)
            t1 = np.ascontiguousarray(STATE_TRANSITIONS[1], dtype=np.uint8)
            sm = np.ascontiguousarray(STATE_MAP, dtype=np.int32)
            mp = np.ascontiguousarray(MATCH_PRED, dtype=np.int32)
            lib.kz_tpaq_set_tables(
                t0.ctypes.data_as(u8p), t1.ctypes.data_as(u8p),
                sm.ctypes.data_as(c.POINTER(c.c_int32)),
                mp.ctypes.data_as(c.POINTER(c.c_int32)))
        _LIB = lib
        return _LIB


def cuda_build_command() -> list[str]:
    """nvcc command (without ``-o``) for the Hopper rANS library."""
    import jax.ffi
    return [_NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), _CUDA_SRC]


def build_cuda(device_kind: str) -> str:
    """Path of the CUDA library for ``device_kind``, built if missing.
    Raises RuntimeError when nvcc is missing or the build fails."""
    cmd = cuda_build_command()
    so = os.path.join(_BUILD_DIR,
                      f"libkanzi_cuda-{_key(cmd, [_CUDA_SRC], device_kind)}.so")
    try:
        res = _compile(cmd, so)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"CUDA build failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"CUDA build failed ({' '.join(cmd)}):\n"
                           f"{res.stderr}")
    return so


def as_u8p(arr):
    """ctypes uint8 pointer for a contiguous numpy array."""
    import ctypes
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
