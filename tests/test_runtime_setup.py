"""Process-level setup: the persistent compile cache and the native build."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(first: str, env_dir: str | None) -> str:
    """jax's compile-cache dir in a fresh process that imports ``first``
    (``jax`` or ``kanzi_tpu``) before the other."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    second = "kanzi_tpu" if first == "jax" else "jax"
    code = (f"import {first}, {second}, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          check=True, capture_output=True,
                          text=True).stdout.strip()


@pytest.mark.parametrize("first", ["jax", "kanzi_tpu"])
def test_compile_cache_defaults_to_checkout(first):
    assert _cache_dir(first, None) == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("first", ["jax", "kanzi_tpu"])
def test_compile_cache_env_wins(first, tmp_path):
    assert _cache_dir(first, str(tmp_path)) == str(tmp_path)


def test_native_build_failure_prints_compiler_output(monkeypatch, tmp_path,
                                                     capsys):
    from kanzi_tpu.utils import native
    monkeypatch.setattr(native, "_CXX", ["g++", "-fno-such-flag-kanzi"])
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib.so"))
    assert native._build() is None
    err = capsys.readouterr().err
    assert "native build failed" in err and "-fno-such-flag-kanzi" in err


def test_native_library_name_carries_build_key():
    from kanzi_tpu.utils import native
    key = native.build_key()
    assert len(key) == 16 and os.path.basename(native._SO) == \
        f"libkanzi_native-{key}.so"
    assert os.path.dirname(native._SO).endswith(os.path.join("native",
                                                             "_build"))
