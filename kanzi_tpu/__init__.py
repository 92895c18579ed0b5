"""kanzi_tpu: lossless block compressor speaking the kanzi bitstream (v7),
with optional JAX device stages."""

import os as _os
import sys as _sys

# Persistent XLA compilation cache: device stages pay their compile cost once
# per shape bucket per machine, not once per process.  JAX_COMPILATION_CACHE_DIR
# wins when set; otherwise the cache is <checkout>/.jax_cache.  jax reads these
# variables when it is imported, so a jax imported before this package gets
# the same settings through its config.
_CACHE_SETTINGS = {
    "jax_compilation_cache_dir": _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"),
    "jax_persistent_cache_min_compile_time_secs": 1.0,
    "jax_persistent_cache_min_entry_size_bytes": 0,
}
for _name, _value in _CACHE_SETTINGS.items():
    if _name.upper() not in _os.environ:
        _os.environ[_name.upper()] = str(_value)
        if "jax" in _sys.modules:
            _sys.modules["jax"].config.update(_name, _value)
