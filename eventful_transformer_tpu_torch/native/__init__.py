"""Host-side C++ helpers, bound through ctypes (port of
``eventful_transformer_tpu/native/__init__.py``).

A library is built with the system ``g++`` at its first use into the
package's ``_build/`` directory, named after a hash of its source so that an
edited source builds anew. Where no compiler is found, :func:`load` returns
None and the caller takes its numpy version, which gives the same results.
These run on the host, not on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_DIR = Path(__file__).parent
_BUILD = _DIR.parent / "_build"

_cache = {}


def _build(name):
    src = _DIR / f"{name}.cpp"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib = _BUILD / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    compiler = shutil.which("g++")
    if compiler is None:
        raise FileNotFoundError("g++")
    _BUILD.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent first uses never
    # load a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run(
        [compiler, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)],
        check=True, capture_output=True,
    )
    tmp.replace(lib)
    return lib


def load(name):
    """The ctypes library ``name`` (built if needed), or None when it cannot
    be built or loaded."""
    if name not in _cache:
        try:
            _cache[name] = ctypes.CDLL(str(_build(name)))
        except (OSError, subprocess.CalledProcessError):
            _cache[name] = None
    return _cache[name]
