"""Building and loading the native (C++) runtime library, the port's own copy
of ``flash_attention_dlrs_tpu/runtime/_native.py``.

One ``libfa_tpu_native.so`` holds every native runtime component (the page
allocator, the token loader).  It is built from the repository's
``native/src/*.cc`` by ``native/Makefile`` with ``BUILD=`` pointed at a
directory private to this process under ``_build/native/`` beside the
package, then moved (``os.replace``) to a name keyed by a hash of the
sources and the Makefile, as ``_cuda.py`` names the kernels' libraries: an
edited source rebuilds on its next use, and processes that build at once
each write their own directory and the last move wins.  ``native/build/``,
where the JAX package builds the same library, is never written.  Nothing
is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from .._cuda import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
NATIVE_BUILD_DIR = BUILD_DIR / "native"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _inputs():
    return sorted((NATIVE_DIR / "src").glob("*.cc")) + [NATIVE_DIR / "Makefile"]


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256()
    for path in _inputs():
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return NATIVE_BUILD_DIR / f"libfa_tpu_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library if its hashed file is missing; return its path.
    Raises ``RuntimeError`` with make's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    if not NATIVE_DIR.is_dir():
        raise RuntimeError(f"native sources not found at {NATIVE_DIR}")
    NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    private = NATIVE_BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        proc = subprocess.run(
            ["make", "-s", "-B", f"BUILD={private}"], cwd=NATIVE_DIR,
            capture_output=True, text=True, timeout=300)
        built = private / "libfa_tpu_native.so"
        if proc.returncode or not built.exists():
            raise RuntimeError(
                f"building the native library failed (make in {NATIVE_DIR}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(built, out)
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"building the native library failed: {err}") from err
    finally:
        shutil.rmtree(private, ignore_errors=True)
    return out


def load_lib() -> ctypes.CDLL:
    """Build (once, if missing) and dlopen the library; raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path = build()
            try:
                _lib = ctypes.CDLL(str(path))
            except OSError as err:
                raise RuntimeError(f"loading {path} failed: {err}") from err
    return _lib
