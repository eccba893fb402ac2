"""ctypes bindings to the native NIfTI runtime (``runtime/niftiio.cpp``).

Counterpart of ``multimodal_registration_tpu/utils/native.py``: the native
NIfTI decode (:func:`load_nifti_native`), the gzip writer
(:func:`write_gz_native`) and the threaded prefetch pool of the batch
pipeline (:class:`PrefetchPool`). The library is host code, built with
``g++`` at first use (never at import) into ``build/runtime/`` at the root
of the checkout, which ``.gitignore`` lists; its file name carries a hash of
the source and the flags, so an edited source is rebuilt.

:func:`build_lib` raises when the library does not build; :func:`get_lib`
returns None instead, after one line on stderr, and its callers fall back
to the Python reader and writer of :mod:`utils.nifti`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "runtime" / "niftiio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "runtime"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_lib = None
_lib_error = None  # why the library is unavailable, once a build failed
_lib_lock = threading.Lock()


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libmmreg_runtime-{digest.hexdigest()[:16]}.so"


def build_lib() -> Path:
    """Compile the library unless it is built; return its path. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not run {cmd[0]} for {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "mmreg_load_nifti": (ctypes.c_int, [ctypes.c_char_p, f32p, ctypes.c_int64, i32p, f32p]),
        "mmreg_nifti_dims": (ctypes.c_int, [ctypes.c_char_p, i32p]),
        "mmreg_write_file_gz": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p,
                                               ctypes.c_int64, ctypes.c_int]),
        "mmreg_prefetch_create": (ctypes.c_void_p, [ctypes.c_int]),
        "mmreg_prefetch_submit": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_char_p]),
        "mmreg_prefetch_wait": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, f32p,
                                               ctypes.c_int64, i32p, f32p]),
        "mmreg_prefetch_destroy": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib():
    """The loaded library (built at first call), or None when it does not
    build here; the first failure prints one line to stderr."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is None and _lib_error is None:
            try:
                _lib = _bind(build_lib())
            except (RuntimeError, OSError) as e:
                _lib_error = str(e)
                first = (_lib_error.strip().splitlines() or ["?"])[0]
                print(f"multimodal_registration_torch: native NIfTI runtime unavailable, "
                      f"using the Python reader and writer ({first})", file=sys.stderr)
        return _lib


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native NIfTI runtime not available: {_lib_error}")
    return lib


def _alloc_for(path: str, lib):
    dims = (ctypes.c_int32 * 8)()
    nd = lib.mmreg_nifti_dims(path.encode(), dims)
    if nd < 1:
        raise IOError(f"native nifti dims failed ({nd}) for {path}")
    shape = tuple(int(dims[i + 1]) for i in range(nd))
    n = int(np.prod(shape))
    return np.empty(n, np.float32), shape, n


def _finish(out, shape, affine_buf):
    # NIfTI data is Fortran-ordered on disk
    data = out.reshape(shape, order="F")
    affine = np.frombuffer(affine_buf, np.float32).reshape(4, 4).astype(np.float64)
    return np.ascontiguousarray(data), affine


def load_nifti_native(path: str):
    """``(data as float32 with scl_slope/scl_inter applied, affine)`` through
    the native reader; raises ``IOError`` when the file does not decode."""
    lib = _require_lib()
    out, shape, n = _alloc_for(path, lib)
    dims = (ctypes.c_int32 * 8)()
    aff = (ctypes.c_float * 16)()
    rc = lib.mmreg_load_nifti(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, dims, aff)
    if rc < 0:
        raise IOError(f"native nifti load failed ({rc}) for {path}")
    return _finish(out, shape, aff)


def write_gz_native(path: str, payload: bytes, level: int | None = None) -> bool:
    """Deflate ``payload`` to ``path`` as one gzip member at ``level``
    (default ``MMREG_GZ_LEVEL`` or 1, nibabel's default); False when the
    library is unavailable, ``IOError`` when the write fails."""
    lib = get_lib()
    if lib is None:
        return False
    if level is None:
        level = int(os.environ.get("MMREG_GZ_LEVEL", 1))
    rc = lib.mmreg_write_file_gz(path.encode(), payload, len(payload), level)
    if rc != 0:
        raise IOError(f"native gzip write failed ({rc}) for {path}")
    return True


class PrefetchPool:
    """Threaded NIfTI prefetcher on the C++ pool: :meth:`submit` a path, get
    a ticket; :meth:`wait` on it for ``(data float32, affine)``."""

    def __init__(self, n_threads: int = 4):
        self._lib = _require_lib()
        self._pool = self._lib.mmreg_prefetch_create(n_threads)
        self._paths = {}

    def submit(self, path: str) -> int:
        t = self._lib.mmreg_prefetch_submit(self._pool, path.encode())
        self._paths[t] = path
        return t

    def wait(self, ticket: int):
        path = self._paths.pop(ticket)
        dims = (ctypes.c_int32 * 8)()
        aff = (ctypes.c_float * 16)()
        try:
            out, shape, n = _alloc_for(path, self._lib)
        except IOError:
            # the worker failed on this file too: collect its result so that
            # the pool's done-map does not keep it, then raise
            self._lib.mmreg_prefetch_wait(self._pool, ticket, None, 0, None, None)
            raise
        rc = self._lib.mmreg_prefetch_wait(
            self._pool, ticket, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, dims, aff)
        if rc < 0:
            raise IOError(f"native prefetch failed ({rc}) for {path}")
        return _finish(out, shape, aff)

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.mmreg_prefetch_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()
