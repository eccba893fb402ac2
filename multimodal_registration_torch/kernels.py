"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. Building
happens at first use, never at import (the CPU tests import every module),
into ``build/kernels/`` at the root of the checkout, which ``.gitignore``
lists. A library's file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused. :func:`build`
starts one ``nvcc`` per source, all at once.

Every kernel is a :class:`Kernel`. Its ``launches`` counter goes up by one
where the kernel is launched and nowhere else, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
BUILD_LOG: dict[str, dict] = {}  # source -> {"seconds", "log", "path"}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of multimodal_registration_torch "
            "are compiled at first use and need the CUDA toolkit"
        )
    return nvcc


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=None) -> dict:
    """Compile ``sources`` (default: every ``csrc/*.cu``) that are not built
    yet, one ``nvcc`` process per source, all started together. Returns
    ``BUILD_LOG``; raises with the compiler's output if any build fails."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            BUILD_LOG.setdefault(src, {"seconds": 0.0, "log": "cached", "path": str(out)})
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
        BUILD_LOG[src] = {"seconds": seconds, "log": log, "path": str(out)}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return BUILD_LOG


def _library(source: str) -> ctypes.CDLL:
    with _LIB_LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = _lib_path(source)
            if not path.exists():
                build([source])
            lib = ctypes.CDLL(str(path))
            lib.mmreg_error_string.argtypes = [_I]
            lib.mmreg_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
        return lib


class Kernel:
    """One hand-written kernel: its source, its C launcher and its count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        """Call the C launcher (which enqueues on the given stream and returns
        ``cudaGetLastError()``); raise if the launch was refused."""
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = _library(self.source).mmreg_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({rc}: {msg})")
        self.launches += 1


CONV3_LRELU_POOL = Kernel(
    "conv3_lrelu_pool", "conv_pool.cu", "conv3_lrelu_pool_launch",
    # x, w, bias, out, B, X, Y, Z, Cin, Cout, slope, is_bf16, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "multimodal_registration_tpu/ops/pallas/conv_pool.py:110",
)
WARP_TRILINEAR = Kernel(
    "warp_trilinear", "warp.cu", "warp_launch",
    # vol, coords, out, B, X, Y, Z, C, N, Yo, Zo, coords_are_flow, nearest,
    # is_bf16, stream
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:369",
)
WARP_UP2X = Kernel(
    "warp_up2x", "warp.cu", "warp_up2x_launch",
    # vol, flow_half, out, B, X, Y, Z, C, is_bf16, stream
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:493",
)
MAX_POOL_2X_BWD = Kernel(
    "max_pool_2x_bwd", "pool_bwd.cu", "pool_bwd_launch",
    # x, g, out, B, X, Y, Z, C, first, is_bf16, stream
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/pallas/pool_bwd.py:102",
)
WARP_TRILINEAR_BWD = Kernel(
    "warp_trilinear_bwd", "warp_bwd.cu", "warp_bwd_launch",
    # vol, coords, gout, gvol (f32 or null), gcoords (or null), B, X, Y, Z, C,
    # N, Yo, Zo, coords_are_flow, nearest, is_bf16, stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:369",
)
WARP_LABELS = Kernel(
    "warp_labels_soft_hard", "warp_labels.cu", "warp_labels_launch",
    # labels, flow, soft, hard, B, X, Y, Z, L, labels_are_u8, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:570",
)
WARP_LABELS_BWD = Kernel(
    "warp_labels_bwd", "warp_labels.cu", "warp_labels_bwd_launch",
    # g, labels, flow, gflow, B, X, Y, Z, L, labels_are_u8, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:601",
)
KERNELS = (CONV3_LRELU_POOL, WARP_TRILINEAR, WARP_UP2X, MAX_POOL_2X_BWD,
           WARP_TRILINEAR_BWD, WARP_LABELS, WARP_LABELS_BWD)


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
