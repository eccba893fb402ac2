"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. Building
happens at first use, never at import (the CPU tests import every module),
into ``build/kernels/`` at the root of the checkout, which ``.gitignore``
lists. A library's file name carries a hash of its source, of the shared
headers (``csrc/*.cuh``) and of the flags, so an edited source is rebuilt and
an unchanged one is reused. :func:`build`
starts one ``nvcc`` per source, all at once.

Every kernel is a :class:`Kernel`. Its ``launches`` counter goes up by one
where the kernel is launched and nowhere else, so a run can show that its
main path went through the kernel. A kernel may have further C entries in
its source (another mode of the same function, or a pass that completes it):
:meth:`Kernel.launch_entry` calls them, counted on the same counter or not;
:func:`entry_launch_counts` tells the entries apart.
"""

from __future__ import annotations

import contextlib
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

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
_LOCAL = threading.local()  # .diverted: where this thread's counted launches go instead
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
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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
                 replaces: str, entries: dict | None = None):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0
        self.entry_launches: dict[str, int] = {}  # symbol -> its counted launches
        self._argtypes = {symbol: argtypes, **(entries or {})}
        self._fns = {}

    def _bind(self, symbol: str):
        """The C launcher ``symbol``, its argument conversion set up once."""
        fn = getattr(_library(self.source), symbol)
        fn.argtypes = self._argtypes[symbol]
        fn.restype = _I
        self._fns[symbol] = fn
        return fn

    def launch_entry(self, symbol: str, *args, count: bool = True) -> None:
        """Call the C launcher ``symbol`` (which enqueues on the given stream
        and returns ``cudaGetLastError()``); raise if the launch was refused."""
        fn = self._fns.get(symbol) or self._bind(symbol)
        rc = fn(*args)
        if rc != 0:
            msg = _library(self.source).mmreg_error_string(rc).decode()
            raise RuntimeError(f"{self.name} ({symbol}): CUDA launch failed ({rc}: {msg})")
        if count:
            diverted = getattr(_LOCAL, "diverted", None)
            if diverted is not None:
                diverted[self, symbol] = diverted.get((self, symbol), 0) + 1
            else:
                self.launches += 1
                self.entry_launches[symbol] = self.entry_launches.get(symbol, 0) + 1

    def launch(self, *args) -> None:
        """Launch the kernel's main entry."""
        self.launch_entry(self.symbol, *args)


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
    entries={
        # the fused squaring step: phi, out, B, X, Y, Z, payload_is_bf16, stream
        "self_warp_add_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
    },
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
    entries={
        # grad (bf16 or f32), scratch, n, is_bf16, stream: rounds the sums, zeroes them
        "warp_bwd_finish_launch": [_P, _P, _I, _I, _P],
        # the fused step's backward, kernel A: phi, g, out, scratch, B, X, Y, Z,
        # payload_is_bf16, stream
        "self_warp_add_bwd_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # kernel B: out, scratch, n, payload_is_bf16, stream
        "self_warp_add_finish_launch": [_P, _P, _I, _I, _P],
    },
)
WARP_LABELS = Kernel(
    "warp_labels_soft_hard", "warp_labels.cu", "warp_labels_launch",
    # labels, flow, soft, hard, B, X, Y, Z, L, labels_are_u8, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:570",
    entries={
        # the training loss's Dice sums without the soft map: labels, flow, t,
        # partial (scratch), sums, B, X, Y, Z, L, tile voxels, blocks, zeropad,
        # labels_are_u8, stream
        "warp_labels_dice_fwd_launch": [_P, _P, _P, _P, _P, *[_I] * 9, _P],
    },
)
WARP_LABELS_BWD = Kernel(
    "warp_labels_bwd", "warp_labels.cu", "warp_labels_bwd_launch",
    # g, labels, flow, gflow, B, X, Y, Z, L, labels_are_u8, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "multimodal_registration_tpu/ops/warp.py:601",
    entries={
        # the Dice loss's flow gradient, its cotangent formed in the kernel:
        # t, labels, flow, coef, gflow, B, X, Y, Z, L, zeropad, labels_are_u8, stream
        "warp_labels_dice_bwd_launch": [_P, _P, _P, _P, _P, *[_I] * 7, _P],
    },
)
CONV3_INT8 = Kernel(
    "conv3_int8", "conv_int8.cu", "conv3_int8_launch",
    # xq, wq, scale, bias, out, B, X, Y, Z, then ops/conv_int8.py::Int8ConvPlan.launch_args
    # (Cp, Cout, cout_pad, box x/y/z, boxes along x/y/z, n_tiles), mode, slope, stream
    [_P, _P, _P, _P, _P, *[_I] * 4, *[_I] * 10, _I, _F, _P],
    "multimodal_registration_tpu/models/unet.py:173",
    entries={
        # the quantize pass that precedes each conv: x, xq, M, Cin, Cp, inv, is_bf16, stream
        "quantize_act_launch": [_P, _P, _L, _I, _I, _F, _I, _P],
        # one wgmma m64n256k32 of the conv's layout (a test): a, b, out, kstep, stream
        "wgmma_tile_launch": [_P, _P, _P, _I, _P],
        # the conv kernel's registers, spills, static and dynamic shared memory, threads
        "conv3_int8_attributes": [_P],
    },
)
FLOW_HEAD = Kernel(
    "flow_head", "flow_head.cu", "flow_head_fwd_launch",
    # feat, w, bias, out, B, X, Y, Z, C, is_bf16, stream
    [_P, _P, _P, _P, *[_I] * 6, _P],
    "none: multimodal_registration_tpu/models/vxm_dense.py:116 is an XLA conv",
    entries={
        # the input gradient: g, w, dfeat, B, X, Y, Z, C, is_bf16, stream
        "flow_head_dgrad_launch": [_P, _P, _P, *[_I] * 6, _P],
        # the weight gradient's partial sums: feat, g, part, part_bias, B, X, Y,
        # Z, C, span, nblk, is_bf16, stream (ops/flow_head.py::wgrad_blocks)
        "flow_head_wgrad_launch": [_P, _P, _P, _P, *[_I] * 8, _P],
        # their sum in block order: part, part_bias, dw, db, C, nblk, is_bf16, stream
        "flow_head_wgrad_finish_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
)
UP_CAT = Kernel(
    "up_cat", "up_cat.cu", "up_cat_launch",
    # x, skip, out, B, X, Y, Z, x row bytes, skip row bytes, access bytes, stream
    [_P, _P, _P, *[_I] * 7, _P],
    "none: multimodal_registration_tpu/models/unet.py:272 is XLA's repeat and concatenate",
)
BIAS_LRELU = Kernel(
    "bias_lrelu", "bias_lrelu.cu", "bias_lrelu_launch",
    # y, bias, B, C, S, ncdhw, access bytes, slope, is_bf16, stream
    [_P, _P, _I, _I, _L, _I, _I, _F, _I, _P],
    "none: multimodal_registration_tpu/models/unet.py:171 is nn.Conv and leaky_relu in XLA",
)
KERNELS = (CONV3_LRELU_POOL, WARP_TRILINEAR, WARP_UP2X, MAX_POOL_2X_BWD,
           WARP_TRILINEAR_BWD, WARP_LABELS, WARP_LABELS_BWD, CONV3_INT8, FLOW_HEAD, UP_CAT,
           BIAS_LRELU)


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def entry_launch_counts() -> dict:
    """Counted launches by C entry (``symbol``), across every kernel."""
    return {sym: n for k in KERNELS for sym, n in k.entry_launches.items()}


@contextlib.contextmanager
def diverted_launches():
    """Count the calling thread's launches in the block into the yielded
    dict, ``{(kernel, symbol): n}``, instead of the counters: a CUDA graph's
    capture enqueues nothing, its replays run what it recorded
    (:func:`add_launches`)."""
    counted = {}
    _LOCAL.diverted = counted
    try:
        yield counted
    finally:
        _LOCAL.diverted = None


def add_launches(counted: dict) -> None:
    """Count ``{(kernel, symbol): n}`` as launched (a CUDA graph's replay)."""
    for (kernel, symbol), n in counted.items():
        kernel.launches += n
        kernel.entry_launches[symbol] = kernel.entry_launches.get(symbol, 0) + n


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.entry_launches.clear()


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # the handle without a Stream object around it
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


class on_device_of:
    """Context that makes ``t``'s device current for a launch. When it is
    current already (the usual case) entering and leaving cost one query."""

    def __init__(self, t):
        import torch

        self._guard = None
        if t.device.index != torch.cuda.current_device():
            self._guard = torch.cuda.device(t.device)

    def __enter__(self):
        if self._guard is not None:
            self._guard.__enter__()

    def __exit__(self, *exc):
        if self._guard is not None:
            self._guard.__exit__(*exc)
