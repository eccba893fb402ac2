"""NIfTI-1 reader/writer (no nibabel dependency), the port's own copy.

Counterpart of ``multimodal_registration_tpu/utils/nifti.py``: the same
header handling (sform, qform with quaternions, pixdim fallback,
``scl_slope``/``scl_inter``), the same ``aff2axcodes`` and the same adaptive
multi-member ``.gz`` writer, so a file written here decodes to the same header
fields and data as one written by the JAX package (the same bytes, but for
``descrip``, which names the package that wrote the file).

What the batch pipeline switches on (``pipeline/batch.py``) is here too: the
decoded-file LRU (``load(path, cached=True)``, primed by ``save`` once
``enable_save_prime`` was called), write-behind (``enable_async_writes``:
``save`` of a ``.gz`` file compresses and writes on one background thread,
``load`` serves the pending content, ``flush_writes`` waits for the files) and
the classic single-member writer through the native library
(``MMREG_GZ_MODE=classic``, ``utils/native.py``).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field

import numpy as np

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclass
class NiftiHeader:
    """Minimal mutable view over the NIfTI-1 fields the framework uses."""

    dim: np.ndarray = field(default_factory=lambda: np.array([3, 1, 1, 1, 1, 1, 1, 1], np.int16))
    datatype: int = 16
    bitpix: int = 32
    pixdim: np.ndarray = field(default_factory=lambda: np.array([1, 1, 1, 1, 1, 1, 1, 1], np.float32))
    vox_offset: float = 352.0
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    intent_code: int = 0
    qform_code: int = 0
    sform_code: int = 2
    quatern: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))  # b, c, d
    qoffset: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    srow: np.ndarray = field(default_factory=lambda: np.eye(3, 4, dtype=np.float32))
    descrip: bytes = b"multimodal_registration_torch"
    xyzt_units: int = 10  # NIFTI_UNITS_MM | NIFTI_UNITS_SEC
    cal_max: float = 0.0
    cal_min: float = 0.0

    def __getitem__(self, key):  # nibabel-style header['intent_code'] access
        return getattr(self, key)

    def __setitem__(self, key, value):
        setattr(self, key, value)

    def get_zooms(self):
        ndim = int(self.dim[0])
        return tuple(float(z) for z in self.pixdim[1 : 1 + ndim])

    def get_data_shape(self):
        ndim = int(self.dim[0])
        return tuple(int(d) for d in self.dim[1 : 1 + ndim])

    def copy(self) -> "NiftiHeader":
        """Independent copy (array fields copied): the decoded-file cache
        hands these out, so a caller editing a header leaves the entry be."""
        return dataclasses.replace(
            self, dim=self.dim.copy(), pixdim=self.pixdim.copy(),
            quatern=self.quatern.copy(), qoffset=self.qoffset.copy(), srow=self.srow.copy())


def _quaternion_to_rotation(b, c, d, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    R[:, 2] *= qfac
    return R


def _rotation_to_quaternion(R):
    """Inverse of `_quaternion_to_rotation` (assumes a proper rotation)."""
    t = np.trace(R)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        b = (R[2, 1] - R[1, 2]) / (4 * w)
        c = (R[0, 2] - R[2, 0]) / (4 * w)
        d = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0))
        q = np.zeros(4)
        q[i + 1] = 0.5 * s
        s = 0.5 / s if s > 0 else 0.0
        q[0] = (R[k, j] - R[j, k]) * s
        q[j + 1] = (R[j, i] + R[i, j]) * s
        q[k + 1] = (R[k, i] + R[i, k]) * s
        w, b, c, d = q
        if w < 0:
            w, b, c, d = -w, -b, -c, -d
    return b, c, d


class NiftiImage:
    """Lightweight stand-in for ``nibabel.Nifti1Image``."""

    def __init__(self, dataobj: np.ndarray, affine: np.ndarray, header: NiftiHeader | None = None):
        dataobj = np.asarray(dataobj)
        self._data = dataobj
        self.affine = np.asarray(affine, dtype=np.float64)
        if header is None:
            header = NiftiHeader()
            header.datatype = _DTYPE_CODES.get(dataobj.dtype, 16)
            if dataobj.dtype not in _DTYPE_CODES:
                self._data = dataobj.astype(np.float32)
                header.datatype = 16
            header.bitpix = self._data.dtype.itemsize * 8
            ndim = self._data.ndim
            header.dim = np.ones(8, np.int16)
            header.dim[0] = ndim
            header.dim[1 : 1 + ndim] = self._data.shape
            # zooms from affine column norms
            zooms = np.sqrt((self.affine[:3, :3] ** 2).sum(axis=0))
            header.pixdim = np.ones(8, np.float32)
            header.pixdim[1:4] = zooms
        self.header = header
        self._sync_affine_into_header()

    @property
    def shape(self):
        return self._data.shape

    @property
    def ndim(self):
        return self._data.ndim

    def get_fdata(self, dtype=np.float64):
        data = self._data.astype(dtype)
        slope = float(self.header.scl_slope)
        inter = float(self.header.scl_inter)
        if not np.isfinite(slope) or slope == 0.0:
            slope = 1.0
        if not np.isfinite(inter):
            inter = 0.0
        if slope != 1.0 or inter != 0.0:
            data = data * slope + inter
        return data

    @property
    def dataobj(self):
        return self._data

    def _sync_affine_into_header(self):
        h = self.header
        h.srow = self.affine[:3, :4].astype(np.float32)
        if h.sform_code == 0:
            h.sform_code = 2
        # keep qform consistent when the rotation part is orthogonal enough
        R = self.affine[:3, :3].copy()
        zooms = np.sqrt((R**2).sum(axis=0))
        zooms[zooms == 0] = 1.0
        Rn = R / zooms
        qfac = 1.0
        if np.linalg.det(Rn) < 0:
            Rn[:, 2] *= -1
            qfac = -1.0
        if np.allclose(Rn @ Rn.T, np.eye(3), atol=1e-4):
            b, c, d = _rotation_to_quaternion(Rn)
            h.quatern = np.array([b, c, d], np.float32)
            h.qoffset = self.affine[:3, 3].astype(np.float32)
            h.qform_code = 1
            h.pixdim[0] = qfac
            h.pixdim[1:4] = zooms
        else:
            h.qform_code = 0


def _parse_header(buf: bytes) -> tuple[NiftiHeader, str]:
    sizeof_hdr = struct.unpack_from("<i", buf, 0)[0]
    endian = "<"
    if sizeof_hdr != HEADER_SIZE:
        endian = ">"
        sizeof_hdr = struct.unpack_from(">i", buf, 0)[0]
        if sizeof_hdr != HEADER_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, buf, off)

    h = NiftiHeader()
    h.dim = np.array(u("8h", 40), np.int16)
    h.intent_code = u("h", 68)[0]
    h.datatype = u("h", 70)[0]
    h.bitpix = u("h", 72)[0]
    h.pixdim = np.array(u("8f", 76), np.float32)
    h.vox_offset = u("f", 108)[0]
    h.scl_slope = u("f", 112)[0]
    h.scl_inter = u("f", 116)[0]
    h.xyzt_units = u("B", 123)[0]
    h.cal_max = u("f", 124)[0]
    h.cal_min = u("f", 128)[0]
    h.qform_code = u("h", 252)[0]
    h.sform_code = u("h", 254)[0]
    h.quatern = np.array(u("3f", 256), np.float32)
    h.qoffset = np.array(u("3f", 268), np.float32)
    h.srow = np.array(u("12f", 280), np.float32).reshape(3, 4)
    return h, endian


def _affine_from_header(h: NiftiHeader) -> np.ndarray:
    aff = np.eye(4)
    if h.sform_code > 0:
        aff[:3, :4] = h.srow
    elif h.qform_code > 0:
        qfac = float(h.pixdim[0]) if h.pixdim[0] in (-1.0, 1.0) else 1.0
        R = _quaternion_to_rotation(*[float(q) for q in h.quatern], qfac)
        zooms = np.abs(h.pixdim[1:4]).astype(np.float64)
        aff[:3, :3] = R * zooms
        aff[:3, 3] = h.qoffset
    else:
        aff[0, 0], aff[1, 1], aff[2, 2] = h.pixdim[1:4]
    return aff


# Decoded-file LRU of the batch pipeline: a subject's outputs are read again
# by the segmenter, the evaluators and QC. Keyed by (realpath, mtime_ns,
# size), so a rewrite invalidates the entry. A hit is a per-caller view: the
# data is shared and read-only, header and affine are the caller's own.
# ``save`` primes the cache only once caching is in use (the first
# ``load(cached=True)``, or ``enable_save_prime``), so that one-shot CLIs
# neither decode what they wrote nor keep it.
_LOAD_CACHE: "dict[tuple, NiftiImage]" = {}
_LOAD_CACHE_LOCK = threading.Lock()
_LOAD_CACHE_MAX = 8
_LOAD_CACHE_ACTIVE = False


def output_dtype():
    """The type of the exported volumes (the moved image on the moving grid,
    the Jacobian determinant): float32, which halves their gzip payload;
    ``MMREG_F64_OUTPUTS`` set to a non-empty value writes the reference's
    float64 instead, as the JAX package does."""
    return np.float64 if os.environ.get("MMREG_F64_OUTPUTS") else np.float32


def enable_save_prime() -> None:
    """Let ``save`` prime the decoded-file cache (the pipeline calls this; the
    first ``load(cached=True)`` does too)."""
    global _LOAD_CACHE_ACTIVE
    _LOAD_CACHE_ACTIVE = True


def _cache_view(img: NiftiImage) -> NiftiImage:
    """Per-caller view of a cached image: shared read-only data, own header."""
    view = NiftiImage.__new__(NiftiImage)
    view._data = img._data
    view.affine = img.affine.copy()
    view.header = img.header.copy()
    return view


def _cache_key(path: str):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (os.path.realpath(path), st.st_mtime_ns, st.st_size)


def _cache_insert(key: tuple, img: NiftiImage) -> None:
    img._data.flags.writeable = False
    with _LOAD_CACHE_LOCK:
        _LOAD_CACHE[key] = img
        while len(_LOAD_CACHE) > _LOAD_CACHE_MAX:
            _LOAD_CACHE.pop(next(iter(_LOAD_CACHE)))


def load(path: str, cached: bool = False) -> NiftiImage:
    """Load a ``.nii`` / ``.nii.gz`` file (parity: ``nib.load``).

    A file whose write-behind save is still pending is served from memory.
    ``cached=True`` consults and fills the decoded-file LRU. A file that does
    not decode raises one ``ValueError`` naming it."""
    pending = _pending_img(path)
    if pending is not None:
        return pending
    key = None
    if cached:
        enable_save_prime()
        key = _cache_key(path)
        if key is not None:
            with _LOAD_CACHE_LOCK:
                img = _LOAD_CACHE.get(key)
            if img is not None:
                return _cache_view(img)
    opener = gzip.open if str(path).endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            raw = f.read()
        img = _parse_image(raw)
    except FileNotFoundError:
        raise
    except (OSError, EOFError, ValueError, IndexError, struct.error) as e:
        raise ValueError(
            f"corrupt or truncated NIfTI file {path!r}: "
            f"{e.__class__.__name__}: {e}"
        ) from e
    if key is not None:
        _cache_insert(key, img)
        return _cache_view(img)
    return img


def _parse_image(raw: bytes) -> NiftiImage:
    """Parse a full (uncompressed) NIfTI-1 byte stream into an image."""
    h, endian = _parse_header(raw)
    dtype = np.dtype(_DTYPES[h.datatype]).newbyteorder(endian)
    ndim = int(h.dim[0])
    shape = tuple(int(d) for d in h.dim[1 : 1 + ndim])
    offset = int(h.vox_offset)
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")
    return NiftiImage(np.ascontiguousarray(data), _affine_from_header(h), h)


# ---- write-behind ------------------------------------------------------------
#
# The compression and disk write of a saved volume overlap the caller's next
# steps (in the pipeline: a subject's segmentation, evaluation and QC).
# Writes go through one background thread; ``load`` serves a pending file
# from memory, and ``flush_writes()`` comes before any direct filesystem
# consumer (the pipeline's reorganize step, its output check, an external
# segmenter, the end of the run).
_ASYNC_POOL = None
_ASYNC_ENABLED = False
_PENDING_LOCK = threading.Lock()
_PENDING_FUTURES: "dict[str, object]" = {}
_PENDING_IMGS: "dict[str, NiftiImage]" = {}


def enable_async_writes() -> None:
    """Make ``save`` of a ``.gz`` file return before the file is written."""
    global _ASYNC_POOL, _ASYNC_ENABLED
    if _ASYNC_POOL is None:
        import atexit
        from concurrent.futures import ThreadPoolExecutor

        _ASYNC_POOL = ThreadPoolExecutor(1, thread_name_prefix="mmreg-nifti-write")
        atexit.register(flush_writes)
    _ASYNC_ENABLED = True


def disable_async_writes() -> None:
    """Flush pending writes and make ``save`` synchronous again. The pipeline
    scopes write-behind to its run: later code that lists a directory would
    not see a file still pending, though ``load`` of its path would work."""
    global _ASYNC_ENABLED
    _ASYNC_ENABLED = False
    flush_writes()


def flush_writes(prefix: str | None = None) -> None:
    """Wait for the pending writes (all, or those under ``prefix``); then
    re-raise the first writer's exception, once."""
    with _PENDING_LOCK:
        items = [(p, f) for p, f in _PENDING_FUTURES.items()
                 if prefix is None or p.startswith(prefix)]
    failure = None
    for p, fut in items:
        try:
            fut.result()
        except Exception as e:  # re-raised below, after every write has landed
            failure = failure or e
        with _PENDING_LOCK:
            if _PENDING_FUTURES.get(p) is fut:
                del _PENDING_FUTURES[p]
    if failure is not None:
        raise failure


def _pending_img(path: str) -> "NiftiImage | None":
    with _PENDING_LOCK:
        img = _PENDING_IMGS.get(os.path.abspath(path))
    return _cache_view(img) if img is not None else None


# ---- adaptive .gz writer -----------------------------------------------------
#
# Each 4 MB chunk becomes its own gzip member (RFC 1952 §2.2: members
# concatenate; Python gzip, zlib's gzread and nibabel all read them), written
# with the cheapest zlib strategy that still pays on that chunk, judged by a
# 32 KB probe: smooth or zero data (probe ratio < 0.40) as DEFAULT level 1,
# mixed volume data (< 0.92) as Z_RLE level 1, incompressible float
# mantissas stored (level 0).
_GZ_CHUNK = 4 << 20
_GZ_PROBE = 32 << 10


def _gz_member(chunk, level: int, strategy: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, 31, 9, strategy)
    return co.compress(chunk) + co.flush()


def _gz_compress_adaptive(payload: bytes) -> bytes:
    mv = memoryview(payload)
    parts = []
    for s in range(0, len(payload), _GZ_CHUNK):
        chunk = mv[s : s + _GZ_CHUNK]
        probe = bytes(chunk[:_GZ_PROBE])
        r = len(_gz_member(probe, 1, zlib.Z_RLE)) / max(len(probe), 1)
        if r < 0.40:
            parts.append(_gz_member(chunk, 1, zlib.Z_DEFAULT_STRATEGY))
        elif r < 0.92:
            parts.append(_gz_member(chunk, 1, zlib.Z_RLE))
        else:
            parts.append(_gz_member(chunk, 0, zlib.Z_DEFAULT_STRATEGY))
    return b"".join(parts)


def save(img: NiftiImage, path: str) -> None:
    """Save a NiftiImage (parity: ``nib.save``). Under write-behind
    (:func:`enable_async_writes`) a ``.gz`` save returns before the file is
    written; the caller must not mutate the data afterwards."""
    h = img.header
    img._sync_affine_into_header()
    data = img.dataobj
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    h.datatype = _DTYPE_CODES[data.dtype]
    h.bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    h.dim = np.ones(8, np.int16)
    h.dim[0] = ndim
    h.dim[1 : 1 + ndim] = data.shape
    h.vox_offset = 352.0

    buf = bytearray(352)
    p = struct.pack_into
    p("<i", buf, 0, HEADER_SIZE)
    p("<8h", buf, 40, *[int(d) for d in h.dim])
    p("<h", buf, 68, int(h.intent_code))
    p("<h", buf, 70, int(h.datatype))
    p("<h", buf, 72, int(h.bitpix))
    p("<8f", buf, 76, *[float(v) for v in h.pixdim])
    p("<f", buf, 108, float(h.vox_offset))
    p("<f", buf, 112, float(h.scl_slope) if h.scl_slope else 1.0)
    p("<f", buf, 116, float(h.scl_inter))
    p("<B", buf, 123, int(h.xyzt_units) & 0xFF)
    p("<f", buf, 124, float(h.cal_max))
    p("<f", buf, 128, float(h.cal_min))
    descrip = (h.descrip or b"")[:79]
    buf[148 : 148 + len(descrip)] = descrip
    p("<h", buf, 252, int(h.qform_code))
    p("<h", buf, 254, int(h.sform_code))
    p("<3f", buf, 256, *[float(q) for q in h.quatern])
    p("<3f", buf, 268, *[float(q) for q in h.qoffset])
    p("<12f", buf, 280, *[float(v) for v in np.asarray(h.srow).ravel()])
    buf[344:348] = b"n+1\x00"

    payload = bytes(buf) + np.asfortranarray(data).tobytes(order="F")
    if _ASYNC_ENABLED and _ASYNC_POOL is not None and str(path).endswith(".gz"):
        # write-behind: the caller goes on and must not mutate `data` (the
        # save contract); readers get the pending content from ``load``
        key = os.path.abspath(path)
        pending = NiftiImage(data, img.affine.copy(), h.copy())

        def _job():
            try:
                _write_payload(path, payload)
            finally:
                with _PENDING_LOCK:
                    if _PENDING_IMGS.get(key) is pending:
                        del _PENDING_IMGS[key]

        with _PENDING_LOCK:
            _PENDING_IMGS[key] = pending
            _PENDING_FUTURES[key] = _ASYNC_POOL.submit(_job)
        return
    _write_payload(path, payload)


def _write_payload(path: str, payload: bytes) -> None:
    """Write an uncompressed NIfTI byte stream to ``path`` (compressed when it
    ends in ``.gz``), then prime the decoded-file cache with it. The ``.gz``
    writer is the adaptive one, or with ``MMREG_GZ_MODE=classic`` one gzip
    member at ``MMREG_GZ_LEVEL`` (default 1), through the native library
    where it is built, else Python's ``gzip``."""
    # write-then-rename: a reader never sees a half-written file
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    if str(path).endswith(".gz"):
        if os.environ.get("MMREG_GZ_MODE", "adaptive") == "adaptive":
            with open(tmp, "wb") as f:
                f.write(_gz_compress_adaptive(payload))
        else:
            from multimodal_registration_torch.utils.native import write_gz_native

            if not write_gz_native(tmp, payload):
                bio = io.BytesIO()
                level = int(os.environ.get("MMREG_GZ_LEVEL", 1))
                with gzip.GzipFile(fileobj=bio, mode="wb", mtime=0, compresslevel=level) as f:
                    f.write(payload)
                with open(tmp, "wb") as f:
                    f.write(bio.getvalue())
    else:
        with open(tmp, "wb") as f:
            f.write(payload)
    os.replace(tmp, path)
    if _LOAD_CACHE_ACTIVE:
        key = _cache_key(path)
        if key is not None:
            _cache_insert(key, _parse_image(payload))


def aff2axcodes(affine: np.ndarray, labels=(("L", "R"), ("P", "A"), ("I", "S"))) -> tuple:
    """Axis direction codes of an affine (parity: ``nib.aff2axcodes``)."""
    R = np.asarray(affine)[:3, :3].copy()
    codes = [None, None, None]
    used = set()
    # greedy assignment by strongest axis alignment (matches nibabel
    # io_orientation for the orthogonal-dominant affines scanners produce)
    order = np.dstack(np.unravel_index(np.argsort(-np.abs(R), axis=None), R.shape))[0]
    for world_ax, vox_ax in order:
        world_ax, vox_ax = int(world_ax), int(vox_ax)
        if codes[vox_ax] is not None or world_ax in used:
            continue
        sign = np.sign(R[world_ax, vox_ax])
        codes[vox_ax] = labels[world_ax][1] if sign > 0 else labels[world_ax][0]
        used.add(world_ax)
    return tuple(codes)
