"""The port's native NIfTI runtime (``runtime/niftiio.cpp`` through
``utils/native.py``), built here with ``g++`` at first use.

The native reader gives exactly what the port's Python reader and the JAX
package's give (float32 data after ``scl_slope``/``scl_inter``, the affine
from sform, qform or pixdim) for float32, uint8 with scaling, int16, plain
``.nii`` and a qform-only header; the gzip writer's file decodes through
both readers and Python's ``gzip``; the prefetch pool returns each file's
volume; a missing or corrupt file raises ``IOError``; and a library that
does not build leaves ``get_lib()`` None with one line on stderr.
"""

import gzip
import struct

import numpy as np
import pytest

from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.utils import native as tnative
from multimodal_registration_torch.utils import nifti as tnifti


def _save(path, data, affine=None, slope=None, inter=None):
    img = tnifti.NiftiImage(data, np.eye(4) if affine is None else affine)
    if slope is not None:
        img.header.scl_slope = slope
    if inter is not None:
        img.header.scl_inter = inter
    tnifti.save(img, str(path))
    return str(path)


def _assert_readers_agree(path):
    """Native data and affine exactly as both Python readers give them."""
    d, a = tnative.load_nifti_native(path)
    assert d.dtype == np.float32 and d.flags.c_contiguous
    for mod in (tnifti, jnifti):
        img = mod.load(path)
        np.testing.assert_array_equal(d, img.get_fdata(np.float32))
        np.testing.assert_array_equal(a, img.affine.astype(np.float32).astype(np.float64))
    return d, a


OBLIQUE = np.array([[0, 0, 2.0, -5], [1.5, 0, 0, 3], [0, -1, 0, 7], [0, 0, 0, 1.0]])
CASES = {
    "float32": (lambda r: r.normal(size=(9, 7, 5)).astype(np.float32), OBLIQUE, None, None),
    "uint8, scl_slope 2, scl_inter -1": (
        lambda r: np.arange(24, dtype=np.uint8).reshape(2, 3, 4), None, 2.0, -1.0),
    "int16, scl_slope 0.5": (
        lambda r: r.integers(-3000, 3000, size=(6, 5, 4)).astype(np.int16), None, 0.5, 3.0),
    "4-D float32": (lambda r: r.normal(size=(5, 4, 3, 2)).astype(np.float32), None, None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ext", [".nii.gz", ".nii"])
def test_native_reader_matches_both_python_readers(tmp_path, case, ext):
    make, aff, slope, inter = CASES[case]
    data = make(np.random.default_rng(0))
    path = _save(tmp_path / f"x{ext}", data, aff, slope, inter)
    d, _ = _assert_readers_agree(path)
    want = data.astype(np.float32)
    if slope is not None:
        want = want * np.float32(slope) + np.float32(inter)
    np.testing.assert_allclose(d, want, rtol=1e-6)


def test_native_qform_only_matches_python(tmp_path):
    """sform_code 0 with a qform quaternion (FSL or scanner style): the
    native reader honours the quaternion as the Python readers do."""
    data = np.random.default_rng(4).normal(size=(6, 5, 4)).astype(np.float32)
    p = _save(tmp_path / "q.nii.gz", data)
    raw = bytearray(gzip.open(p, "rb").read())
    d_q = np.sin(np.deg2rad(15.0))  # 30 degrees about z
    struct.pack_into("<h", raw, 252, 1)
    struct.pack_into("<h", raw, 254, 0)
    struct.pack_into("<3f", raw, 256, 0.0, 0.0, float(d_q))
    struct.pack_into("<3f", raw, 268, -5.0, 3.5, 7.25)
    struct.pack_into("<8f", raw, 76, 1.0, 1.0, 1.25, 2.0, 0, 0, 0, 0)
    with gzip.open(p, "wb") as f:
        f.write(bytes(raw))
    dn, an = tnative.load_nifti_native(p)
    np.testing.assert_array_equal(dn, data)
    for mod in (tnifti, jnifti):
        np.testing.assert_allclose(an, mod.load(p).affine, atol=1e-6)
    assert abs(an[0, 1]) > 0.1, "rotation lost: qform ignored"


def test_gz_writer_roundtrip(tmp_path):
    data = np.random.default_rng(3).normal(size=(12, 10, 8)).astype(np.float32)
    img = tnifti.NiftiImage(data, np.diag([1.0, 1.0, 2.0, 1.0]))
    p = str(tmp_path / "w.nii.gz")
    tnifti.save(img, str(tmp_path / "ref.nii"))
    payload = (tmp_path / "ref.nii").read_bytes()
    for level in (0, 1, 6):
        assert tnative.write_gz_native(p, payload, level)
        assert gzip.decompress(open(p, "rb").read()) == payload
        d, a = _assert_readers_agree(p)
        np.testing.assert_array_equal(d, data)
        assert a[2, 2] == 2.0
    blob = b"mmreg-native-gz" * 1000
    assert tnative.write_gz_native(str(tmp_path / "blob.gz"), blob)
    assert gzip.decompress((tmp_path / "blob.gz").read_bytes()) == blob


def test_prefetch_pool(tmp_path):
    rng = np.random.default_rng(2)
    vols = [rng.normal(size=(8, 8, 8 + i)).astype(np.float32) for i in range(6)]
    paths = [_save(tmp_path / f"v{i}.nii.gz", v) for i, v in enumerate(vols)]
    pool = tnative.PrefetchPool(n_threads=3)
    try:
        tickets = [pool.submit(p) for p in paths]
        for t, v in zip(reversed(tickets), reversed(vols)):  # any order
            d, a = pool.wait(t)
            np.testing.assert_array_equal(d, v)
            np.testing.assert_array_equal(a, np.eye(4))
        bad = pool.submit(str(tmp_path / "missing.nii.gz"))
        with pytest.raises(IOError):
            pool.wait(bad)
    finally:
        pool.close()
    pool.close()  # a second close is a no-op


def test_missing_and_corrupt_files_raise(tmp_path):
    with pytest.raises(IOError):
        tnative.load_nifti_native(str(tmp_path / "nope.nii.gz"))
    (tmp_path / "bad.nii").write_bytes(b"\0" * 400)
    with pytest.raises(IOError):
        tnative.load_nifti_native(str(tmp_path / "bad.nii"))


def test_a_library_that_does_not_build(tmp_path, monkeypatch, capsys):
    """No compiler: ``get_lib()`` is None after one line on stderr, the
    prefetch pool refuses, and the gzip writer reports it did not write."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_error", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.build_lib()
    assert tnative.get_lib() is None
    assert tnative.get_lib() is None
    err = capsys.readouterr().err
    assert err.count("native NIfTI runtime unavailable") == 1 and err.count("\n") == 1
    with pytest.raises(RuntimeError, match="not available"):
        tnative.PrefetchPool()
    assert not tnative.write_gz_native(str(tmp_path / "x.gz"), b"x")


def test_dims_inflate_the_header_only(tmp_path):
    """``mmreg_nifti_dims`` (how a caller sizes its buffer before a load or
    before collecting a prefetch) reads the header alone: it answers for a
    file whose data is cut short, which the load then refuses."""
    import ctypes

    data = np.random.default_rng(6).normal(size=(64, 64, 32)).astype(np.float32)
    p = _save(tmp_path / "whole.nii.gz", data)
    raw = gzip.decompress(open(p, "rb").read())
    cut = str(tmp_path / "cut.nii.gz")
    with open(cut, "wb") as f:
        f.write(gzip.compress(raw[: 352 + 1000]))
    dims = (ctypes.c_int32 * 8)()
    assert tnative.get_lib().mmreg_nifti_dims(cut.encode(), dims) == 3
    assert list(dims)[:4] == [3, 64, 64, 32]
    with pytest.raises(IOError):
        tnative.load_nifti_native(cut)
