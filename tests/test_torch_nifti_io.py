"""The port's ``utils/nifti.py`` against the JAX package's, for what the
batch pipeline switches on.

  * ``save`` writes the same bytes as the JAX package's ``save`` (the whole
    ``.gz`` file, and the ``.nii``) for float32, uint8, int16 and a 5-D
    field with intent 1007, given the same ``descrip`` (by default each
    names the package that wrote the file, and that field alone differs);
    ``MMREG_GZ_MODE=classic`` writes one gzip member of the same payload;
  * the decoded-file cache hands out views that share the read-only data
    and own their header and affine, primes itself on save and misses once
    a file is rewritten;
  * write-behind: a pending file is served to ``load``, ``flush_writes``
    lands it, an overwrite supersedes it, and ``disable_async_writes``
    makes ``save`` synchronous again;
  * a corrupt or truncated file raises one ``ValueError`` naming it.
"""

import gzip
import os

import numpy as np
import pytest

from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import scan_affine

DESCRIP = slice(148, 228)  # the header's 80-byte descrip field


def _field(rng):
    return rng.normal(size=(6, 5, 4, 1, 3)).astype(np.float32)


CASES = {
    "float32": lambda r: r.normal(size=(9, 7, 5)).astype(np.float32),
    "uint8": lambda r: (r.random((8, 6, 5)) > 0.7).astype(np.uint8),
    "int16": lambda r: r.integers(-2000, 2000, size=(7, 6, 5)).astype(np.int16),
    "5-D field, intent 1007": _field,
    "float32 over two gzip chunks": lambda r: np.concatenate(
        [np.zeros((64, 128, 64), np.float32), r.normal(size=(64, 128, 64)).astype(np.float32)]),
}


def _save_both(tmp_path, case, ext):
    data = CASES[case](np.random.default_rng(1))
    aff = scan_affine(data.shape[:3], (0.8, 0.9, 1.2), rot_deg=7.0, shift=(1.0, -2.0, 0.5))
    paths = {}
    for name, mod in (("jax", jnifti), ("torch", tnifti)):
        img = mod.NiftiImage(data, aff)
        if data.ndim == 5:
            img.header["intent_code"] = 1007
        paths[name] = (img, str(tmp_path / f"{name}{ext}"))
    return paths


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ext", [".nii.gz", ".nii"])
def test_save_writes_the_jax_packages_bytes(tmp_path, case, ext):
    paths = _save_both(tmp_path, case, ext)
    for name, mod in (("jax", jnifti), ("torch", tnifti)):
        mod.save(*paths[name])
    j, t = (open(paths[n][1], "rb").read() for n in ("jax", "torch"))
    raw_j, raw_t = (gzip.decompress(b) if ext == ".nii.gz" else b for b in (j, t))
    assert len(raw_t) == len(raw_j)
    assert raw_t[DESCRIP] != raw_j[DESCRIP]  # each names its own package
    assert raw_t[:148] + raw_t[228:] == raw_j[:148] + raw_j[228:]
    # the same descrip: the same file, compressed bytes and all
    img, path = paths["torch"]
    img.header.descrip = paths["jax"][0].header.descrip
    tnifti.save(img, path)
    assert open(path, "rb").read() == j


def test_classic_gz_mode_writes_one_member(tmp_path, monkeypatch):
    data = np.random.default_rng(5).standard_normal((32, 32, 32)).astype(np.float32)
    tnifti.save(tnifti.NiftiImage(data, np.eye(4)), str(tmp_path / "a.nii"))
    monkeypatch.setenv("MMREG_GZ_MODE", "classic")
    p = str(tmp_path / "c.nii.gz")
    tnifti.save(tnifti.NiftiImage(data, np.eye(4)), p)
    raw = open(p, "rb").read()
    assert gzip.decompress(raw) == (tmp_path / "a.nii").read_bytes()
    np.testing.assert_array_equal(jnifti.load(p).dataobj, data)


@pytest.fixture()
def fresh_cache(monkeypatch):
    monkeypatch.setattr(tnifti, "_LOAD_CACHE", {})
    monkeypatch.setattr(tnifti, "_LOAD_CACHE_ACTIVE", False)


def test_cache_views(tmp_path, fresh_cache):
    data = np.random.default_rng(2).normal(size=(6, 5, 4)).astype(np.float32)
    p = str(tmp_path / "c.nii.gz")
    tnifti.save(tnifti.NiftiImage(data, np.diag([1.0, 2.0, 3.0, 1.0])), p)
    assert not tnifti._LOAD_CACHE  # caching not in use: the save did not prime
    a = tnifti.load(p, cached=True)
    b = tnifti.load(p, cached=True)
    assert len(tnifti._LOAD_CACHE) == 1
    assert a.dataobj is b.dataobj and not a.dataobj.flags.writeable
    with pytest.raises(ValueError):
        a.dataobj[0, 0, 0] = 1.0
    # header and affine belong to the caller
    a.header["intent_code"] = 1007
    a.header.pixdim[1] = 9.0
    a.affine[0, 3] = 42.0
    c = tnifti.load(p, cached=True)
    assert c.header["intent_code"] == 0 and c.header.pixdim[1] == 1.0 and c.affine[0, 3] == 0.0
    np.testing.assert_array_equal(c.get_fdata(), data)
    # a mutable copy is the caller's to make
    np.testing.assert_array_equal(tnifti.load(p).dataobj, data)
    assert tnifti.load(p).dataobj.flags.writeable
    # once caching is in use, save primes it: the next cached load is a hit
    new = data * 3
    tnifti.save(tnifti.NiftiImage(new, np.eye(4)), p)
    key = tnifti._cache_key(p)
    assert key in tnifti._LOAD_CACHE
    np.testing.assert_array_equal(tnifti.load(p, cached=True).dataobj, new)
    # the LRU keeps the newest entries
    for i in range(tnifti._LOAD_CACHE_MAX + 2):
        tnifti.save(tnifti.NiftiImage(data + i, np.eye(4)), str(tmp_path / f"{i}.nii.gz"))
    assert len(tnifti._LOAD_CACHE) == tnifti._LOAD_CACHE_MAX and key not in tnifti._LOAD_CACHE


def test_write_behind(tmp_path, fresh_cache):
    rng = np.random.default_rng(11)
    data = rng.standard_normal((24, 20, 16)).astype(np.float32)
    p = str(tmp_path / "async.nii.gz")
    tnifti.enable_async_writes()
    try:
        tnifti.save(tnifti.NiftiImage(data, np.diag([1.0, 1.0, 2.0, 1.0])), p)
        img = tnifti.load(p)  # served whether or not the file has landed
        np.testing.assert_array_equal(img.dataobj, data)
        assert img.affine[2, 2] == 2.0
        tnifti.flush_writes(str(tmp_path))
        assert os.path.exists(p) and not tnifti._PENDING_IMGS
        np.testing.assert_array_equal(jnifti.load(p).dataobj, data)
        # an overwrite supersedes the first content, before and after it lands
        data2 = data * 2.0
        tnifti.save(tnifti.NiftiImage(data2, np.eye(4)), p)
        np.testing.assert_array_equal(tnifti.load(p, cached=True).dataobj, data2)
        tnifti.flush_writes()
        np.testing.assert_array_equal(tnifti.load(p).dataobj, data2)
        # an uncompressed file is written at once
        tnifti.save(tnifti.NiftiImage(data, np.eye(4)), str(tmp_path / "sync.nii"))
        assert os.path.exists(tmp_path / "sync.nii") and not tnifti._PENDING_IMGS
    finally:
        tnifti.disable_async_writes()
    assert not tnifti._ASYNC_ENABLED and not tnifti._PENDING_FUTURES
    q = str(tmp_path / "after.nii.gz")
    tnifti.save(tnifti.NiftiImage(data, np.eye(4)), q)
    assert os.path.exists(q) and not tnifti._PENDING_IMGS  # synchronous again


def test_a_failed_write_behind_raises_at_flush(tmp_path):
    tnifti.enable_async_writes()
    try:
        p = str(tmp_path / "no-such-dir" / "x.nii.gz")
        tnifti.save(tnifti.NiftiImage(np.zeros((4, 4, 4), np.float32), np.eye(4)), p)
        with pytest.raises(FileNotFoundError):
            tnifti.flush_writes()
        assert tnifti._pending_img(p) is None
    finally:
        tnifti.disable_async_writes()


@pytest.mark.parametrize("damage", ["truncated", "not gzip", "bad header"])
def test_corrupt_file_raises_one_value_error(tmp_path, damage):
    p = str(tmp_path / "v.nii.gz")
    tnifti.save(tnifti.NiftiImage(np.ones((8, 8, 8), np.float32), np.eye(4)), p)
    raw = open(p, "rb").read()
    if damage == "truncated":
        raw = raw[: len(raw) // 2]
    elif damage == "not gzip":
        raw = b"garbage" + raw
    else:
        raw = gzip.compress(b"\x00" * 400)
    with open(p, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="corrupt or truncated NIfTI file") as e:
        tnifti.load(p, cached=True)
    assert p in str(e.value) and "\n" not in str(e.value)
    with pytest.raises(FileNotFoundError):
        tnifti.load(str(tmp_path / "missing.nii.gz"))
