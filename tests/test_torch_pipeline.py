"""Port the BIDS batch pipeline (``pipeline/``) against the JAX package's.

On a tiny BIDS tree written in ``tmp_path`` (40x40x32 volumes, one subject
with a session; enc/dec [4], float32; the same npz weights for both
packages, drawn with numpy from a seed), ``run_batch`` of the port (on the
CPU, with its write-behind saves and native prefetch) and of the JAX
package, in the basic, opt-affine (the fallback forced by ``min_sc_dice``
101) and two-step modes, give:

  * the same file tree;
  * the same CSV headers, subject IDs and rows, every value within 1e-3
    absolute + 1e-3 relative (float32 registrations in another order of
    operations move a threshold segmentation by a voxel at most), the
    timestamp column left out (it is the time of writing);
  * the same QC subjects, panel names, panel counts and metric names;
  * the same ``batch_summary.json`` keys and counts, and per-subject logs
    with the same keys and ``timings`` phases;
  * the final moved and fixed volumes within 1e-3.

Then the pieces: ``filter_subjects``, ``centermass_affine_field`` and
``rigid_affine_field`` exactly as the JAX package's; ``ThresholdSegmenter``
the same masks; ``apply_affine_field`` within 1e-5 of the JAX package's;
``warped_grid_mosaic`` equal to the JAX package's and to the mosaic of the
port's warp of the gridline volume; the QC PNG's pixels; ``register()`` from
prefetched arrays writing the same bytes as from the files; and ``jobs=4``
over 8 subjects with no torn CSV rows.
"""

import csv
import json
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.pipeline import batch as jbatch
from multimodal_registration_tpu.pipeline import qc as jqc
from multimodal_registration_tpu.pipeline import segment as jseg
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.ops.warp import warp as twarp
from multimodal_registration_torch.pipeline import batch as tbatch
from multimodal_registration_torch.pipeline import qc as tqc
from multimodal_registration_torch.pipeline import segment as tseg
from multimodal_registration_torch.utils import native as tnative
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import output_files, random_flat_params, scan_affine, tube_scan

TINY = dict(enc=[4] * 4, dec=[4] * 6, compute_dtype="float32")
SUBJECTS = ("sub-01", "sub-02/ses-01")
CSVS = ("metrics_on_sc_seg.csv", "nmi.csv", "jacobian_det.csv")


def _cord_vol(shape=(40, 40, 32), shift=(0.0, 0.0), seed=0, bright=3.0):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape[:2]], indexing="ij"), 0)
    tube = np.exp(-(((g[0] - shift[0]) ** 2 + (g[1] - shift[1]) ** 2)) * 30) * bright
    return (tube[..., None] * np.ones(shape[2]) + 0.1 * rng.random(shape)).astype(np.float32)


def _make_bids(root, subjects=SUBJECTS):
    data = os.path.join(root, "data")
    for i, sub in enumerate(subjects):
        anat = os.path.join(data, sub, "anat")
        os.makedirs(anat)
        prefix = sub.replace("/", "_")
        tnifti.save(tnifti.NiftiImage(_cord_vol(seed=i), np.eye(4)),
                    os.path.join(anat, f"{prefix}_T2w.nii.gz"))
        tnifti.save(tnifti.NiftiImage(_cord_vol(shift=(0.15, 0.05 * i), seed=i + 10), np.eye(4)),
                    os.path.join(anat, f"{prefix}_T1w.nii.gz"))
        with open(os.path.join(anat, f"{prefix}_T1w.json"), "w") as f:
            json.dump({"RepetitionTime": 2.0}, f)
    return data


def _weights(root, seed):
    path = os.path.join(root, f"w{seed}.npz")
    np.savez(path, **random_flat_params(JaxVxmConfig(enc=(4,) * 4, dec=(4,) * 6,
                                                     compute_dtype="float32"), seed,
                                        flow_scale=2e-3))
    return path


@pytest.fixture(scope="module")
def bids(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bids"))
    cfg = os.path.join(root, "cfg.json")
    with open(cfg, "w") as f:
        json.dump(TINY, f)
    return {"data": _make_bids(root), "cfg": cfg, "w1": _weights(root, 1),
            "w2": _weights(root, 2), "root": root}


def _csv_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _qc_structure(out):
    text = open(os.path.join(out, "qc", "index.html")).read()
    return {"subjects": re.findall(r"<h2>(.*?)</h2>", text),
            "panels": re.findall(r"<figcaption>(.*?)</figcaption>", text),
            "images": text.count("data:image/png;base64,"),
            "metrics": re.findall(r"<li>(.*?):", text)}


MODES = {
    "basic": {},
    "opt_affine": {"opt_affine": True, "min_sc_dice": 101},
    "two_step": {"model2": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_batch_matches_the_jax_package(bids, tmp_path, mode):
    kw = dict(MODES[mode])
    model2 = bids["w2"] if kw.pop("model2", False) else None
    common = dict(config_path=bids["cfg"], model2_path=model2, fx_contrast="T2w",
                  mov_contrast="T1w", **kw)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres, jsum = jbatch.run_batch(bids["data"], jout, bids["w1"], **common)
    tres, tsum = tbatch.run_batch(bids["data"], tout, bids["w1"], device="cpu", **common)
    assert [r.error for r in tres] == [None, None]
    assert [r.error for r in jres] == [None, None]

    assert output_files(tout) == output_files(jout)
    for name in CSVS:
        jh, jrows = _csv_rows(os.path.join(jout, "data_processed", name))
        th, trows = _csv_rows(os.path.join(tout, "data_processed", name))
        assert th == jh, name
        assert [r[1] for r in trows] == [r[1] for r in jrows] == list(SUBJECTS), name
        for jr, tr in zip(jrows, trows):
            assert len(tr) == len(jr), name
            np.testing.assert_allclose(np.array(tr[2:], float), np.array(jr[2:], float),
                                       rtol=1e-3, atol=1e-3, err_msg=name)
    qc = _qc_structure(tout)
    assert qc == _qc_structure(jout)
    assert qc["subjects"] == list(SUBJECTS) and qc["images"] == 8

    with open(os.path.join(jout, "batch_summary.json")) as f:
        js = json.load(f)
    with open(os.path.join(tout, "batch_summary.json")) as f:
        ts = json.load(f)
    assert ts.keys() == js.keys() and tsum.keys() == jsum.keys()
    for key in ("n_subjects", "n_ok", "n_affine_fallback"):
        assert ts[key] == js[key], key
    assert ts["per_subject_seconds"].keys() == js["per_subject_seconds"].keys()
    assert ts["n_affine_fallback"] == (2 if mode == "opt_affine" else 0)
    for sub in SUBJECTS:
        name = f"{sub.replace('/', '_')}.log"
        with open(os.path.join(jout, "log", name)) as f:
            jl = json.load(f)
        with open(os.path.join(tout, "log", name)) as f:
            tl = json.load(f)
        assert tl.keys() == jl.keys()
        assert tl["timings"].keys() == jl["timings"].keys(), name

    for sub in SUBJECTS:
        res = os.path.join("data_processed", sub.replace("/", "_"), "res")
        for name in os.listdir(os.path.join(jout, res)):
            a = jnifti.load(os.path.join(jout, res, name))
            b = tnifti.load(os.path.join(tout, res, name))
            np.testing.assert_array_equal(b.affine, a.affine, err_msg=name)
            np.testing.assert_allclose(b.get_fdata(), a.get_fdata(), atol=1e-3, rtol=0,
                                       err_msg=name)


FILTERS = [
    {},
    {"include": ["sub-0"]},
    {"exclude": ["ses-"]},
    {"include_list": ["sub-02", "sub-03"]},
    {"exclude_list": ["sub-10"]},
    {"include": [r"sub-0[12]$"]},
    {"include": ["sub"], "exclude": ["0"], "include_list": ["sub-10"]},
]


@pytest.mark.parametrize("kw", FILTERS, ids=[str(i) for i in range(len(FILTERS))])
def test_filter_subjects(kw):
    subs = ["sub-01", "sub-02", "sub-03/ses-01", "sub-10"]
    assert tbatch.filter_subjects(subs, **kw) == jbatch.filter_subjects(subs, **kw)


def _segs(seed):
    """A pair of cord-like masks, the moving one rotated and shifted."""
    from scipy import ndimage

    fx = np.zeros((40, 36, 20))
    fx[12:26, 15:21, 2:18] = 1.0
    fx[18:22, 14:22, 6:9] = 1.0
    mv = ndimage.rotate(fx, 5.0 + seed, axes=(0, 1), reshape=False, order=1)
    mv = ndimage.shift(mv, (2.5, -1.5, 0.5 * seed), order=1)
    mv = (mv > 0.5).astype(np.float64)
    mv[:, :, 15:] = 0.0  # slices without cord take the nearest valid translation
    return fx, mv


@pytest.mark.parametrize("seed", [0, 1])
def test_affine_fields_match_the_jax_package(seed):
    fx, mv = _segs(seed)
    np.testing.assert_array_equal(tseg.centermass_affine_field(fx, mv),
                                  jseg.centermass_affine_field(fx, mv))
    np.testing.assert_array_equal(tseg.rigid_affine_field(fx, mv),
                                  jseg.rigid_affine_field(fx, mv))


def test_apply_affine_field_matches_the_jax_package(tmp_path):
    fx, mv = _segs(0)
    field = tseg.centermass_affine_field(fx, mv)
    vol = _cord_vol(shape=fx.shape, seed=4)
    src = str(tmp_path / "mov.nii.gz")
    tnifti.save(tnifti.NiftiImage(vol, np.diag([0.8, 0.8, 1.2, 1.0])), src)
    jseg.apply_affine_field(src, field, str(tmp_path / "j.nii.gz"))
    tseg.apply_affine_field(src, field, str(tmp_path / "t.nii.gz"), device="cpu")
    a, b = jnifti.load(str(tmp_path / "j.nii.gz")), tnifti.load(str(tmp_path / "t.nii.gz"))
    np.testing.assert_array_equal(b.affine, a.affine)
    np.testing.assert_allclose(b.get_fdata(), a.get_fdata(), atol=1e-5, rtol=0)


def test_threshold_segmenter_matches_the_jax_package(tmp_path):
    vol = _cord_vol(seed=5)
    src = str(tmp_path / "v.nii.gz")
    tnifti.save(tnifti.NiftiImage(vol, np.eye(4)), src)
    tseg.ThresholdSegmenter()(src, "T2w", str(tmp_path / "t_seg.nii.gz"))
    jseg.ThresholdSegmenter()(src, "T2w", str(tmp_path / "j_seg.nii.gz"))
    t = tnifti.load(str(tmp_path / "t_seg.nii.gz"))
    j = jnifti.load(str(tmp_path / "j_seg.nii.gz"))
    assert t.dataobj.dtype == j.dataobj.dtype == np.uint8
    np.testing.assert_array_equal(t.dataobj, j.dataobj)
    assert 0 < int(t.dataobj.sum()) and set(np.unique(t.dataobj)) <= {0, 1}
    assert isinstance(tseg.default_segmenter(), tseg.ThresholdSegmenter)  # no SCT here


@pytest.mark.parametrize("scale", [1, 2])
def test_warped_grid_mosaic(scale):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(3)
    shape = (32, 24, 16)
    fshape = tuple(s // scale for s in shape)
    field = rng.standard_normal((*fshape, 3)).astype(np.float32)
    for c in range(3):
        field[..., c] = gaussian_filter(field[..., c], 3.0) * 8.0
    got = tqc.warped_grid_mosaic(field, scale, shape)
    np.testing.assert_array_equal(got, jqc.warped_grid_mosaic(field, scale, shape))
    if scale == 1:  # the closed form equals the mosaic of the warped gridline volume
        warped = twarp(torch.as_tensor(tqc.make_grid_volume(shape)), torch.as_tensor(field))
        np.testing.assert_allclose(got, tqc._mosaic(warped.numpy()), atol=1e-4)


def _decode_png(b64: str) -> np.ndarray:
    import base64

    raw = base64.b64decode(b64)
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(raw):
        n, tag = struct.unpack(">I4s", raw[pos: pos + 8])
        body = raw[pos + 8: pos + 8 + n]
        assert struct.unpack(">I", raw[pos + 8 + n: pos + 12 + n])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour = hdr[:4]
    assert (depth, colour) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()  # filter 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def test_qc_png_panels():
    img = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]])
    ov = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    plain = _decode_png(tqc._png_b64(img))
    assert plain.shape == (4, 6, 3)  # twice the size, nearest
    assert (plain[::2, ::2] == plain[1::2, 1::2]).all()
    gray = plain[::2, ::2, 0]
    assert (plain[..., 0] == plain[..., 1]).all() and gray[0, 0] == 0 and gray[1, 2] == 255
    np.testing.assert_array_equal(gray.ravel(), np.rint(np.minimum(
        np.floor(np.arange(6) / 5 * 256), 255) / 255 * 255))
    red = _decode_png(tqc._png_b64(img, ov))[::2, ::2]
    cyan = _decode_png(tqc._png_b64(img, ov, "cool"))[::2, ::2]
    for got, colour in ((red, (255, 0, 0)), (cyan, (0, 255, 255))):
        np.testing.assert_array_equal(got[ov == 0], plain[::2, ::2][ov == 0])
        want = np.rint(0.5 * np.array(colour) + 0.5 * plain[::2, ::2][ov != 0])
        assert (np.abs(got[ov != 0] - want) <= 1).all()


def test_register_from_prefetched_arrays_writes_the_same_bytes(tmp_path):
    """What ``run_batch`` hands the runner from the prefetch pool
    (``NiftiImage(data, affine)``, a header rebuilt) registers to the same
    output bytes as the files read by ``register()``, on an oblique,
    anisotropic pair."""
    cfg = tconf.InferenceConfig.from_dict(dict(TINY))
    reg = treg.Registrar(cfg, treg.load_params_any(_weights(str(tmp_path), 3), cfg),
                         device="cpu")
    fa = scan_affine((40, 36, 24), (1.0, 1.0, 1.5))
    ma = scan_affine((32, 32, 20), (1.25, 1.25, 1.8), rot_deg=6.0, shift=(1.0, 0.0, 0.5))
    outs = {}
    for how in ("files", "prefetched"):
        d = tmp_path / how
        d.mkdir()
        fx, mov = str(d / "fx.nii.gz"), str(d / "mov.nii.gz")
        tnifti.save(tnifti.NiftiImage(tube_scan((40, 36, 24), fa, 1), fa), fx)
        tnifti.save(tnifti.NiftiImage(tube_scan((32, 32, 20), ma, 2, 2.0), ma), mov)
        kw = {}
        if how == "prefetched":
            pool = tnative.PrefetchPool(n_threads=2)
            try:
                tickets = {"fixed_nii": pool.submit(fx), "moving_nii": pool.submit(mov)}
                kw = {k: tnifti.NiftiImage(*pool.wait(t)) for k, t in tickets.items()}
            finally:
                pool.close()
        treg.register(cfg, reg, fx, mov, fx_contrast="T2w", **kw)
        outs[how] = {n: (d / n).read_bytes() for n in output_files(str(d))}
    assert outs["files"].keys() == outs["prefetched"].keys()
    assert len(outs["files"]) == 8
    for name, data in outs["files"].items():
        assert outs["prefetched"][name] == data, name


def test_run_batch_jobs4_threadsafe(tmp_path):
    """``jobs=4`` over 8 subjects, the interpreter switching threads every
    10 us: every CSV row whole, each subject once, a deformation-grid panel
    per subject, nothing left pending."""
    subjects = tuple(f"sub-{i:02d}" for i in range(1, 9))
    data = _make_bids(str(tmp_path), subjects)
    cfgp = str(tmp_path / "cfg.json")
    with open(cfgp, "w") as f:
        json.dump(TINY, f)
    out = str(tmp_path / "out")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results, summary = tbatch.run_batch(data, out, _weights(str(tmp_path), 4),
                                            config_path=cfgp, jobs=4, device="cpu")
    finally:
        sys.setswitchinterval(interval)
    assert summary["n_subjects"] == 8
    assert summary["n_ok"] == 8, [r.error for r in results]
    for name in CSVS:
        header, body = _csv_rows(os.path.join(out, "data_processed", name))
        assert len(body) == 8, name
        assert all(len(r) == len(header) for r in body), name
        assert sorted(r[1] for r in body) == list(subjects)
    qc = _qc_structure(out)
    assert sorted(qc["subjects"]) == list(subjects)
    assert qc["panels"].count("moved + deformation grid") == 8 and qc["images"] == 32
    assert not tnifti._PENDING_IMGS and not tnifti._ASYNC_ENABLED
    for sub in subjects:
        work = os.path.join(out, "data_processed", sub)
        assert os.path.exists(os.path.join(work, "res", f"{sub}_T1w_proc_reg_to_T2w.nii.gz"))
        assert not [f for f in os.listdir(work) if f.endswith(".nii.gz")]


def test_pipeline_command(bids, tmp_path):
    from multimodal_registration_torch.__main__ import main as port_main

    out = str(tmp_path / "out")
    rc = port_main(["pipeline", "--path-data", bids["data"], "--path-output", out,
                    "--model-path", bids["w1"], "--config-path", bids["cfg"],
                    "--include-list", "sub-01", "--opt-affine", "--min-sc-dice", "101",
                    "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(out, "batch_summary.json")) as f:
        summary = json.load(f)
    assert (summary["n_subjects"], summary["n_ok"], summary["n_affine_fallback"]) == (1, 1, 1)
    assert os.path.exists(os.path.join(out, "data_processed", "sub-01", "origin",
                                       "sub-01_T1w.json"))


def test_qc_overlays_segmentations_still_being_written(tmp_path, monkeypatch):
    """Under write-behind a segmentation may not have landed when QC reads
    it: the overlay comes from the pending content, as it would from the
    file (the JAX package's QC checks the filesystem and drops it)."""
    import threading

    vols = {}
    for i, name in enumerate(("fx", "mov", "moved")):
        vols[name] = str(tmp_path / f"{name}.nii.gz")
        tnifti.save(tnifti.NiftiImage(_cord_vol(seed=i), np.eye(4)), vols[name])
    seg = str(tmp_path / "seg.nii.gz")
    landed = threading.Event()
    write = tnifti._write_payload

    def held_write(path, payload):
        assert landed.wait(30)
        write(path, payload)

    monkeypatch.setattr(tnifti, "_write_payload", held_write)
    tnifti.enable_async_writes()
    try:
        tnifti.save(tnifti.NiftiImage((_cord_vol() > 1.0).astype(np.uint8), np.eye(4)), seg)
        assert not os.path.exists(seg)
        qc = tqc.QCReport(str(tmp_path / "qc"))
        qc.add_subject("sub-01", vols["fx"], vols["mov"], vols["moved"],
                       seg_paths={"fixed": seg, "moved": str(tmp_path / "absent.nii.gz")})
    finally:
        landed.set()
        tnifti.disable_async_writes()
    overlays = {name: ov for name, _, ov, _ in qc.entries[0]["panels"]}
    assert overlays["fixed"] is not None and overlays["fixed"].any()
    assert overlays["moving"] is None and overlays["moved"] is None
    assert os.path.exists(seg)
