"""Port the evaluation (``evalx/``) against the JAX package's: the overlap
metrics of binary segmentations, the normalized mutual information, the
Jacobian determinant and its folding summary, and the three evaluator CLIs,
whose CSV files must be the same bytes (the timestamp column pinned).

Tolerances: Dice and the confusion counts equal; NMI 1e-6 (the joint
histogram is counted on the device, the entropies are the JAX package's host
code, so in practice equal); determinants and the folding summary 1e-5; the
CSV files byte-equal."""

import datetime
import importlib

import numpy as np
import pytest

from multimodal_registration_tpu.evalx import jacobian as jjac
from multimodal_registration_tpu.evalx import nmi as jnmi
from multimodal_registration_tpu.evalx import overlap as jov
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.evalx import cli as tcli
from multimodal_registration_torch.evalx import jacobian as tjac
from multimodal_registration_torch.evalx import nmi as tnmi
from multimodal_registration_torch.evalx import overlap as tov
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import rand

jcli = importlib.import_module("multimodal_registration_tpu.evalx.cli")
SHAPE = (20, 18, 16)


def _seg(seed, shift=0):
    g = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"))
    r2 = (g[0] - 10 - shift) ** 2 + (g[1] - 9) ** 2
    rng = np.random.default_rng(seed)
    return ((r2 < 16) ^ (rng.random(SHAPE) < 0.02)).astype(np.float64)


def _image(seed):
    im = rand(SHAPE, seed, low=0.0, high=1.0).astype(np.float64)
    im[:2] = 0.0  # zero padding that detect_zero_padding crops
    im[..., -3:] = 0.0
    return im


def _field(seed, amp):
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, s) for s in SHAPE], indexing="ij"), -1)
    rng = np.random.default_rng(seed)
    k = rng.uniform(1, 3, (3, 3))
    return (amp * np.sin(2 * np.pi * g @ k)).astype(np.float32)


@pytest.mark.parametrize("shift", [0, 2, 20])
def test_overlap_metrics_equal(shift):
    fx, seg = _seg(0), _seg(1, shift)
    assert tov.overlap_metrics(fx, seg, device="cpu") == jov.overlap_metrics(fx, seg)


@pytest.mark.parametrize("bins", [100, 7])
def test_nmi_matches_jax(bins):
    a, b = _image(2), _image(3)
    b[2:] = 0.7 * a[2:] + 0.3 * b[2:]
    assert tnmi.detect_zero_padding(a) == jnmi.detect_zero_padding(a)
    want = jnmi.normalized_mutual_information(a, b, bins=bins)
    got = tnmi.normalized_mutual_information(a, b, bins=bins, device="cpu")
    assert abs(got - want) <= 1e-6
    assert tnmi.normalized_mutual_information(a, a, bins=bins, device="cpu") == pytest.approx(2.0)


@pytest.mark.parametrize("amp", [0.1, 4.0])
@pytest.mark.parametrize("layout", ["xyz3", "nifti"])
def test_jacobian_matches_jax(amp, layout):
    f = _field(4, amp)
    if layout == "nifti":
        f = f[:, :, :, None, :]
    want, got = jjac.jacobian_determinant(f), tjac.jacobian_determinant(f, device="cpu")
    assert got.shape == want.shape == tuple(s - 4 for s in SHAPE)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ws, gs = jjac.folding_summary(f), tjac.folding_summary(f, device="cpu")
    assert (ws["n_negatives_detJa"] > 0) == (amp > 1)  # the large field folds
    for k in ws:
        if k != "det":
            assert gs[k] == pytest.approx(ws[k], abs=1e-5), k


class _Now(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def _write(d, nifti_mod, arrays):
    d.mkdir(parents=True, exist_ok=True)
    for name, a in arrays.items():
        nifti_mod.save(nifti_mod.NiftiImage(a, np.diag([1.0, 1.0, 1.5, 1.0])), str(d / name))


def test_eval_clis_write_the_same_csv_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(datetime, "datetime", _Now)  # the module both CLIs stamp rows with
    arrays = {"fx_seg.nii.gz": _seg(0), "mov_seg.nii.gz": _seg(1, 2), "reg_seg.nii.gz": _seg(2),
              "fx.nii.gz": _image(5), "mov.nii.gz": _image(6), "reg.nii.gz": _image(7),
              "field.nii.gz": _field(8, 4.0)[:, :, :, None, :]}
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    _write(dirs["jax"], jnifti, arrays)
    _write(dirs["port"], tnifti, arrays)
    codes = {}
    for pkg, mod in (("jax", jcli), ("port", tcli)):
        d = dirs[pkg]
        extra = ["--device", "cpu"] if pkg == "port" else []
        seg = ["--fx-seg-path", str(d / "fx_seg.nii.gz"), "--moving-seg-path",
               str(d / "mov_seg"), "--warped-seg-path", str(d / "reg_seg.nii.gz"),
               "--out-file", str(d / "seg.csv")]
        mi = ["--fx-im-path", str(d / "fx.nii.gz"), "--moving-im-path", str(d / "mov.nii.gz"),
              "--warped-im-path", str(d / "reg"), "--out-file", str(d / "nmi.csv")]
        jac = ["--def-field-path", str(d / "field.nii.gz"), "--out-file", str(d / "jac.csv"),
               "--out-im-path", str(d / "detJa.nii.gz")]
        codes[pkg] = [
            mod.eval_on_sc_seg(seg + ["--sub-id", "sub-01"] + extra),
            mod.eval_on_sc_seg(seg + ["--sub-id", "sub-02"] + extra),  # appended
            # the min-dice gate: exit code 1 and no row
            mod.eval_on_sc_seg(seg + ["--sub-id", "sub-03", "--min-dice", "99",
                                      "--last-eval", "0"] + extra),
            mod.eval_with_mi(mi + ["--sub-id", "sub-01"] + extra),
            mod.eval_with_mi(mi + ["--sub-id", "sub-02", "--append", "0"] + extra),  # rewritten
            mod.eval_with_jacobian(jac + ["--sub-id", "sub-01"] + extra),
            mod.eval_with_jacobian(jac + ["--sub-id", "sub-02"] + extra),
        ]
    assert codes["port"] == codes["jax"] == [0, 0, 1, 0, 0, 0, 0]
    for name in ("seg.csv", "nmi.csv", "jac.csv"):
        want = (dirs["jax"] / name).read_bytes()
        assert (dirs["port"] / name).read_bytes() == want, name
    assert (dirs["port"] / "seg.csv").read_text().count("\n") == 3
    assert (dirs["port"] / "nmi.csv").read_text().count("\n") == 2
    det_j = jnifti.load(str(dirs["jax"] / "detJa.nii.gz")).get_fdata()
    det_t = jnifti.load(str(dirs["port"] / "detJa.nii.gz")).get_fdata()
    np.testing.assert_allclose(det_t, det_j, atol=1e-5, rtol=0)
