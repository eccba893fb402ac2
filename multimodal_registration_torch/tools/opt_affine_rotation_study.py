"""The opt-affine fallback on rotation-dominant failures: what slice-wise
center-of-mass alignment recovers, and what the rigid fallback adds.

    python -m multimodal_registration_torch.tools.opt_affine_rotation_study [--out FILE]

The port's counterpart of ``benchmarks/opt_affine_rotation_study.py``. The
reference's affine fallback is ``sct_register_multimodal -param
step=1,type=seg,algo=centermass``: per axial slice, align the segmentations'
in-plane centers of mass, a slice-wise translation
(``pipeline/segment.py::centermass_affine_field``). On a synthetic curved
elliptical tube (96x96x128, a spinal-cord-like binary segmentation) under the
two-step artifact's displacement regime (up to 12 voxels of translation, 6
degrees of rotation about one axis), six cases measure Dice before and after
that fallback and after the opt-in ``rigid`` one (principal axes,
``pipeline/segment.py::rigid_affine_field``), the residual in-plane angle of
the cross-sections, and the centermass field against an independent
simulation of SCT's algorithm (scipy shifts). The rows and the summary have
the JAX script's keys; the seeds are the same numpy ones, so the rows equal
the committed ``benchmarks/opt_affine_rotation_results.json``, including its
``"centermass_recovers_translation": false`` (Dice 0.932 < 0.95), which the
port copies and does not "fix".

Host numpy and scipy only: there is no device work, so the tool has no
``--device``. The record goes to ``--out`` (never under ``benchmarks/``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from multimodal_registration_torch.pipeline.segment import (
    centermass_affine_field, rigid_affine_field)
from multimodal_registration_torch.tools.timing import write_result

CASES = (
    ("translation_only", 0.0, 0, (9.0, -7.0, 4.0)),
    ("rot_x_6deg", 6.0, 0, (0.0, 0.0, 0.0)),
    ("rot_y_-6deg", -6.0, 1, (0.0, 0.0, 0.0)),
    ("rot_z_6deg", 6.0, 2, (0.0, 0.0, 0.0)),
    ("rot_z_6deg_plus_shift", 6.0, 2, (9.0, -7.0, 4.0)),
    ("artifact_regime_rot_x", 6.0, 0, (12.0, -12.0, 12.0)),
)


def make_tube(shape=(96, 96, 128), radius=6.0, seed=0):
    """Curved elliptical tube along z — a spinal-cord-like binary seg."""
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    z = np.arange(Z)
    # smooth centerline curve
    cx = X / 2 + 8 * np.sin(2 * np.pi * z / Z * rng.uniform(0.7, 1.3))
    cy = Y / 2 + 6 * np.cos(2 * np.pi * z / Z * rng.uniform(0.5, 1.1))
    gx = np.arange(X)[:, None, None]
    gy = np.arange(Y)[None, :, None]
    # elliptical cross-section (anisotropy makes in-plane rotation visible)
    d2 = ((gx - cx[None, None, :]) / radius) ** 2 + (
        (gy - cy[None, None, :]) / (0.6 * radius)
    ) ** 2
    return (d2 <= 1.0).astype(np.float32)


def rigid_transform(seg, ang_deg, axis, shift):
    from scipy import ndimage

    ang = np.deg2rad(ang_deg)
    rot = np.eye(3)
    i, j = [a for a in range(3) if a != axis]
    rot[i, i] = rot[j, j] = np.cos(ang)
    rot[i, j], rot[j, i] = -np.sin(ang), np.sin(ang)
    center = (np.asarray(seg.shape) - 1) / 2.0
    offset = center - rot @ center + np.asarray(shift, np.float64)
    return ndimage.affine_transform(seg, rot, offset=offset, order=0)


def dice(a, b):
    a, b = a > 0.5, b > 0.5
    inter = float(np.logical_and(a, b).sum())
    s = float(a.sum() + b.sum())
    return 2 * inter / s if s else 1.0


def apply_field_host(seg, field):
    """moved(x) = seg(x + phi(x)), nearest (binary seg)."""
    from scipy import ndimage

    X, Y, Z = seg.shape
    grid = np.stack(np.meshgrid(
        np.arange(X, dtype=np.float64), np.arange(Y, dtype=np.float64),
        np.arange(Z, dtype=np.float64), indexing="ij"), 0)
    coords = grid + np.moveaxis(field.astype(np.float64), -1, 0)
    return ndimage.map_coordinates(seg, coords, order=0, mode="constant")


def sct_centermass_simulator(fx_seg, mov_seg):
    """Independent simulation of SCT's ``algo=centermass`` semantics (per
    axial slice, translate so the segmentation COMs coincide), applied
    directly with scipy shifts — used to show that the dense
    ``centermass_affine_field`` realizes the same algorithm."""
    from scipy import ndimage

    Z = fx_seg.shape[2]
    out = np.zeros_like(mov_seg)
    last = (0.0, 0.0)
    shifts = [None] * Z
    for z in range(Z):
        f, m = fx_seg[:, :, z], mov_seg[:, :, z]
        if f.sum() > 0 and m.sum() > 0:
            cf = ndimage.center_of_mass(f)
            cm = ndimage.center_of_mass(m)
            shifts[z] = (cf[0] - cm[0], cf[1] - cm[1])
    # nearest-valid fill (matches centermass_affine_field's fill rule)
    valid = [z for z in range(Z) if shifts[z] is not None]
    for z in range(Z):
        if shifts[z] is None and valid:
            near = min(valid, key=lambda v: abs(v - z))
            shifts[z] = shifts[near]
        last = shifts[z] or last
        out[:, :, z] = ndimage.shift(mov_seg[:, :, z], last, order=0)
    return out


def inplane_angle(seg):
    """Mean in-plane principal-axis angle of the cross-sections (degrees) —
    the quantity a translation-only fallback cannot change."""
    angles = []
    for z in range(seg.shape[2]):
        s = seg[:, :, z]
        if s.sum() < 20:
            continue
        ys, xs = np.nonzero(s.T)  # (y, x) index lists
        x = xs - xs.mean()
        y = ys - ys.mean()
        cxx, cyy, cxy = (x * x).mean(), (y * y).mean(), (x * y).mean()
        angles.append(0.5 * np.degrees(np.arctan2(2 * cxy, cxx - cyy)))
    return float(np.mean(angles)) if angles else 0.0


def run(shape=(96, 96, 128), emit=print) -> dict:
    """The six cases on the tube of ``shape`` (seed 3) and the summary."""
    out = {"cases": []}
    fx = make_tube(shape, seed=3)
    ang_fx = inplane_angle(fx)
    for name, ang, axis, shift in CASES:
        mov = rigid_transform(fx, ang, axis, shift)
        row = {"case": name, "dice_before": round(dice(fx, mov), 4)}
        recs = {}
        for mode, fn in (("centermass", centermass_affine_field),
                         ("rigid", rigid_affine_field)):
            field = fn(fx, mov)
            rec = apply_field_host(mov, field)
            recs[mode] = rec
            row[f"dice_after_{mode}"] = round(dice(fx, rec), 4)
            # residual in-plane orientation error vs the fixed tube — the
            # component a translation-only algorithm cannot touch
            row[f"residual_inplane_angle_deg_{mode}"] = round(
                abs(inplane_angle(rec) - ang_fx), 3)
        # parity: the dense centermass field == an independent simulation of
        # SCT's slice-wise COM algorithm
        sct_rec = sct_centermass_simulator(fx, mov)
        row["dice_ours_vs_sct_sim"] = round(dice(recs["centermass"], sct_rec), 4)
        out["cases"].append(row)
        emit(row)

    rot_z = next(r for r in out["cases"] if r["case"] == "rot_z_6deg")
    out["summary"] = {
        "centermass_recovers_translation":
            out["cases"][0]["dice_after_centermass"] > 0.95,
        "centermass_matches_sct_simulation_min_dice":
            min(r["dice_ours_vs_sct_sim"] for r in out["cases"]),
        "inplane_rotation_untouched_by_centermass_deg":
            rot_z["residual_inplane_angle_deg_centermass"],
        "inplane_rotation_after_rigid_deg":
            rot_z["residual_inplane_angle_deg_rigid"],
    }
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    out = run(emit=lambda row: print(row, flush=True))
    write_result(a.out, out)
    print(json.dumps(out["summary"], indent=1))
    return out


if __name__ == "__main__":
    main()
