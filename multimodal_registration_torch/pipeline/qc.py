"""Lightweight QC report generator (HTML + PNG mosaics), the port's copy of
``multimodal_registration_tpu/pipeline/qc.py``.

Parity target: SCT ``sct_qc`` HTML reports invoked per subject
(`pipeline_bids_register_evaluate.sh:159-164`, `README.md:114`): a browsable
page showing, per subject, the fixed volume with the moving/moved volumes,
segmentation overlays, and the warped deformation grid (sct_qc's
registration view) for visual QC.

The panels are drawn here, without matplotlib (which the GPU machines need
not have): what the JAX package's ``imshow`` calls draw, a gray image scaled
to its range, doubled in size (nearest), and where the overlay is nonzero
the ``autumn`` or ``cool`` colour of the overlay scaled to its own range at
alpha 0.5, written as an RGB PNG through ``zlib``.

Thread-safety: ``add_subject`` may be called from ``--jobs N`` worker threads
(`pipeline/batch.py`); it only does numpy work (load + mosaic) and appends
under a lock. The PNGs are made in :meth:`write` on the calling thread.
"""

from __future__ import annotations

import base64
import html
import os
import struct
import threading
import zlib

import numpy as np

from multimodal_registration_torch.utils import nifti


def _mosaic(vol: np.ndarray, n_slices: int = 6, axis: int = 2) -> np.ndarray:
    idx = np.linspace(0, vol.shape[axis] - 1, n_slices + 2, dtype=int)[1:-1]
    slices = [np.take(vol, i, axis=axis).T[::-1] for i in idx]
    return np.concatenate(slices, axis=1)


def _lut(v: np.ndarray) -> np.ndarray:
    """A colour map's 256-entry table index of ``v`` in [0, 1], as a fraction."""
    return np.minimum(np.floor(np.clip(v, 0.0, 1.0) * 256.0), 255.0) / 255.0


def _normalized(a: np.ndarray) -> np.ndarray:
    """``a`` scaled to [0, 1] by its own range (0 where the range is empty)."""
    lo, hi = float(a.min()), float(a.max())
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


# the overlay colour maps: value in [0, 1] -> (r, g, b)
_CMAPS = {
    "autumn": lambda v: (np.ones_like(v), v, np.zeros_like(v)),
    "cool": lambda v: (v, 1.0 - v, np.ones_like(v)),
}


def _png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb (H, W, 3) uint8``, each row filter 0."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _png_b64(img: np.ndarray, overlay: np.ndarray | None = None,
             overlay_cmap: str = "autumn") -> str:
    g = _lut(_normalized(np.asarray(img, np.float64)))
    rgb = np.stack([g, g, g], -1)
    if overlay is not None:
        overlay = np.asarray(overlay, np.float64)
        mask = overlay != 0
        if mask.any():
            v = np.zeros_like(overlay)
            v[mask] = _normalized(overlay[mask])
            col = np.stack(_CMAPS[overlay_cmap](_lut(v)), -1)
            rgb = np.where(mask[..., None], 0.5 * col + 0.5 * rgb, rgb)
    rgb = np.rint(rgb * 255.0).astype(np.uint8).repeat(2, 0).repeat(2, 1)
    return base64.b64encode(_png(rgb)).decode()


def make_grid_volume(shape, spacing: int = 8) -> np.ndarray:
    """In-plane gridline volume: x/y lattice planes (axial slices show a 2-D
    grid; warping it visualizes the deformation like sct_qc's grid view)."""
    g = np.zeros(shape, np.float32)
    g[::spacing, :, :] = 1.0
    g[:, ::spacing, :] = 1.0
    return g


def warped_grid_mosaic(warp_data: np.ndarray, scale: int, shape,
                       n_slices: int = 6, spacing: int = 8) -> np.ndarray:
    """Mosaic of the warped gridline volume, computed analytically on host.

    Equal to mosaicking :func:`make_grid_volume` warped by the full-res
    field, without the device round trip of a full-res volume for a QC
    panel: the gridline volume is z-invariant and separable, so its linear
    interpolation at warped coordinates has the closed form ``A + B - A*B``
    with A/B the tent distance to the nearest lattice plane, evaluated only
    at the displayed slices.
    """
    from scipy.ndimage import map_coordinates

    X, Y, Z = [int(s) for s in shape[:3]]
    idx = np.linspace(0, Z - 1, n_slices + 2, dtype=int)[1:-1]
    GX, GY = np.meshgrid(np.arange(X, dtype=np.float64),
                         np.arange(Y, dtype=np.float64), indexing="ij")

    def tent(p, n):
        # nearest lattice plane, restricted to planes that exist in [0, n)
        near = spacing * np.round(p / spacing)
        near = np.clip(near, 0, ((n - 1) // spacing) * spacing)
        return np.clip(1.0 - np.abs(p - near), 0.0, 1.0)

    panels = []
    w = np.asarray(warp_data, np.float32)
    for k in idx:
        # int-res field sampled at the full-res slice (corner-aligned: q/scale)
        coords = np.stack([GX / scale, GY / scale,
                           np.full_like(GX, k / scale)], 0)
        phix = map_coordinates(w[..., 0], coords, order=1, mode="nearest") * scale
        phiy = map_coordinates(w[..., 1], coords, order=1, mode="nearest") * scale
        px = np.clip(GX + phix, 0, X - 1)  # edge-clamped like the device warp
        py = np.clip(GY + phiy, 0, Y - 1)
        A, B = tent(px, X), tent(py, Y)
        g = A + B - A * B
        panels.append(g.T[::-1])
    return np.concatenate(panels, axis=1).astype(np.float32)


class QCReport:
    def __init__(self, qc_dir: str, title: str = "Registration QC"):
        self.qc_dir = qc_dir
        self.title = title
        self.entries = []
        self._lock = threading.Lock()
        os.makedirs(qc_dir, exist_ok=True)

    def add_subject(
        self,
        subject: str,
        fixed_path: str,
        moving_path: str,
        moved_path: str,
        seg_paths: dict | None = None,
        metrics: dict | None = None,
        warped_grid: np.ndarray | None = None,
        grid_mosaic: np.ndarray | None = None,
    ):
        """Collect mosaics for one subject (numpy only — thread-safe).

        ``grid_mosaic``: precomputed warped-gridline mosaic (the cheap
        :func:`warped_grid_mosaic` path). ``warped_grid``: a full warped
        gridline VOLUME (legacy path, mosaicked here).
        """
        panels = []  # (name, img_mosaic, overlay_mosaic | None, overlay_cmap)
        segs = seg_paths or {}
        moved_mosaic = None
        for name, path in [("fixed", fixed_path), ("moving", moving_path), ("moved", moved_path)]:
            vol = nifti.load(path, cached=True).get_fdata(np.float32)
            # display normalization from a stride-2 subsample — percentile
            # sorts 4.9M f64 voxels otherwise, for a QC brightness window
            lo, hi = np.percentile(vol[::2, ::2, ::2], [1, 99])
            vol = np.clip((vol - lo) / max(hi - lo, 1e-9), 0, 1)
            m = _mosaic(vol)
            if name == "moved":
                moved_mosaic = m
            overlay = None
            if name in segs:
                # through ``load``, not the filesystem: under write-behind a
                # segmentation may not have landed yet
                try:
                    overlay = _mosaic(nifti.load(segs[name], cached=True).get_fdata())
                except FileNotFoundError:
                    overlay = None
            panels.append((name, m, overlay, "autumn"))
        if grid_mosaic is None and warped_grid is not None:
            grid_mosaic = _mosaic(np.asarray(warped_grid, np.float32))
        if grid_mosaic is not None and moved_mosaic is not None:
            grid_m = (np.asarray(grid_mosaic) > 0.3).astype(np.float32)
            panels.append(("moved + deformation grid", moved_mosaic, grid_m, "cool"))
        with self._lock:
            self.entries.append(
                {"subject": subject, "panels": panels, "metrics": metrics or {}}
            )

    def write(self) -> str:
        rows = []
        with self._lock:
            entries = sorted(self.entries, key=lambda e: e["subject"])
        for e in entries:
            imgs = "".join(
                f"<figure><figcaption>{html.escape(n)}</figcaption>"
                f'<img src="data:image/png;base64,{_png_b64(m, ov, cm)}"/></figure>'
                for n, m, ov, cm in e["panels"]
            )
            mets = "".join(
                f"<li>{html.escape(str(k))}: {html.escape(f'{v:.4f}' if isinstance(v, float) else str(v))}</li>"
                for k, v in e["metrics"].items()
            )
            rows.append(
                f"<section><h2>{html.escape(e['subject'])}</h2>{imgs}<ul>{mets}</ul></section>"
            )
        doc = (
            "<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(self.title)}</title>"
            "<style>body{font-family:sans-serif;background:#111;color:#eee}"
            "img{max-width:100%;display:block}figure{margin:4px 0}"
            "section{border-bottom:1px solid #444;padding:8px 0}</style>"
            f"</head><body><h1>{html.escape(self.title)}</h1>{''.join(rows)}</body></html>"
        )
        out = os.path.join(self.qc_dir, "index.html")
        with open(out, "w") as f:
            f.write(doc)
        return out
