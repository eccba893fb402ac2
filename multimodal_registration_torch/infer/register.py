"""Single-model registration flow: preprocess -> model -> field assembly ->
NIfTI postprocess.

Counterpart of ``multimodal_registration_tpu/infer/register.py``, with the
same output-file names (``*_proc``, ``*_proc_reg_to_<CONTRAST>``,
``*_proc_field_to_<CONTRAST>`` with NIfTI intent 1007, and the moved image
and field on the original moving grid), the same RAI export of the field and
the same ``timings`` keys. :meth:`Registrar.register_tensors` registers one
pair already on the device as the config says; with ``use_subvol`` it cuts
the tiles on the device, runs them through the model in chunks of
``max_batch``, blends their fields (:mod:`infer.blend`) and warps the whole
moving volume, and ``register()`` calls it. Everything runs on ``cuda``
unless the ``Registrar`` was built with ``device="cpu"``; a ``Registrar`` built with
``impl="plain"`` runs every kernel's plain version instead (the comparison
of ``chip_smoke.py``). With ``quantize: "int8"`` the registrar takes its
activation scales from ``quant_scales`` or calibrates them on the first
chunk it predicts, and writes them to ``quant_sidecar`` if given.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.infer.blend import blend_subvol_fields
from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.preprocess import preprocess, subvol_grid
from multimodal_registration_torch.models import quantize as qmod
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.ops.resample import affine_resample
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp as device_warp
from multimodal_registration_torch.utils import nifti
from multimodal_registration_torch.utils.graphs import ForwardGraphs, static_copy
from multimodal_registration_torch.utils.profiling import span


def vxm_config_from(cfg: InferenceConfig, svf_smooth_sigma: float | None = None) -> VxmConfig:
    """The model config an :class:`InferenceConfig` maps to;
    ``svf_smooth_sigma`` overrides the config's (the cascade's first step)."""
    return VxmConfig(
        enc=tuple(cfg.enc),
        dec=tuple(cfg.dec),
        int_steps=cfg.int_steps,
        int_res=cfg.int_res,
        svf_res=cfg.svf_res,
        compute_dtype=cfg.compute_dtype,
        svf_smooth_sigma=float(
            (cfg.svf_smooth_sigma if svf_smooth_sigma is None else svf_smooth_sigma) or 0.0),
        quantize=str(cfg.quantize or ""),
    )


def persist_quant_sidecar(path: str, quant) -> bool:
    """Best-effort write of lazily calibrated int8 scales to the checkpoint's
    ``<model>.quant.json``, so the calibration forward is paid once per
    checkpoint, not once per process. Never raises: a read-only checkpoint
    directory only costs a calibration in the next process."""
    if not path or not quant:
        return False
    try:
        qmod.save_scales(path, quant)
        return True
    except OSError as e:
        warnings.warn(f"could not persist int8 scales to {path}: {e}")
        return False


def on_device(x, dev) -> torch.Tensor:
    """``x`` (array or tensor) as float32 on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


class Registrar:
    """Holds the model on its device. Batches larger than ``max_batch`` (the
    tiles of a subject) run in chunks of ``max_batch`` pairs, the last one
    zero-padded, so every call sees the same shapes and activation memory
    stays bounded. ``svf_smooth_sigma`` overrides the config's (the
    cascade's first model); ``impl`` goes to every kernel wrapper the
    registration runs (``None``: the kernels on the card, ``"plain"``:
    their plain versions). int8 scales: ``quant_scales`` (flat, as
    ``models/quantize.py::load_scales`` gives them) or, when None, calibrated
    on the first chunk predicted (one full-precision forward; every output
    comes from the int8 path) and written to ``quant_sidecar``.
    ``tile_counts`` adds up the tiles :meth:`register_tensors` registered
    (``tiles``) and the forward slots they took, padding included
    (``slots``).

    On the card with ``impl=None`` the forwards of :meth:`predict_tensors`
    run as CUDA graphs once the int8 scales are set (``utils/graphs.py::
    ForwardGraphs``): a shape's first forward eager, its second captured,
    later ones replayed. Its key is the chunk's shape and type,
    ``with_moved``, the scales' version and the stream; a change of the
    parameters or the scales drops every key. ``graph_counts`` counts the
    forwards by how they ran (``captures``, ``replays``, ``eager``)."""

    def __init__(self, cfg: InferenceConfig, params: dict, max_batch: int = 4,
                 device=None, svf_smooth_sigma: float | None = None, impl=None,
                 quant_scales=None, quant_sidecar: str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vxm_cfg = vxm_config_from(cfg, svf_smooth_sigma)
        self.model = VxmDense(self.vxm_cfg, device=self.device).eval()
        self.model.load_state_dict(params)
        self.max_batch = max_batch
        self.impl = impl
        self.quant_scales = quant_scales
        self.quant_sidecar = quant_sidecar
        if self.vxm_cfg.quantize and quant_scales is not None:
            self.model.set_quant_scales(quant_scales)
        self.tile_counts = {"tiles": 0, "slots": 0}
        self.graphs = ForwardGraphs(self.device, self.model.parameters)
        self.graph_counts = self.graphs.counts

    def _chunk(self, batch: int) -> int:
        """Pairs a forward takes when ``batch`` pairs are predicted."""
        return min(self.max_batch, batch)

    def _ensure_scales(self, m, f):
        if not self.vxm_cfg.quantize or self.quant_scales is not None:
            return
        with span("registrar.calibrate"):
            self.quant_scales = qmod.calibrate_scales(self.vxm_cfg, self.model,
                                                      [(m[..., None], f[..., None])],
                                                      impl=self.impl)
            self.model.set_quant_scales(self.quant_scales)
            persist_quant_sidecar(self.quant_sidecar, self.quant_scales)

    @torch.inference_mode()
    def predict_tensors(self, mov, fx, with_moved: bool = True):
        """Batched predict on ``(B, X, Y, Z)`` arrays or tensors -> ``(moved,
        warp)`` on the device: ``(B, X, Y, Z)`` and the int-res field ``(B,
        x, y, z, 3)``. With ``with_moved=False`` the forward computes
        neither the moved images nor the full-res fields, and ``moved`` is
        None."""
        with span("registrar.predict_tensors"):
            with span("registrar.to_device"):
                mov, fx = on_device(mov, self.device), on_device(fx, self.device)
            B = mov.shape[0]
            chunk = self._chunk(B)
            moved = warp = None
            for s in range(0, B, chunk):
                m, f = mov[s: s + chunk], fx[s: s + chunk]
                n = m.shape[0]
                if n < chunk:
                    pad = torch.zeros((chunk - n, *m.shape[1:]), device=self.device)
                    m, f = torch.cat([m, pad]), torch.cat([f, pad])
                self._ensure_scales(m, f)
                out = self._forward(m[..., None], f[..., None], with_moved)
                # copied out: a replay's outputs are overwritten by the next one
                if warp is None:
                    warp = out["warp"].new_empty((B, *out["warp"].shape[1:]))
                    moved = mov.new_empty(mov.shape) if with_moved else None
                warp.narrow(0, s, n).copy_(out["warp"][:n])
                if with_moved:
                    moved.narrow(0, s, n).copy_(out["moved"][:n, ..., 0])
            return moved, warp

    def _forward(self, m, f, with_moved: bool) -> dict:
        """The model's forward of one chunk ``(B, X, Y, Z, 1)``, through the
        registrar's CUDA graphs where they apply."""
        def forward():
            mv = static_copy("moving", m) if with_moved else m
            return self.model(mv, f, impl=self.impl, with_moved=with_moved,
                              with_fullres=with_moved)

        key = self._graph_key(m, f, with_moved)
        state = None if key is None else self._graph_state()
        return self.graphs.run(None if state is None else key, state, forward)

    def _graph_key(self, m, f, with_moved: bool):
        """The forward's key, or None where graphs do not apply: off the card,
        with ``impl`` set, outside ``inference_mode``, while the int8 scales
        are calibrating or missing, or inside another graph's capture."""
        if (self.device.type != "cuda" or self.impl is not None
                or not torch.is_inference_mode_enabled()
                or any(b.calibrating or b.amax is None
                       for b in self.model.quant_blocks().values())
                or torch.cuda.is_current_stream_capturing()):
            return None
        return (tuple(m.shape), m.dtype, f.dtype, with_moved, self.model.quant_version,
                torch.cuda.current_stream(self.device).cuda_stream)

    def _graph_state(self):
        """What every key's graphs read besides their inputs: the scales'
        version and the parameters' addresses and versions; None for
        parameters made under ``inference_mode``, whose writes no version
        counts (no graphs then)."""
        params = tuple(self.model.parameters())
        if any(p.is_inference() for p in params):
            return None
        return self.model.quant_version, tuple((p.data_ptr(), p._version) for p in params)

    @torch.inference_mode()
    def register_tensors(self, mov, fx, cfg: InferenceConfig | None = None):
        """Register one ``(X, Y, Z)`` pair (arrays or tensors) as the config
        says (``cfg``'s ``use_subvol``, tiling and interpolation; default: the
        registrar's) -> ``(moved, field, scale)`` on the device: the moved volume
        ``(X, Y, Z)``, the field at ``1/scale`` resolution and ``scale``.
        Without ``use_subvol``: :meth:`predict_tensors` of the pair (with
        nearest interpolation the volume warped again by the field). With
        it, nothing leaves the device: the tiles of
        :func:`infer.preprocess.subvol_grid` are cut, their fields predicted in chunks of ``max_batch`` without
        moved images, blended (:func:`blend_tiles`), and the whole moving
        volume is warped by the blended field (:func:`warp_volume`)."""
        with span("registrar.register_tensors"):
            cfg = cfg or self.cfg
            mov, fx = on_device(mov, self.device), on_device(fx, self.device)
            interp = warp_interp_of(cfg)
            if not cfg.use_subvol:
                moved, warp = self.predict_tensors(mov[None], fx[None])
                warp = warp[0]
                scale = 1 if warp.shape[0] == mov.shape[0] else 2
                if interp == "linear":
                    return moved[0], warp, scale
                with span("registrar.warp_volume"):
                    return warp_volume(mov, warp, interp, scale, self.impl), warp, scale
            tile, coords = subvol_grid(cfg, tuple(mov.shape))
            with span("registrar.cut"):
                cuts = [tuple(slice(co[2 * a], co[2 * a + 1]) for a in range(3))
                        for co in coords]
                mov_t = torch.stack([mov[c] for c in cuts])
                fx_t = torch.stack([fx[c] for c in cuts])
            _, warps = self.predict_tensors(mov_t, fx_t, with_moved=False)
            chunk = self._chunk(len(coords))
            self.tile_counts["tiles"] += len(coords)
            self.tile_counts["slots"] += -(-len(coords) // chunk) * chunk
            with span("registrar.blend"):
                field, scale = blend_tiles(warps, coords, mov.shape, tile)
            with span("registrar.warp_volume"):
                moved = warp_volume(mov, field, interp, scale, self.impl)
            return moved, field, scale

    def register_launches(self, shape, cfg: InferenceConfig | None = None) -> dict:
        """What one :meth:`register_tensors` of a pair of ``shape`` launches
        on the card once the int8 scales are set (as
        ``VxmDense.kernel_launches``): with ``use_subvol`` each chunk's
        forward without a moved image, and one general warp (K2) of the
        volume; without it the forward, and K2 once more with nearest
        interpolation."""
        cfg = cfg or self.cfg
        if not cfg.use_subvol:
            out = self.model.kernel_launches()
            chunks = 1
            extra = int(warp_interp_of(cfg) != "linear")
        else:
            n = len(subvol_grid(cfg, tuple(shape))[1])
            chunks = -(-n // self._chunk(n))
            out = self.model.kernel_launches(with_moved=False)
            extra = 1
        out = {k: chunks * v for k, v in out.items()}
        if extra:
            out["warp_trilinear"] += 1
            out["warp_launch"] = out.get("warp_launch", 0) + 1
        return out

    def predict(self, mov, fx):
        """:meth:`predict_tensors` as numpy arrays on the host."""
        with span("registrar.predict"):
            moved, warp = self.predict_tensors(mov, fx)
            with span("registrar.to_host"):
                return moved.cpu().numpy(), warp.cpu().numpy()


def warp_volume(vol: torch.Tensor, field: torch.Tensor, interp: str, rescale: int = 1,
                impl=None) -> torch.Tensor:
    """``vxm.networks.Transform(rescale=...)`` parity on the device: upsample
    the field by ``rescale`` (scaling vectors), then warp ``vol`` by it."""
    if rescale != 1:
        field = rescale_field(field, int(rescale), out_shape=tuple(vol.shape[:3]))
    return device_warp(vol, field, interp=interp, impl=impl)


@torch.inference_mode()
def apply_warp(vol, field, interp: str, rescale: int = 1, device=None,
               impl=None) -> np.ndarray:
    """:func:`warp_volume` of arrays or tensors on ``device``; the result
    on the host."""
    dev = resolve_device(device)
    return warp_volume(on_device(vol, dev), on_device(field, dev), interp, rescale,
                       impl).cpu().numpy()


def _upsample2x_host(v: np.ndarray) -> np.ndarray:
    """Numpy twin of the corner-aligned 2x upsample (``ops/resize.py``) over
    the three spatial axes of an ``(X, Y, Z, C)`` field."""
    for ax in (2, 1, 0):
        nxt = np.concatenate(
            [np.take(v, range(1, v.shape[ax]), axis=ax),
             np.take(v, [v.shape[ax] - 1], axis=ax)], axis=ax)
        mid = (0.5 * (v + nxt)).astype(v.dtype)
        v = np.stack([v, mid], axis=ax + 1).reshape(
            *v.shape[:ax], 2 * v.shape[ax], *v.shape[ax + 1:])
    return v


def _export_warp_host(warp_data, scale, perm, inv):
    """Full-res field (for ``scale`` 1 or 2) with the RAI component
    permutation and sign flips, on the host: the field is already there."""
    w = np.asarray(warp_data, np.float32)
    if scale == 2:
        w = _upsample2x_host(w) * np.float32(scale)
    elif scale != 1:
        raise ValueError(f"field export supports scale 1 or 2, got {scale}")
    return np.stack([np.float32(inv[i]) * w[..., perm[i]] for i in range(3)], axis=-1)


def postprocess_and_save(warp_data: np.ndarray, scale: int, fixed_proc: nifti.NiftiImage,
                         fixed_nii: nifti.NiftiImage, moving_nii: nifti.NiftiImage,
                         moved: np.ndarray, paths: dict, timings: dict | None = None,
                         device=None):
    """Shared output stage (``bids_registration.py:387-429``)."""
    _t = [time.time()]

    def _mk(key):
        if timings is not None:
            now = time.time()
            timings[key] = round(now - _t[0], 3)
            _t[0] = now

    if "moved_proc" in paths:
        nifti.save(nifti.NiftiImage(np.asarray(moved, np.float32), fixed_proc.affine),
                   paths["moved_proc"])
    _mk("postprocess.save_moved_proc")

    # RAI permutation / sign flips for sct_apply_transfo
    fx_orient = list(nifti.aff2axcodes(-np.asarray(fixed_nii.affine)))
    opposite = {"L": "R", "R": "L", "A": "P", "P": "A", "I": "S", "S": "I"}
    perm, inversion = [0, 1, 2], [1, 1, 1]
    for i, ch in enumerate("RAI"):
        if ch in fx_orient:
            perm[i] = fx_orient.index(ch)
        else:
            perm[i] = fx_orient.index(opposite[ch])
            inversion[i] = -1

    warp_rai = _export_warp_host(warp_data, int(scale), perm, inversion)
    warp_exp = warp_rai[:, :, :, None, :]  # add the time axis
    _mk("postprocess.field_export")

    moved_orig = warp_orig = None
    if "moved_orig" in paths or "warp_orig" in paths:
        M = np.linalg.inv(fixed_proc.affine) @ moving_nii.affine
        identity = tuple(moving_nii.shape[:3]) == tuple(np.shape(moved)[:3]) and np.allclose(
            M, np.eye(4), rtol=0, atol=1e-9)
        if identity:
            moved_orig = np.asarray(moved, np.float64)
            warp_orig = warp_exp
        else:
            stacked = np.concatenate([np.asarray(moved, np.float32)[..., None], warp_rai], axis=-1)
            res = affine_resample(stacked, fixed_proc.affine, moving_nii.affine,
                                  moving_nii.shape[:3], "spline", device=device)
            moved_orig = res[..., 0]
            warp_orig = np.ascontiguousarray(res[..., 1:], dtype=np.float32)[:, :, :, None, :]
    _mk("postprocess.resample_orig")

    if "moved_orig" in paths:
        nifti.save(nifti.NiftiImage(moved_orig.astype(nifti.output_dtype()), moving_nii.affine),
                   paths["moved_orig"])
    _mk("postprocess.save_moved_orig")

    warp_img = nifti.NiftiImage(warp_exp, fixed_proc.affine)
    warp_img.header["intent_code"] = 1007
    if "warp_proc" in paths:
        nifti.save(warp_img, paths["warp_proc"])
    _mk("postprocess.save_warp_proc")

    if "warp_orig" in paths:
        warp_orig_img = nifti.NiftiImage(np.asarray(warp_orig, np.float32), moving_nii.affine)
        warp_orig_img.header["intent_code"] = 1007
        nifti.save(warp_orig_img, paths["warp_orig"])
    _mk("postprocess.save_warp_orig")
    return moved_orig, warp_exp


def warp_interp_of(cfg: InferenceConfig) -> str:
    """The config's warp interpolation; anything but nearest is linear."""
    return cfg.warp_interpolation if cfg.warp_interpolation in ("linear", "nearest") else "linear"


def blend_tiles(warps, coords, mov_shape, model_in_shape, device=None):
    """Blend per-tile fields ``(T, ...)`` into one ``(X, Y, Z, 3)`` field on
    the device -> ``(field, scale)``. Half-resolution tiles (scale 2) blend
    on the halved volume, tile and coordinates (integer ``// 2``)."""
    model_in, mshape, cds = list(model_in_shape), list(mov_shape), list(coords)
    if warps.shape[1] != model_in_shape[0]:
        scale = 2
        model_in = [s // 2 for s in model_in]
        mshape = [s // 2 for s in mshape]
        cds = [tuple(c // 2 for c in co) for co in cds]
    else:
        scale = 1
    return blend_subvol_fields(tuple(model_in), tuple(mshape), cds, warps, device=device), scale


def tiles_of(pre):
    """The stacked ``(fixed, moving)`` tiles of a preprocessed pair."""
    return np.stack(pre.subvols_fx), np.stack(pre.subvols_mov)


def _infer_fields_single(cfg, registrar, pre):
    """Run the model; return (moved_proc, warp_data, scale) on the host."""
    moved, warp_data, scale = registrar.register_tensors(pre.moving.get_fdata(),
                                                         pre.fixed.get_fdata(), cfg)
    return moved.cpu().numpy(), warp_data.cpu().numpy(), scale


def register(cfg: InferenceConfig, registrar: Registrar, fx_im_path: str, mov_im_path: str,
             fx_contrast: str = "T1w", naming: str = "bids", res_dir: str = "res",
             out_im_name: str = "warped_im", out_field_name: str = "deform_field",
             fixed_nii: "nifti.NiftiImage | None" = None,
             moving_nii: "nifti.NiftiImage | None" = None):
    """Register moving -> fixed and write the reference's output files.

    ``naming='bids'`` mirrors ``bids_registration.py``; ``'standalone'``
    mirrors ``3d_reg.py`` (moved image and field in original space go into
    ``res_dir``). Runs on the registrar's device.
    """
    timings = {}
    t = [time.time()]

    def _mark(phase):
        now = time.time()
        timings[phase] = round(now - t[0], 3)
        t[0] = now

    if fixed_nii is None:
        fixed_nii = nifti.load(fx_im_path)
    if moving_nii is None:
        moving_nii = nifti.load(mov_im_path)
    fx_stem = fx_im_path.split(".")[0]
    mov_stem = mov_im_path.split(".")[0]
    _mark("load")

    pre = preprocess(cfg, fixed_nii, moving_nii, device=registrar.device, impl=registrar.impl)
    _mark("preprocess")
    nifti.save(pre.fixed, f"{fx_stem}_proc.nii.gz")
    nifti.save(pre.moving, f"{mov_stem}_proc.nii.gz")
    _mark("save_proc")

    moved, warp_data, scale = _infer_fields_single(cfg, registrar, pre)
    _mark("predict")

    paths = {
        "moved_proc": f"{mov_stem}_proc_reg_to_{fx_contrast}.nii.gz",
        "warp_proc": f"{mov_stem}_proc_field_to_{fx_contrast}.nii.gz",
    }
    if naming == "bids":
        paths["moved_orig"] = f"{mov_stem}_reg_original_dim.nii.gz"
        paths["warp_orig"] = f"{mov_stem}_warp_original_dim.nii.gz"
    else:
        os.makedirs(res_dir, exist_ok=True)
        paths["moved_orig"] = os.path.join(res_dir, f"{out_im_name}.nii.gz")
        paths["warp_orig"] = os.path.join(res_dir, f"{out_field_name}.nii.gz")

    moved_orig, warp_exp = postprocess_and_save(
        warp_data, scale, pre.fixed, fixed_nii, moving_nii, moved, paths,
        timings=timings, device=registrar.device)
    _mark("postprocess")
    return {
        "moved": moved,
        "moved_orig": moved_orig,
        "warp": warp_exp,
        "warp_data": warp_data,
        "paths": paths,
        "scale": scale,
        "timings": timings,
    }


def load_params_any(path: str, cfg: InferenceConfig) -> dict:
    """Model weights for the port from a flat ``.npz`` checkpoint of the JAX
    package or a Keras VoxelMorph ``.h5`` (state dict on the CPU;
    ``Registrar`` moves it)."""
    vxm_cfg = vxm_config_from(cfg)
    if path.endswith((".h5", ".hdf5")):
        from multimodal_registration_torch.models.h5_import import import_keras_vxm_h5

        try:
            return import_keras_vxm_h5(path, vxm_cfg)
        except (KeyError, ValueError) as e:
            raise _arch_hint(path, cfg, e) from e
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path!r}: only .npz checkpoints load in the port; Orbax checkpoint "
            "directories are not read by the port: use the flat .npz written beside them")
    with np.load(path) as z:
        flat = dict(z)
    try:
        return params_from_jax(flat, vxm_cfg)
    except (KeyError, ValueError) as e:
        raise _arch_hint(path, cfg, e) from e


def _arch_hint(path: str, cfg: InferenceConfig, e: Exception) -> ValueError:
    return ValueError(
        f"checkpoint {path!r} does not match the config's architecture "
        f"(enc={list(cfg.enc)}, dec={list(cfg.dec)}) — point --config-path "
        f"at the config this model was trained/exported with. Underlying "
        f"error: {e}")
