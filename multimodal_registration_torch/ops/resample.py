"""Affine grid resampling (NIfTI grid -> NIfTI grid).

Counterpart of ``multimodal_registration_tpu/ops/resample.py``:
``resample_nib`` (the reference's header-affine resampling), ``pad_or_crop``
and ``affine_resample``. For each output voxel ``v`` the input is sampled at
``inv(A_in) @ A_out @ v``; channels ride along.

Routes, chosen by the map and the mode, never in response to a failure:

  * the identity map: the input itself; same affine, other shape: a
    ``cval``-filled pad/crop from the origin (exact for every order under
    the 'constant' boundary);
  * orders 0/1: :func:`ops.warp.sample` (kernel K2 on the card);
  * spline orders 2 ('spline2', what ``resample_nib`` calls 'spline') and 3
    ('spline', the postprocess), on the device:
      - a scaled permutation (axis-aligned map): scipy's exact 1-D
        resampling operator per axis, extracted once on the host by running
        scipy on basis vectors, applied as three dense products;
      - any other (oblique) map, modes 'nearest' and 'constant': the 1-D
        prefilter operators the same way, then an ``(order+1)**3``-tap
        B-spline sampler over the coefficient volume, one tap at a time;
  * an oblique spline in another mode: ``scipy.ndimage.affine_transform``
    on the host, as in the JAX package.

Boundaries are scipy's. 'nearest' edge-pads by 12 before the prefilter
(scipy's ``npad``) and clamps taps into the padded coefficients, and it
ignores ``cval``. 'constant' prefilters with the mirror boundary, folds taps
by mirror and sets every output whose coordinate leaves ``[0, n-1]`` on some
axis to ``cval`` (the ``cval=0`` result plus ``cval`` on that mask, by
linearity). The products run in full float32 whatever the caller's TF32
setting (:func:`device.full_fp32_matmuls`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multimodal_registration_torch.device import full_fp32_matmuls, resolve_device
from multimodal_registration_torch.ops.warp import sample
from multimodal_registration_torch.utils import nifti

# 'spline' = cubic (the postprocess 'continuous' parity); 'spline2' =
# quadratic, what the reference's resample_nib means by 'spline'
_ORDER = {"nn": 0, "nearest": 0, "linear": 1, "spline": 3, "spline2": 2}

# scipy edge-pads the input by 12 before the spline prefilter in mode
# 'nearest' (no exact IIR boundary condition there); inherited, not chosen
_SCIPY_SPLINE_NPAD = 12


def pad_or_crop(data: np.ndarray, target_shape, cval=0.0) -> np.ndarray:
    """``nilearn.resample_img(target_affine=same, target_shape=...)``
    parity: with an identical affine, resampling is a ``cval``-filled pad /
    crop anchored at the origin."""
    out = np.full(tuple(target_shape) + data.shape[3:], cval, dtype=data.dtype)
    src = tuple(slice(0, min(s, t)) for s, t in zip(data.shape, target_shape))
    out[src] = data[src]
    return out


def _scaled_permutation(R: np.ndarray, tol: float = 1e-9):
    """If 3x3 ``R`` has exactly one nonzero per row forming a permutation,
    return ``(sigma, scales)`` with ``in_i = scales[i] * out[sigma[i]]``;
    else ``None``."""
    sigma, scales = [], []
    for i in range(3):
        nz = np.flatnonzero(np.abs(R[i]) > tol)
        if len(nz) != 1:
            return None
        sigma.append(int(nz[0]))
        scales.append(float(R[i, nz[0]]))
    if sorted(sigma) != [0, 1, 2]:
        return None
    return sigma, scales


@functools.lru_cache(maxsize=64)
def _spline_axis_operator(n_in: int, n_out: int, scale: float, offset: float,
                          mode: str, order: int = 3) -> np.ndarray:
    """scipy's 1-D spline resampling as a matrix ``W (n_out, n_in)``:
    ``W @ v`` is ``map_coordinates(v, scale * o + offset, order, mode,
    cval=0)``, taken column by column from the basis vectors, so the
    prefilter's boundary conditions and the kernel's edge handling are
    scipy's own."""
    from scipy.ndimage import map_coordinates

    pos = (scale * np.arange(n_out, dtype=np.float64) + offset)[None]
    W = np.empty((n_out, n_in), np.float64)
    e = np.zeros(n_in, np.float64)
    for j in range(n_in):
        e[j] = 1.0
        W[:, j] = map_coordinates(e, pos, order=order, mode=mode, cval=0.0)
        e[j] = 0.0
    return W


@functools.lru_cache(maxsize=64)
def _spline_prefilter_operator(n: int, order: int, mode: str) -> np.ndarray:
    """scipy's 1-D spline prefilter as a matrix: ``(n + 24, n)`` for mode
    'nearest' (the coefficients of the edge-padded input, what scipy's
    ``map_coordinates`` filters), ``(n, n)`` for 'constant' (the mirror
    boundary scipy uses there)."""
    from scipy.ndimage import spline_filter1d

    if mode == "nearest":
        p = _SCIPY_SPLINE_NPAD
        P = np.empty((n + 2 * p, n), np.float64)
        e = np.zeros(n, np.float64)
        for j in range(n):
            e[j] = 1.0
            P[:, j] = spline_filter1d(np.pad(e, p, mode="edge"), order=order, mode="reflect")
            e[j] = 0.0
    else:
        P = np.empty((n, n), np.float64)
        e = np.zeros(n, np.float64)
        for j in range(n):
            e[j] = 1.0
            P[:, j] = spline_filter1d(e, order=order, mode="mirror")
            e[j] = 0.0
    return P


def _apply_axis_operators(vol: torch.Tensor, W0, W1, W2) -> torch.Tensor:
    """``W0``, ``W1``, ``W2`` applied along the three spatial axes of ``vol
    (X, Y, Z[, C])`` (channels ride along), in full float32."""
    with full_fp32_matmuls():
        out = torch.einsum("ai,ijk...->ajk...", W0, vol)
        out = torch.einsum("bj,ajk...->abk...", W1, out)
        return torch.einsum("ck,abk...->abc...", W2, out)


def _bspline_tap_weights(t: torch.Tensor, order: int):
    """First tap index and the ``order + 1`` B-spline weights at positions
    ``t``. scipy's tap placement: odd order starts at ``floor(t) - (order -
    1) // 2``, even order at ``floor(t + 0.5) - order // 2``."""
    if order % 2:
        start = torch.floor(t) - (order - 1) // 2
    else:
        start = torch.floor(t + 0.5) - order // 2
    x = t - start
    ws = []
    for k in range(order + 1):
        u = torch.abs(x - k)
        if order == 3:
            v = 2.0 - u
            w = torch.where(u < 1.0, 2.0 / 3.0 - u * u + 0.5 * u * u * u,
                            torch.where(u < 2.0, v * v * v / 6.0, 0.0))
        elif order == 2:
            v = u - 1.5
            w = torch.where(u < 0.5, 0.75 - u * u, torch.where(u < 1.5, 0.5 * v * v, 0.0))
        else:
            raise ValueError(f"unsupported spline order {order}")
        ws.append(w)
    return start.to(torch.int32), ws


def _fold_tap(idx: torch.Tensor, n: int, ext: str) -> torch.Tensor:
    """Tap indices into ``[0, n-1]``: clamped, or mirrored with period
    ``2n - 2`` (edge not repeated; ``n == 1`` maps to 0)."""
    if ext == "clamp":
        return idx.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(idx)
    p = 2 * n - 2
    m = torch.remainder(idx, p)
    return torch.where(m >= n, p - m, m)


def _oblique_spline(volt: torch.Tensor, M: np.ndarray, out_shape, mode: str, cval: float,
                    order: int) -> torch.Tensor:
    """Oblique map, modes 'nearest' and 'constant': the prefilter as three
    operator products, then the ``(order+1)**3``-tap sampler."""
    dev = volt.device
    npad = _SCIPY_SPLINE_NPAD if mode == "nearest" else 0
    Ps = [torch.as_tensor(_spline_prefilter_operator(int(volt.shape[i]), order, mode),
                          dtype=torch.float32, device=dev) for i in range(3)]
    c = _apply_axis_operators(volt, *Ps)
    nx, ny, nz = c.shape[:3]
    # channels first: a tap gathers C rows of 4-byte values (a gather of
    # 16-byte rows, index_select's, runs at a fraction of the card's rate)
    cf = c.reshape(nx * ny * nz, -1).t().contiguous()  # (C or 1, N)

    # input coordinates: the JAX package's elementwise expression, in its
    # order, in float32 (a matrix product could round otherwise)
    Mj = torch.as_tensor(M, dtype=torch.float32, device=dev)
    ox = torch.arange(out_shape[0], dtype=torch.float32, device=dev)[:, None, None]
    oy = torch.arange(out_shape[1], dtype=torch.float32, device=dev)[None, :, None]
    oz = torch.arange(out_shape[2], dtype=torch.float32, device=dev)[None, None, :]
    coords = [(ox * Mj[a, 0] + oy * Mj[a, 1]) + (oz * Mj[a, 2] + (Mj[a, 3] + npad))
              for a in range(3)]

    ext = "clamp" if mode == "nearest" else "mirror"
    taps, weights = [], []
    for a, n in enumerate((nx, ny, nz)):
        start, w = _bspline_tap_weights(coords[a], order)
        taps.append([_fold_tap(start + i, n, ext) for i in range(order + 1)])
        weights.append(w)
    # one tap at a time: never more than one gathered block alive
    out = torch.zeros((cf.shape[0], *out_shape), dtype=torch.float32, device=dev)
    for i in range(order + 1):
        for j in range(order + 1):
            row = taps[0][i] * ny + taps[1][j]
            wxy = weights[0][i] * weights[1][j]
            for k in range(order + 1):
                out.addcmul_(wxy * weights[2][k], cf[:, row * nz + taps[2][k]])
    if mode == "constant":
        inside = torch.ones(out_shape, dtype=torch.bool, device=dev)
        for a in range(3):
            ca = coords[a] - npad
            inside &= (ca >= 0.0) & (ca <= volt.shape[a] - 1.0)
        out = torch.where(inside, out, torch.full((), float(cval), device=dev))
    return out.movedim(0, -1) if volt.ndim == 4 else out[0]


def spline_on_device(M: np.ndarray, mode: str) -> bool:
    """Whether a spline resample with voxel map ``M`` and ``mode`` runs on
    the device: every axis-aligned map, oblique ones in 'nearest' and
    'constant' (else scipy on the host)."""
    return (_scaled_permutation(np.asarray(M[:3, :3], np.float64)) is not None
            or mode in ("nearest", "constant"))


def device_spline_resample(volt: torch.Tensor, M: np.ndarray, out_shape, mode: str = "constant",
                           cval: float = 0.0, order: int = 3) -> torch.Tensor:
    """Spline resampling of ``volt (X, Y, Z[, C])`` float32 on its device
    (see the module's note) -> float32 ``(*out_shape[, C])``. For a map that
    :func:`spline_on_device` refuses it raises."""
    if not spline_on_device(M, mode):
        raise ValueError(f"an oblique spline in mode {mode!r} runs on the host (scipy)")
    if mode == "nearest":
        cval = 0.0  # scipy ignores cval outside 'constant'
    out_shape = tuple(int(s) for s in out_shape)
    volt = volt.float()
    sp = _scaled_permutation(np.asarray(M[:3, :3], np.float64))
    if sp is None:
        return _oblique_spline(volt, M, out_shape, mode, cval, order)
    sigma, scales = sp
    Ws = [torch.as_tensor(
        _spline_axis_operator(int(volt.shape[i]), out_shape[sigma[i]], scales[i],
                              float(M[i, 3]), mode, order),
        dtype=torch.float32, device=volt.device) for i in range(3)]
    # the products' axes follow the input's, with lengths out_shape[sigma]:
    # output axis q takes product axis i where sigma[i] == q
    perm = tuple(sigma.index(q) for q in range(3)) + ((3,) if volt.ndim == 4 else ())
    out = _apply_axis_operators(volt, *Ws).permute(perm)
    if cval != 0.0:
        # W's rows are zero where the coordinate leaves [0, n-1] (extracted
        # with cval 0); scipy puts cval there, on a separable mask
        inside = torch.ones((), dtype=torch.bool, device=volt.device)
        for q in range(3):
            i = sigma.index(q)
            pos = scales[i] * np.arange(out_shape[q], dtype=np.float64) + float(M[i, 3])
            in_q = torch.as_tensor((pos >= 0.0) & (pos <= volt.shape[i] - 1.0),
                                   device=volt.device)
            inside = inside & in_q.reshape((-1,) + (1,) * (2 - q))
        if volt.ndim == 4:
            inside = inside[..., None]
        out = torch.where(inside, out, torch.full((), float(cval), device=volt.device))
    return out


def affine_resample(vol: np.ndarray, in_affine: np.ndarray, out_affine: np.ndarray,
                    out_shape, interpolation: str = "linear", mode: str = "constant",
                    cval: float = 0.0, device=None, impl=None) -> np.ndarray:
    """Resample ``vol (X, Y, Z[, C])`` from grid ``in_affine`` onto
    ``(out_shape, out_affine)``; channels ride along. Returns float64.
    ``impl`` goes to kernel K2's wrapper (orders 0/1)."""
    order = _ORDER[interpolation]
    out_shape = tuple(int(s) for s in out_shape)
    M = np.linalg.inv(in_affine) @ out_affine
    if np.allclose(M, np.eye(4), rtol=0, atol=1e-9):
        if out_shape == tuple(vol.shape[:3]):
            return np.asarray(vol, np.float64)
        if mode == "constant":
            # integer sample points reproduce the input at every order;
            # points outside [0, n-1] are cval
            return pad_or_crop(np.asarray(vol, np.float64), out_shape, cval)
    dev = resolve_device(device)
    if order >= 2 and not spline_on_device(M, mode):
        return _host_spline(vol, M, out_shape, order, mode, cval)
    volt = torch.as_tensor(np.asarray(vol, np.float32), device=dev)
    if order >= 2:
        out = device_spline_resample(volt, M, out_shape, mode, cval, order)
        return out.cpu().numpy().astype(np.float64)
    Mt = torch.as_tensor(M, dtype=torch.float32, device=dev)
    axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in out_shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    with full_fp32_matmuls():  # TF32 would move samples by ~0.1 voxel
        coords = grid @ Mt[:3, :3].T + Mt[:3, 3]
    out = sample(volt, coords, interp="nearest" if order == 0 else "linear", impl=impl)
    if mode == "constant":
        # scipy's 'constant' boundary for order <= 1: a coordinate strictly
        # outside [0, n-1] on any axis yields cval
        in_dims = torch.tensor(vol.shape[:3], dtype=torch.float32, device=dev) - 1.0
        inside = ((coords >= 0.0) & (coords <= in_dims)).all(dim=-1)
        if out.ndim == 4:
            inside = inside[..., None]
        out = torch.where(inside, out, torch.full_like(out, cval))
    return out.cpu().numpy().astype(np.float64)


def _host_spline(vol, M, out_shape, order, mode, cval) -> np.ndarray:
    """``scipy.ndimage.affine_transform`` per channel, in float64: the
    route of an oblique spline in a mode other than 'nearest'/'constant'."""
    from scipy.ndimage import affine_transform

    def one(v3):
        return affine_transform(np.asarray(v3, np.float64), M[:3, :3], offset=M[:3, 3],
                                output_shape=out_shape, order=order, mode=mode, cval=cval)

    if np.ndim(vol) == 4:
        return np.stack([one(vol[..., c]) for c in range(vol.shape[3])], axis=-1)
    return one(vol)


def resample_nib(image: nifti.NiftiImage, new_size=None, new_size_type=None,
                 image_dest: nifti.NiftiImage | None = None,
                 interpolation: str = "linear", mode: str = "nearest",
                 device=None, impl=None) -> nifti.NiftiImage:
    """Drop-in equivalent of the reference's ``resample_nib``, 3-D and 4-D
    volumes. The reference's 'spline' here is quadratic (order 2)."""
    if interpolation == "spline":
        interpolation = "spline2"
    img = image
    affine = np.array(img.affine, dtype=np.float64)
    affine[3, :] = [0, 0, 0, 1]

    if image_dest is None:
        p = img.header.get_zooms()
        shape = img.shape
        if img.ndim == 4:
            new_size = list(new_size)
            if len(new_size) == 3:
                new_size += ["1"]
        if new_size_type == "vox":
            shape_r = tuple(int(new_size[i]) for i in range(img.ndim))
        elif new_size_type == "factor":
            if len(new_size) == 1:
                new_size = tuple(new_size[0] for _ in range(img.ndim))
            shape_r = tuple(int(np.round(shape[i] * float(new_size[i])))
                            for i in range(img.ndim))
        elif new_size_type == "mm":
            if len(new_size) == 1:
                new_size = tuple(new_size[0] for _ in range(img.ndim))
            shape_r = tuple(int(np.round(shape[i] * float(p[i]) / float(new_size[i])))
                            for i in range(img.ndim))
        else:
            raise ValueError("'new_size_type' is not recognized.")
        R = np.eye(4)
        for i in range(3):
            if shape_r[i] == 0:
                raise ZeroDivisionError(f"Destination size is zero for dimension {i}")
            R[i, i] = img.shape[i] / float(shape_r[i])
        ref_shape, ref_affine = shape_r, affine @ R
    else:
        ref_shape, ref_affine = image_dest.shape[:3], image_dest.affine

    data = img.get_fdata()
    kw = dict(mode=mode, cval=0.0, device=device, impl=impl)
    if img.ndim == 3:
        out = affine_resample(data, affine, ref_affine, ref_shape[:3], interpolation, **kw)
        return nifti.NiftiImage(out.astype(np.float64), ref_affine)
    if img.ndim == 4:
        out4 = np.zeros((*ref_shape[:3], img.shape[3]))
        for t in range(img.shape[3]):
            out4[..., t] = affine_resample(data[..., t], affine, ref_affine,
                                           ref_shape[:3], interpolation, **kw)
        return nifti.NiftiImage(out4, ref_affine)
    raise ValueError(f"unsupported ndim {img.ndim}")
