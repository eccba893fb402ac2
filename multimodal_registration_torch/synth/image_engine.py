"""SynthMorph grayscale-image engine, on the device.

Counterpart of ``multimodal_registration_tpu/synth/image_engine.py``
(``ne.models.labels_to_image`` as the reference configures it):

  1. draw a random SVF (Perlin noise at relative resolution ``vel_res``, std
     ~ U(0, ``vel_std``)), integrate it by scaling and squaring, and warp the
     label map: the soft (trilinear one-hot) map and the hard (nearest) labels
     from one launch of kernel K6;
  2. per-label Gaussian intensities, means ~ U(25, 225), stds ~ U(5, 25),
     the background zeroed with probability ``zero_background``;
  3. Gaussian blur with std ~ U(0, ``blur_std``);
  4. multiplicative bias field ``exp(perlin(bias_res, U(0, bias_std)))``;
  5. min-max normalisation to [0, 1];
  6. gamma augmentation ``img ** exp(N(0, gamma))``.

Returns ``(image, soft one-hot map of the warped labels)``.

Random numbers: :func:`draw_engine_randoms` draws everything one sample
needs from a ``torch.Generator``; the ``labels_to_image*`` functions compute
from those draws (``randoms=``) or draw them themselves (``gen=``). The
parity tests hand the computing part the arrays that the JAX engine drew.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from multimodal_registration_torch.ops.integrate import integrate_svf
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_labels_soft_hard
from multimodal_registration_torch.synth.perlin import (
    draw_perlin_randoms,
    perlin_from_randoms,
)


@dataclass(frozen=True)
class ImageEngineConfig:
    """Key names follow ``config/config.json``."""

    num_labels: int = 26
    vel_std: float = 3.0
    # relative resolution(s) of the SVF noise: a scalar draws one Perlin
    # scale, a tuple one component per scale, summed
    vel_res: float | tuple = 16.0
    bias_std: float = 0.3
    bias_res: float = 40.0
    blur_std: float = 1.0  # max blur std
    gamma: float = 0.25    # gamma std
    mean_min: float = 25.0
    mean_max: float = 225.0
    std_min: float = 5.0
    std_max: float = 25.0
    zero_background: float = 0.2
    int_steps: int = 5
    # resolution divisor for drawing and integrating the synthesis SVF: the
    # noise lives at relative resolution vel_res, far coarser than this grid
    svf_int_res: int = 2
    integrate_payload_dtype: str = "bfloat16"
    blur_radius: int = 3  # static kernel radius (>= 3 * blur_std)

    def __post_init__(self):
        if isinstance(self.vel_res, (list, tuple)):
            object.__setattr__(self, "vel_res", tuple(float(s) for s in self.vel_res))


def _blur_kernel(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    sig = torch.clamp(sigma, min=1e-4)
    k = torch.exp(-0.5 * (x / sig) ** 2)
    return k / k.sum()


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, radius: int,
                   first_axis: int = 0) -> torch.Tensor:
    """Separable zero-padded ("same") 3-D Gaussian blur over the three axes
    starting at ``first_axis``, as ``2 * radius + 1`` shifted multiply-adds
    per axis, summed in tap order. ``sigma`` is a scalar tensor."""
    k = _blur_kernel(sigma, radius)
    out = img
    for axis in range(first_axis, first_axis + 3):
        n = out.shape[axis]
        pad = [0, 0] * out.ndim
        pad[2 * (out.ndim - 1 - axis)] = pad[2 * (out.ndim - 1 - axis) + 1] = radius
        p = F.pad(out, pad)
        acc = None
        for d in range(2 * radius + 1):
            term = k[d] * p.narrow(axis, d, n)
            acc = term if acc is None else acc + term
        out = acc
    return out


def _vel_scales(cfg: ImageEngineConfig, r: float = 1.0):
    res = cfg.vel_res
    if isinstance(res, (int, float)):
        res = (res,)
    return [float(s) / r for s in res]


def payload_dtype(cfg: ImageEngineConfig):
    """The integration's payload type (``None`` = float32)."""
    return getattr(torch, cfg.integrate_payload_dtype) if cfg.integrate_payload_dtype else None


def reduced_svf_grid(shape, cfg: ImageEngineConfig):
    """The reduced integration grid for ``shape``, or ``None`` when the
    engine integrates at full resolution (``svf_int_res`` 1 or no divisor)."""
    r = max(int(cfg.svf_int_res), 1)
    if cfg.vel_std > 0 and r > 1 and all(s % r == 0 for s in shape):
        return tuple(s // r for s in shape)
    return None


def _svf_grid(shape, cfg: ImageEngineConfig):
    """``(grid, r)``: the grid the SVF is drawn on and its divisor."""
    small = reduced_svf_grid(shape, cfg)
    return (small, max(int(cfg.svf_int_res), 1)) if small is not None else (tuple(shape), 1)


def draw_engine_randoms(gen: torch.Generator, shape, cfg: ImageEngineConfig,
                        device=None) -> dict:
    """Every random number one sample of the engine needs. Keys: ``svf``
    (Perlin draws on the SVF grid, if ``vel_std > 0``), ``means`` and
    ``stds`` (uniform ``(L,)`` in their ranges), ``zero_bg`` (uniform scalar),
    ``noise`` (unit normal ``shape``), ``blur`` (the blur's std, uniform in
    [0, ``blur_std``)),
    ``bias`` (Perlin draws), ``gamma`` (unit normal scalar)."""
    shape = tuple(int(s) for s in shape)
    L = cfg.num_labels

    def uniform(size, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=device)

    r = {}
    if cfg.vel_std > 0:
        grid, div = _svf_grid(shape, cfg)
        r["svf"] = draw_perlin_randoms(gen, (*grid, 3), _vel_scales(cfg, div),
                                       max_std=cfg.vel_std, device=device)
    r["means"] = uniform((L,), cfg.mean_min, cfg.mean_max)
    r["stds"] = uniform((L,), cfg.std_min, cfg.std_max)
    r["zero_bg"] = uniform(())
    r["noise"] = torch.randn(shape, generator=gen, device=device)
    r["blur"] = uniform((), 0.0, cfg.blur_std)
    if cfg.bias_std > 0:
        r["bias"] = draw_perlin_randoms(gen, (*shape, 1), [cfg.bias_res],
                                        max_std=cfg.bias_std, device=device)
    r["gamma"] = torch.randn((), generator=gen, device=device)
    return r


def draw_svf_small(randoms: dict, shape, cfg: ImageEngineConfig):
    """The generator SVF at the reduced grid (small-grid units) from a
    sample's draws, so that a caller can integrate a stacked batch of SVFs
    through ``integrate_svf_batch`` and hand the result back as
    ``phi_small_pre``. ``None`` when the reduced path does not apply."""
    small = reduced_svf_grid(shape, cfg)
    if small is None:
        return None
    r = max(int(cfg.svf_int_res), 1)
    return perlin_from_randoms(randoms["svf"], (*small, 3), _vel_scales(cfg, r)) / r


def _labels_to_image_impl(label_map, cfg, randoms, phi_small_pre=None, impl=None):
    """Core engine: ``(image, soft_map, phi, phi_small)``; ``phi_small`` is
    the generator field at the reduced grid (small-grid units) or ``None``."""
    shape = tuple(label_map.shape)
    L = cfg.num_labels
    dev = label_map.device

    phi_small = None
    if cfg.vel_std > 0:
        grid, r = _svf_grid(shape, cfg)
        pd = payload_dtype(cfg)
        if phi_small_pre is not None:
            if reduced_svf_grid(shape, cfg) is None:
                raise ValueError("phi_small_pre given but the engine has no reduced grid")
            phi_small = phi_small_pre
            phi = rescale_field(phi_small, float(r), out_shape=shape)
        else:
            svf = perlin_from_randoms(randoms["svf"], (*grid, 3), _vel_scales(cfg, r))
            if r > 1:
                phi_small = integrate_svf(svf / r, cfg.int_steps, pd, impl=impl)
                phi = rescale_field(phi_small, float(r), out_shape=shape)
            else:
                phi = integrate_svf(svf, cfg.int_steps, pd, impl=impl)
        soft, lab_idx = warp_labels_soft_hard(label_map, phi, L, impl=impl)
    else:
        phi = torch.zeros((*shape, 3), dtype=torch.float32, device=dev)
        lab_idx = label_map.to(torch.int32)
        soft = None

    means, stds = randoms["means"], randoms["stds"]
    if cfg.zero_background > 0:
        zero_bg = randoms["zero_bg"] < cfg.zero_background
        keep = torch.ones(L, dtype=torch.bool, device=dev)
        keep[0] = False
        keep = keep | ~zero_bg
        means = torch.where(keep, means, torch.zeros_like(means))
        stds = torch.where(keep, stds, torch.zeros_like(stds))
    idx = lab_idx.long()
    img = means[idx] + stds[idx] * randoms["noise"]

    if cfg.blur_std > 0:
        img = _gaussian_blur(img, randoms["blur"], cfg.blur_radius)
    if cfg.bias_std > 0:
        bias = perlin_from_randoms(randoms["bias"], (*shape, 1), [cfg.bias_res])[..., 0]
        img = img * torch.exp(bias)
    lo, hi = img.min(), img.max()
    img = (img - lo) / torch.clamp(hi - lo, min=1e-7)
    if cfg.gamma > 0:
        g = torch.exp(cfg.gamma * randoms["gamma"])
        img = torch.pow(torch.clamp(img, 1e-7, 1.0), g)

    # the map is the LINEARLY warped one-hot: with hard maps the Dice gradient
    # lives only in a thin boundary band and training stalls at zero flow
    if soft is None:
        soft = F.one_hot(idx, L).float()
    return img, soft, phi, phi_small


def _randoms(gen, randoms, label_map, cfg):
    if (gen is None) == (randoms is None):
        raise ValueError("give either gen= (to draw) or randoms= (already drawn)")
    if randoms is None:
        randoms = draw_engine_randoms(gen, label_map.shape, cfg, label_map.device)
    return randoms


def labels_to_image(label_map: torch.Tensor, cfg: ImageEngineConfig, gen=None,
                    randoms=None, phi_small_pre=None, impl=None):
    """Synthesise ``(image (X, Y, Z), soft_one_hot_map (X, Y, Z, L))`` from an
    integer label map whose values lie in ``[0, num_labels)``."""
    img, soft, _, _ = _labels_to_image_impl(
        label_map, cfg, _randoms(gen, randoms, label_map, cfg), phi_small_pre, impl)
    return img, soft


def labels_to_image_full(label_map: torch.Tensor, cfg: ImageEngineConfig, gen=None,
                         randoms=None, phi_small_pre=None, impl=None):
    """:func:`labels_to_image` that also returns the raw (pre-warp) int32
    label map and the generator's field, full-res ``phi`` and reduced-grid
    ``phi_small`` (or ``None``), so that the training loss can warp the
    labels once by the composed generator and model field."""
    img, soft, phi, phi_small = _labels_to_image_impl(
        label_map, cfg, _randoms(gen, randoms, label_map, cfg), phi_small_pre, impl)
    return img, soft, label_map.to(torch.int32), phi, phi_small
