"""Plain float32 field arithmetic of the reference: resize, trilinear sampling
with edge clamping, scaling and squaring, blur.

Written from the published description (VoxelMorph's ``SpatialTransformer``
and ``VecInt``, Neurite's corner-aligned ``resize``), in plain PyTorch, so
that it shares no code with the program it judges. Volumes are
channels-last: ``(X, Y, Z[, C])`` or ``(B, X, Y, Z, C)``; fields carry their
three displacement components last.
"""

from __future__ import annotations

import torch


def no_tf32() -> None:
    """Full float32 for every matrix product and convolution of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def interp_matrix(n_out: int, n_in: int, zoom: float, device) -> torch.Tensor:
    """``M (n_out, n_in)``: output voxel ``i`` samples input coordinate
    ``i / zoom``, linearly, clamped to ``[0, n_in - 1]``."""
    x = torch.arange(n_out, dtype=torch.float64, device=device) / zoom
    x = x.clamp(0, n_in - 1)
    lo = x.floor().long()
    hi = (lo + 1).clamp(max=n_in - 1)
    w = (x - lo).float()
    m = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    rows = torch.arange(n_out, device=device)
    m.index_put_((rows, lo), 1.0 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m


def resize(vol: torch.Tensor, zoom, out_shape) -> torch.Tensor:
    """Corner-aligned linear resize of the three leading axes of ``(X, Y, Z,
    C)`` to ``out_shape`` (``zoom`` a number or three)."""
    if not isinstance(zoom, (tuple, list)):
        zoom = (zoom,) * 3
    v = vol.float()
    mats = [interp_matrix(int(o), int(s), float(z), v.device)
            for o, s, z in zip(out_shape, v.shape[:3], zoom)]
    v = torch.einsum("ax,xyzc->ayzc", mats[0], v)
    v = torch.einsum("by,xyzc->xbzc", mats[1], v)
    return torch.einsum("cz,xyzd->xycd", mats[2], v)


def rescale_field(field: torch.Tensor, factor, out_shape) -> torch.Tensor:
    """Resize a field ``(X, Y, Z, 3)`` and scale its vectors by the zoom."""
    f3 = tuple(factor) if isinstance(factor, (tuple, list)) else (factor,) * 3
    out = resize(field, f3, out_shape)
    return out * torch.tensor(f3, dtype=out.dtype, device=out.device)


def grid(shape, device) -> torch.Tensor:
    """Voxel coordinates ``(X, Y, Z, 3)`` float32."""
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def corners(shape, coords: torch.Tensor):
    """The eight corners of trilinear sampling at ``coords (B, N, 3)``,
    clamped into the volume: a list of ``(flat index (B, N), weight (B, N))``."""
    X, Y, Z = shape
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=coords.dtype, device=coords.device)
    c = torch.minimum(torch.clamp(coords, min=0.0), hi)
    c0 = torch.floor(c)
    f = c - c0
    i0 = c0.long()
    i1 = torch.minimum(i0 + 1, hi.long())
    out = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = (i1 if dx else i0)[..., 0]
                iy = (i1 if dy else i0)[..., 1]
                iz = (i1 if dz else i0)[..., 2]
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                out.append(((ix * Y + iy) * Z + iz, w))
    return out


def warp(vol: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """``out(x) = vol(x + field(x))``, trilinear, edge-clamped: ``vol (B, X,
    Y, Z, C)``, ``field (B, X', Y', Z', 3)`` -> ``(B, X', Y', Z', C)``."""
    B, X, Y, Z, C = vol.shape
    out_grid = tuple(field.shape[1:4])
    n = out_grid[0] * out_grid[1] * out_grid[2]
    coords = (grid(out_grid, field.device) + field.float()).reshape(B, n, 3)
    flat = vol.float().reshape(B, X * Y * Z, C)
    acc = None
    for idx, w in corners((X, Y, Z), coords):
        term = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C)) * w[..., None]
        acc = term if acc is None else acc + term
    return acc.reshape(B, *out_grid, C)


def integrate(svf: torch.Tensor, steps: int, payload=None) -> torch.Tensor:
    """Scaling and squaring of ``svf (B, X, Y, Z, 3)``: ``phi = v / 2**steps``,
    then ``steps`` times ``phi = phi + phi(x + phi)``. With a ``payload``
    type the gathered values and the sampled increment are stored in it."""
    phi = svf.float() / (2.0 ** steps)
    for _ in range(steps):
        if payload is None:
            phi = phi + warp(phi, phi)
        else:
            phi = phi + warp(phi.to(payload).float(), phi).to(payload).float()
    return phi


def upsample2x_field(field: torch.Tensor, out_shape) -> torch.Tensor:
    """``rescale_field`` by 2 of ``(B, x, y, z, 3)`` onto ``out_shape``."""
    return torch.stack([rescale_field(f, 2.0, out_shape) for f in field])


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """Zero-padded separable Gaussian blur of ``(X, Y, Z)`` with std ``sigma``
    (a 0-d tensor) and a kernel of ``2 radius + 1`` taps."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / torch.clamp(sigma, min=1e-4)) ** 2)
    k = k / k.sum()
    out = img
    for axis in range(3):
        n = out.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = radius
        p = torch.nn.functional.pad(out, pad)
        out = sum(k[d] * p.narrow(axis, d, n) for d in range(2 * radius + 1))
    return out
