"""Fused 3x3x3 conv + LeakyReLU + 2x max-pool: the wrapper of kernel K1
(``conv3_lrelu_pool``) and its plain version.

Counterpart of ``multimodal_registration_tpu/ops/pallas/conv_pool.py``. It
serves the U-Net's first level (enc_0) whenever the decoder never reads that
level's full-res activation (``nb_upsample_skips >= 1``), so only the pooled
tensor is written. The operands are rounded to the compute type (the input's
type: bfloat16 on the flagship path), products summed in float32, the
float32 bias added, LeakyReLU applied, the 2x2x2 max taken, and the result
rounded once to the compute type.

On the card a bfloat16 input runs on the tensor cores: an implicit GEMM with
M = voxels, N = Cout, K = 27 * Cin (``csrc/conv_pool.cu``). This module
prepares its B operand, :func:`gemm_weight_matrix`, cut into the tiles of
the matrix instruction by :func:`wgmma_b_tiles`, and states the order in
which the kernel lays voxels on the rows of its M tiles,
:func:`window_row_order`; the CPU tests hold all three against the plain
version. A float32 input (the parity configuration) runs on the float32 units.

The kernel has no backward (neither has the JAX package's: its trainer refuses
the fused first conv). Asked for a gradient on the card, the wrapper raises;
``Unet.forward`` takes the unfused ``ConvBlock`` + ``max_pool_2x`` whenever a
gradient is needed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.ops.warp import needs_grad, use_kernel

_SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on Hopper
_HALO_TC = 10 * 18 * 18  # halo voxels of a block of the tensor-core kernel
_HALO_SIMT = 6 * 10 * 18  # and of the float32 kernel (csrc/conv_pool.cu)
_OUT_BUFFERS = 8 * 8 * 72 * 2  # bytes: a 8 x 72 bf16 output buffer per warp
_TILE_TC = (4, 8, 8)     # pooled outputs of a block: tensor-core kernel
_TILE_SIMT = (2, 4, 8)   # and float32 kernel, whose NVOX is their product
_INT_MAX = 2**31 - 1     # the largest C `int`; also the largest gridDim.x
_GRID_Y_MAX = 65_535     # the largest gridDim.y, which is the batch


def conv3_lrelu_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           neg_slope: float = 0.2) -> torch.Tensor:
    """Plain version: ``x (B, X, Y, Z, Cin)``, ``w (Cout, Cin, 3, 3, 3)``,
    ``b (Cout,)`` -> ``(B, X/2, Y/2, Z/2, Cout)`` in ``x``'s type. The conv
    runs in full float32 (TF32 off) on the card."""
    with full_fp32_convs():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.to(x.dtype).float(),
                     b.float(), padding=1)
    y = F.leaky_relu(y, neg_slope)
    y = F.max_pool3d(y, kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def gemm_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """The B operand of the implicit GEMM: ``w (Cout, Cin, 3, 3, 3)`` rounded
    to bfloat16 as a ``(K_pad, Cout_pad)`` matrix. Row ``k = ((dx*3 + dy)*3 +
    dz) * Cin_pad + ci``; Cin is padded to even (an A register of the matrix
    instruction holds two channels of one tap), K with zero rows to a
    multiple of 16 (one k-step), Cout with zero columns to a multiple of 8
    (one n-tile)."""
    cout, cin = w.shape[:2]
    m = w.to(torch.bfloat16).permute(2, 3, 4, 1, 0)            # (3, 3, 3, Cin, Cout)
    m = F.pad(m, (0, -cout % 8, 0, cin % 2)).reshape(27 * (cin + cin % 2), -1)
    return F.pad(m, (0, 0, 0, -m.shape[0] % 16)).contiguous()


def wgmma_b_tiles(m: torch.Tensor) -> torch.Tensor:
    """``m (K_pad, Cout_pad)`` cut into the tiles that the warpgroup matrix
    instruction reads from shared memory, flat: ``[chunk of 64 columns][k-step
    of 16 rows][k // 8][n // 8][n % 8][k % 8]``, that is 2 x 8 core matrices of
    8 columns x 8 rows with the rows (k) contiguous. Every entry of ``m``
    appears once. The kernel takes 64 columns at a time without asking how
    many are real, so the columns are completed with zeros to a multiple of
    64."""
    m = F.pad(m, (0, -m.shape[1] % 64))
    steps, chunks = m.shape[0] // 16, m.shape[1] // 64
    # k = 16 s + 8 kb + ki, n = 64 c + 8 nb + ni  ->  [c][s][kb][nb][ni][ki]
    return m.view(steps, 2, 8, chunks, 8, 8).permute(3, 0, 1, 4, 5, 2).reshape(-1).contiguous()


def window_row_order() -> torch.Tensor:
    """Where the kernel puts the 64 voxels of 8 pooled windows (neighbours
    along z) on the rows of four 16-row M tiles: entry ``[t, r]`` is
    ``(window, vx, vy, vz)``, the window and the voxel's offset in it. Rows
    ``g`` and ``g + 8`` of tile ``t`` are voxels ``2 t`` and ``2 t + 1`` of
    window ``g``: a lane of the matrix instruction holds the accumulators of
    rows ``lane // 4`` and ``lane // 4 + 8`` of its warp's 16 rows, so a
    window's eight voxels end in the registers of the same lanes and the pool
    needs no exchange. (The instruction's 64 rows are the tiles ``t`` of the
    four warps of a group, each warp with 8 windows of its own.)"""
    t, r = torch.meshgrid(torch.arange(4), torch.arange(16), indexing="ij")
    v = 2 * t + r // 8
    return torch.stack([r % 8, v // 4, (v // 2) % 2, v % 2], -1)


# (data_ptr, _version) of w and b, compute type, device, stream -> (w, b, matrix, bias)
_PREPARED: dict = {}
_PREPARED_MAX = 8  # a device's


def prepared_weights(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """The kernel's weight and bias operands for compute type ``dtype``, made
    once per version of the parameters: for bfloat16 the tiles of
    :func:`gemm_weight_matrix`, for float32 the float32 matrix ``(27 * Cin,
    Cout)`` with row ``k = tap * Cin + ci``; the bias in float32. An in-place
    update of ``w`` or ``b`` (an optimizer step, ``load_state_dict``) bumps
    the tensor's ``_version`` and so misses the cache; a write through
    ``.data`` does not and must not be used on cached weights. An entry keeps
    its ``w`` and ``b`` alive, so their memory cannot be handed to other
    tensors that would then match the key; each device holds at most
    ``_PREPARED_MAX`` entries, its oldest going first, so a mesh of several
    cards keeps every card's. The current stream of a card is part of the
    key: the operands are made on it, and a launch on another stream would not
    be ordered behind that. Tensors made under ``torch.inference_mode``
    track no version and are prepared anew on every call."""
    try:
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version, dtype, w.device,
               kernels.stream_of(w) if w.is_cuda else 0, w.shape)
    except RuntimeError:  # inference tensors do not track a version
        key = None
    entry = _PREPARED.get(key)
    if entry is None:
        with torch.no_grad():
            if dtype == torch.bfloat16:
                wk = wgmma_b_tiles(gemm_weight_matrix(w))
            else:
                cout, cin = w.shape[:2]
                wk = w.float().permute(2, 3, 4, 1, 0).reshape(27 * cin, cout).contiguous()
            entry = (w, b, wk, b.float().contiguous())
        if key is not None:
            mine = [k for k in _PREPARED if k[5] == w.device]
            if len(mine) >= _PREPARED_MAX:
                del _PREPARED[mine[0]]
            _PREPARED[key] = entry
    return entry[2], entry[3]


def _smem_bytes(cin: int, cout: int, dtype: torch.dtype) -> int:
    """Shared memory of one block, as ``csrc/conv_pool.cu`` lays it out."""
    if dtype == torch.float32:
        return 4 * (27 * cin * cout + cin * _HALO_SIMT)
    cp2 = (cin + 1) // 2
    k_pad, cout_pad = -(-27 * 2 * cp2 // 16) * 16, -(-cout // 64) * 64  # as wgmma_b_tiles
    return 2 * k_pad * cout_pad + 4 * cout_pad + 2 * k_pad + _OUT_BUFFERS + 4 * cp2 * _HALO_TC


def _k1_index_fits(B: int, X: int, Y: int, Z: int, Cin: int, Cout: int,
                   dtype: torch.dtype) -> bool:
    """Whether K1's kernel for ``dtype`` can take ``x (B, X, Y, Z, Cin)`` and
    ``Cout``: every index it forms in 32-bit ``int`` (``csrc/conv_pool.cu``)
    stays below 2**31, and the grid fits. Both kernels take the batch as
    ``gridDim.y`` and the blocks of a batch element as ``gridDim.x``; both
    form the batch element's base offset and the pooled output's offsets in 64
    bits, so neither B nor the output's size is bound otherwise.

    * bfloat16 (``tc::``): a voxel's input offset ``((gx * Y + gy) * Z + gz)
      * Cin`` within its batch element, the halo index ``v * CP2 + c2``;
    * float32 (``simt::``): the weight count ``27 * Cin * Cout``, the halo
      count ``HX * HY * HZ * Cin``, the work items ``NVOX * groups`` (at most
      ``NVOX * Cout``); it reads the input through 64-bit offsets."""
    if max(B, X, Y, Z, Cin, Cout) > _INT_MAX or B > _GRID_Y_MAX:
        return False
    tile = _TILE_TC if dtype == torch.bfloat16 else _TILE_SIMT
    blocks = 1
    for n, p in zip((X // 2, Y // 2, Z // 2), tile):
        blocks *= -(-n // p)
    if dtype == torch.bfloat16:
        products = (X * Y * Z * Cin, _HALO_TC * ((Cin + 1) // 2))
    else:
        products = (27 * Cin * Cout, _HALO_SIMT * Cin, math.prod(_TILE_SIMT) * Cout)
    return blocks <= _INT_MAX and max(products) <= _INT_MAX


def conv3_lrelu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     neg_slope: float = 0.2, impl=None) -> torch.Tensor:
    """``maxpool2(leaky_relu(conv3x3x3_SAME(x, w) + b))`` without writing the
    full-res activation. ``x (B, X, Y, Z, Cin)`` float32 or bfloat16 with even
    spatial dims, ``w (Cout, Cin, 3, 3, 3)`` (PyTorch layout), ``b (Cout,)``.
    On the card the weights are prepared once per version of ``w`` and ``b``
    (:func:`prepared_weights`), so a call is one device operation, and for a
    bfloat16 input ``neg_slope`` must not be negative (the tensor-core kernel
    pools first)."""
    if x.ndim != 5 or w.shape[1:] != (x.shape[-1], 3, 3, 3) or b.shape != (w.shape[0],):
        raise ValueError(
            f"conv3_lrelu_pool: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)} do not fit")
    B, X, Y, Z, Cin = x.shape
    if X % 2 or Y % 2 or Z % 2:
        raise ValueError(f"conv3_lrelu_pool: spatial dims must be even, got {(X, Y, Z)}")
    if not use_kernel(x, impl):
        return conv3_lrelu_pool_plain(x, w, b, neg_slope)

    if needs_grad(x, w, b):
        raise NotImplementedError(
            "conv3_lrelu_pool (kernel K1) is inference-only, it has no backward: call "
            "it under torch.no_grad(), or use ConvBlock + max_pool_2x in training")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3_lrelu_pool: x must be float32 or bfloat16, got {x.dtype}")
    # the tensor-core kernel pools before the LeakyReLU, which must not reorder values
    if x.dtype == torch.bfloat16 and neg_slope < 0:
        raise ValueError(
            f"conv3_lrelu_pool: neg_slope must not be negative for bfloat16, got {neg_slope}")
    Cout = w.shape[0]
    smem = _smem_bytes(Cin, Cout, x.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"conv3_lrelu_pool: Cin={Cin}, Cout={Cout} in {x.dtype} need {smem} B of "
            f"shared memory, more than the {_SMEM_LIMIT} B a block may use")
    if not _k1_index_fits(B, X, Y, Z, Cin, Cout, x.dtype):
        raise ValueError("conv3_lrelu_pool: tensor too large for 32-bit indices")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3_lrelu_pool: x, w and b on different devices")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view into the middle of a buffer: the kernel reads 32-bit words
        x = x.clone()
    wk, bk = prepared_weights(w, b, x.dtype)
    out = torch.empty((B, X // 2, Y // 2, Z // 2, Cout), dtype=x.dtype, device=x.device)
    with kernels.on_device_of(x):
        kernels.CONV3_LRELU_POOL.launch(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
            B, X, Y, Z, Cin, Cout, float(neg_slope),
            int(x.dtype == torch.bfloat16), kernels.stream_of(x))
    return out
