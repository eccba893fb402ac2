"""K10, the U-Net decoder's nearest 2x upsample and skip concatenation
(``ops/up_cat.py``, ``csrc/up_cat.cu``).

On the CPU: the plain version against ``torch.cat`` of ``F.interpolate``, bit
for bit; the wrapper's access width, its errors, its path under grad (with
the old composition's gradients), the multiply-high division the kernel sets
up, and a U-Net forward against the old composition. On the card (marker
``cuda``; they skip without one): K10 against the plain version bit for bit
at the decoder's level shapes of the flagship and of the published widths and
at ragged shapes with narrow accesses, and its launch counts in a forward and
a training step. This file imports nothing of JAX:

    python -m pytest tests/test_torch_up_cat.py -q --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.models.unet import Unet, WholeVolume
from multimodal_registration_torch.ops import up_cat as uc

from _torch_port import cuda_device, rand, t  # noqa: F401

# (x, skip) of the three decoder levels at 160x160x192 with nb_upsample_skips 1
LEVELS = (((1, 10, 10, 12), (1, 20, 20, 24)), ((1, 20, 20, 24), (1, 40, 40, 48)),
          ((1, 40, 40, 48), (1, 80, 80, 96)))


def old_composition(x, skip):
    """What the U-Net ran before K10."""
    up = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=2, mode="nearest")
    return torch.cat([up.permute(0, 2, 3, 4, 1), skip], -1)


def operands(batch, low, c, cs, dtype, seed=0, device="cpu"):
    x = t(rand((batch, *low, c), seed), dtype).to(device)
    skip = t(rand((batch, *(2 * s for s in low), cs), seed + 1), dtype).to(device)
    return x, skip


class OldLayers(WholeVolume):
    def up_cat(self, x, skip):
        return old_composition(x, skip)


def small_unet(nb_upsample_skips=1, dtype=torch.float32, device="cpu"):
    torch.manual_seed(0)
    return Unet(2, (8, 16, 16, 16), (16, 16, 16, 16, 16, 8), nb_upsample_skips,
                dtype=dtype, device=device).eval()


# ---- CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch, low, c, cs", [
    (1, (3, 4, 5), 8, 8), (4, (2, 3, 2), 16, 8), (1, (4, 2, 3), 6, 2), (4, (1, 1, 1), 3, 2)])
def test_plain_equals_interpolate_and_cat(batch, low, c, cs, dtype):
    x, skip = operands(batch, low, c, cs, dtype)
    got = uc.upsample_cat_plain(x, skip)
    assert got.shape == (batch, *(2 * s for s in low), c + cs) and got.dtype == dtype
    assert got.is_contiguous()
    assert torch.equal(got, old_composition(x, skip))
    assert torch.equal(uc.upsample_cat(x, skip), got)


@pytest.mark.parametrize("rows, ptrs, want", [
    ((128, 128), (0, 256, 512), 16),       # the flagship's bf16 rows
    ((512, 512), (0, 256, 512), 16),       # 256 channels
    ((128, 4), (0, 256, 512), 4),          # a 2-channel float32 skip
    ((24, 8), (0, 256, 512), 8),           # 12 + 4 bf16 channels
    ((6, 4), (0, 256, 512), 2),            # 3 + 2 bf16 channels
    ((128, 128), (8, 256, 512), 8),        # x starts 8 bytes into a 16-byte line
    ((128, 128), (0, 2, 512), 2),          # skip at an odd bf16 offset
    ((12, 20), (0, 256, 512), 4),          # 3 + 5 float32 channels
    ((3, 4), (0, 0, 0), None),             # 1-byte values, odd row: no access divides it
])
def test_access_width(rows, ptrs, want):
    assert uc.access_width(*rows, *ptrs) == want


def test_errors_on_what_the_kernel_does_not_take():
    x, skip = operands(1, (2, 3, 4), 4, 2, torch.float32)
    with pytest.raises(ValueError, match="twice its size"):
        uc.upsample_cat(x, skip[:, :, :, :7])
    with pytest.raises(ValueError, match="twice its size"):
        uc.upsample_cat(x, torch.cat([skip, skip]))  # another batch
    with pytest.raises(TypeError, match="one dtype"):
        uc.upsample_cat(x, skip.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        uc.upsample_cat(x[0], skip[0])
    with pytest.raises(ValueError, match="on cpu, skip on meta"):
        uc.upsample_cat(x, torch.empty(skip.shape, device="meta"))
    with pytest.raises(ValueError, match="impl"):
        uc.upsample_cat(x, skip, impl="fast")


def test_under_grad_the_plain_path_with_the_old_gradients():
    x, skip = operands(2, (2, 3, 4), 5, 3, torch.float32, seed=4)
    g = t(rand((2, 4, 6, 8, 8), 6))
    grads = []
    for fn in (uc.upsample_cat, old_composition):
        xl, sl = x.clone().requires_grad_(), skip.clone().requires_grad_()
        out = fn(xl, sl)
        assert out.requires_grad
        out.backward(g)
        grads.append((out.detach(), xl.grad, sl.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # each low-res voxel's gradient is the sum of its 8 children's
    want = g[..., :5].reshape(2, 2, 2, 3, 2, 4, 2, 5).sum((2, 4, 6))
    torch.testing.assert_close(grads[0][1], want, rtol=1e-6, atol=1e-6)


def test_no_launch_on_the_cpu():
    kernels.reset_launch_counts()
    x, skip = operands(1, (2, 2, 2), 4, 4, torch.bfloat16)
    with torch.inference_mode():
        uc.upsample_cat(x, skip)
        small_unet()(t(rand((1, 16, 16, 16, 2), 3)))
    assert kernels.UP_CAT.launches == 0


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 12, 16, 24, 32, 48, 64, 96, 100, 127, 128,
                               1000, 4097, 65535, 2**20 + 1, 2**30 + 3, 2**31 - 1])
def test_multiply_high_division(d):
    """``csrc/up_cat.cu``'s ``div_of`` and ``quot``: ``n / d`` as ``(umulhi(n, m)
    + n) >> s`` for every ``0 <= n < 2**31``, here at the ends and around each
    multiple of ``d`` that they reach."""
    s = max(0, (d - 1).bit_length())
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert 0 < m < 2**32
    ns = {0, 1, 2**31 - 1, 2**31 - 2, d - 1, d, d + 1}
    for q in (1, 2, 3, 1000, (2**31 - 1) // d):
        ns |= {q * d - 1, q * d, q * d + 1}
    for n in sorted(v for v in ns if 0 <= v < 2**31):
        assert (((n * m) >> 32) + n) >> s == n // d, n


@pytest.mark.parametrize("nb_upsample_skips", [0, 1])
def test_unet_forward_equals_the_old_composition(nb_upsample_skips):
    unet = small_unet(nb_upsample_skips)
    x = t(rand((2, 16, 16, 16, 2), 8))
    with torch.inference_mode():
        got = unet(x)
        want = unet.walk(x, OldLayers(unet), nb_upsample_skips >= 1)
    assert got.shape == (2, *((8,) * 3 if nb_upsample_skips else (16,) * 3), 8)
    assert torch.equal(got, want)


# ---- the card --------------------------------------------------------------------

def _k10_against_plain(x, skip):
    with torch.inference_mode():
        kernels.reset_launch_counts()
        got = uc.upsample_cat(x, skip)
        torch.cuda.synchronize()
        assert kernels.UP_CAT.launches == 1
        assert got.is_contiguous() and got.dtype == x.dtype
        assert torch.equal(got, uc.upsample_cat_plain(x, skip))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [64, 256], ids=["flagship", "w256"])
@pytest.mark.parametrize("level", [0, 1, 2], ids=["eighth", "quarter", "half"])
def test_k10_equals_plain_at_the_decoder_levels(cuda_device, level, channels):
    (b, *low), _ = LEVELS[level]
    _k10_against_plain(*operands(b, tuple(low), channels, channels, torch.bfloat16,
                                 seed=level, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch, low, c, cs, dtype, offset", [
    (2, (3, 5, 7), 3, 2, torch.bfloat16, 0),   # 6- and 4-byte rows: 2-byte access
    (4, (1, 2, 3), 3, 5, torch.float32, 0),    # 4-byte access, nx 3, ns 5
    (1, (5, 3, 2), 12, 4, torch.bfloat16, 0),  # 8-byte access
    (3, (2, 2, 9), 64, 64, torch.bfloat16, 1), # x one value past a 16-byte line: 2 bytes
    (1, (4, 3, 5), 2, 6, torch.float64, 0),    # 8-byte values
])
def test_k10_equals_plain_at_ragged_shapes(cuda_device, batch, low, c, cs, dtype, offset):
    x, skip = operands(batch, low, c, cs, dtype, seed=9, device=cuda_device)
    if offset:  # a contiguous view that starts off the 16-byte line
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda_device)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(x.shape)
        assert x.data_ptr() % 16
    _k10_against_plain(x, skip)


@pytest.mark.cuda
def test_k10_launches_three_a_forward_and_none_a_training_step(cuda_device):
    from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense

    torch.manual_seed(0)
    model = VxmDense(VxmConfig(), device=cuda_device)  # the flagship's widths
    mov, fx = (torch.rand((1, 32, 32, 48, 1), device=cuda_device) for _ in range(2))
    with torch.inference_mode():
        kernels.reset_launch_counts()
        model(mov, fx)
        assert kernels.UP_CAT.launches == 3
        unet = model.unet
        x = torch.cat([mov, fx], -1).to(unet.dtype)
        assert torch.equal(unet(x), unet.walk(x, OldLayers(unet), True))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    kernels.reset_launch_counts()
    out = model(mov, fx, with_moved=False)  # K3 has no backward: the loss reads no moved image
    out["warp"].square().mean().backward()
    opt.step()
    torch.cuda.synchronize()
    assert kernels.UP_CAT.launches == 0
