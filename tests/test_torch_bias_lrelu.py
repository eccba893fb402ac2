"""K11, the library convs' bias and LeakyReLU in place (``ops/bias_lrelu.py``,
``csrc/bias_lrelu.cu``), and ``ConvBlock.forward``'s choice of it.

On the CPU: the plain version against the library's add of the bias cast to
the compute type and ``F.leaky_relu``, bit for bit, in both dtypes and both
layouts; the wrapper's access width, layouts and errors; no launch on the CPU;
``ConvBlock.forward`` on the CPU, under grad and with ``impl="plain"`` equal to
the composition it ran before K11 (outputs and gradients), and its kernel
route, with the plain version in K11's place, equal to it too; the launch
counts that ``VxmDense.kernel_launches`` and ``Trainer.step_launches`` state
for K11. On the card (marker ``cuda``; they skip without one): K11 against
its plain version and the library's composition bit for bit at every library
conv's output shape of the flagship and of the published widths, in bf16
and float32, at ragged channel counts, narrow accesses, rows wider than a
block and NCDHW outputs; each ConvBlock of both models against the old
composition; its launches in a forward and a training step; its span. This
file imports nothing of JAX:

    python -m pytest tests/test_torch_bias_lrelu.py -q --noconftest
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.models import unet as unet_mod
from multimodal_registration_torch.models.unet import ConvBlock, Unet
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.ops import bias_lrelu as bl
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer
from multimodal_registration_torch.utils import profiling

from _torch_port import cuda_device, rand, t  # noqa: F401

W256 = dict(enc=(256,) * 4, dec=(256,) * 6)
# the output levels of a 160x160x192 forward's library convs (nb_upsample_skips 1)
LEVELS = ((1, 80, 80, 96), (1, 40, 40, 48), (1, 20, 20, 24), (1, 10, 10, 12))


def library(y, b, slope=0.2):
    """What the U-Net ran after a library conv before K11: the bias cast to
    the compute type, added over the output, then the LeakyReLU."""
    return F.leaky_relu(y + b.to(y.dtype).view(1, -1, 1, 1, 1), slope)


def output(shape, dtype, lay="channels_last", seed=0, device="cpu", scale=1.0):
    """A conv's output ``(B, C, D, H, W)`` in ``lay``; ``shape`` is (B, C, D, H, W)."""
    B, C, *sp = shape
    if lay == "channels_last":
        y = t(rand((B, *sp, C), seed, scale), dtype).to(device).permute(0, 4, 1, 2, 3)
    else:
        y = t(rand(shape, seed, scale), dtype).to(device)
    assert bl.layout(y) == lay
    return y


def bias(C, seed=1, device="cpu", scale=0.5):
    return t(rand((C,), seed, scale)).to(device)


def old_block(block, x):
    """``ConvBlock.forward`` before K11: the conv with its bias, then the LeakyReLU."""
    dt = block.dtype
    with full_fp32_convs() if dt == torch.float32 else contextlib.nullcontext():
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), block.conv.weight.to(dt),
                     block.conv.bias.to(dt), padding=1)
    return F.leaky_relu(y, 0.2).permute(0, 2, 3, 4, 1)


def small_block(cin=5, cout=6, dtype=torch.float32, device="cpu", seed=0):
    torch.manual_seed(seed)
    block = ConvBlock(cin, cout, dtype, device)
    with torch.no_grad():
        block.conv.bias.normal_(0.0, 0.3)
    return block


# ---- CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("lay", ["channels_last", "ncdhw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 8, 3, 4, 5), (2, 3, 2, 3, 7), (3, 16, 1, 2, 2),
                                   (1, 48, 2, 2, 3)])
def test_plain_equals_the_library_add_and_leaky_relu(shape, dtype, lay):
    y = output(shape, dtype, lay, seed=sum(shape))
    b = bias(shape[1], seed=shape[1])
    want = library(y, b)
    got = bl.bias_lrelu_plain(y.clone(), b, 0.2)
    assert got.dtype == dtype and torch.equal(got, want)
    # the wrapper on the CPU: the plain version, in place
    y2 = y.clone()
    assert bl.bias_lrelu_(y2, b, 0.2) is y2
    assert torch.equal(y2, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_rounds_where_the_library_rounds(dtype):
    """Sums on a rounding boundary of the compute type, zeros of both signs,
    and the negative slope's product rounded once."""
    b = torch.tensor([0.5, -0.5, 2.0 ** -9, 0.0, 1.0 / 3.0])
    vals = torch.tensor([1.0, -1.0, 1.0 + 2.0 ** -8, -0.0, 0.0, -3.0, 255.0, -1e-3])
    y = vals.view(1, 1, 1, 1, -1).expand(1, 5, 1, 1, 8).contiguous().to(dtype)
    want = library(y, b)
    assert torch.equal(bl.bias_lrelu_plain(y.clone(), b, 0.2), want)
    assert torch.equal(torch.signbit(bl.bias_lrelu_plain(y.clone(), b, 0.2)),
                       torch.signbit(want))


@pytest.mark.parametrize("axis_bytes, ptr, size, want", [
    (128, 0, 2, 16),      # the flagship's bf16 rows
    (512, 0, 2, 16),      # 256 channels
    (1024, 0, 4, 16),     # 256 float32 channels
    (6, 0, 2, 2),         # 3 bf16 channels
    (12, 0, 4, 4),        # 3 float32 channels
    (96, 0, 2, 16),       # 48 bf16 channels
    (24, 0, 2, 8),        # 12 bf16 channels
    (128, 8, 2, 8),       # a pointer 8 bytes into a 16-byte line
    (128, 2, 2, 2),       # a pointer one bf16 value in
    (128, 4, 4, 4),       # a float32 pointer one value in
    (210, 0, 2, 2),       # an NCDHW plane of 105 bf16 values
    (6, 0, 4, None),      # no access of at least 4 bytes divides 6
])
def test_access_width(axis_bytes, ptr, size, want):
    assert bl.access_width(axis_bytes, ptr, size) == want


def test_layouts():
    y = torch.empty((2, 4, 3, 5, 6))
    assert bl.layout(y) == "ncdhw"
    assert bl.layout(y.contiguous(memory_format=torch.channels_last_3d)) == "channels_last"
    assert bl.layout(torch.empty((2, 1, 3, 5, 6))) == "channels_last"  # one channel: both
    assert bl.layout(y[:, :, :, :, ::2]) is None
    assert bl.layout(y.permute(0, 1, 3, 2, 4)) is None


def test_errors_on_what_the_kernel_does_not_take():
    y, b = output((1, 4, 2, 3, 4), torch.float32), bias(4)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bl.bias_lrelu_(y.half(), b, 0.2)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bl.bias_lrelu_(y.double(), b, 0.2)
    with pytest.raises(TypeError, match="bias must be float32"):
        bl.bias_lrelu_(y, b.bfloat16(), 0.2)
    with pytest.raises(ValueError, match="one value a channel"):
        bl.bias_lrelu_(y, bias(5), 0.2)
    with pytest.raises(ValueError, match="must be"):
        bl.bias_lrelu_(y[0], b, 0.2)
    with pytest.raises(ValueError, match="neither channels-last nor contiguous"):
        bl.bias_lrelu_(torch.empty((1, 4, 2, 3, 8))[..., ::2], b, 0.2)
    with pytest.raises(ValueError, match="y on meta, bias on cpu"):
        bl.bias_lrelu_(torch.empty(y.shape, device="meta"), b, 0.2)
    with pytest.raises(ValueError, match="unsupported device meta"):
        bl.bias_lrelu_(torch.empty(y.shape, device="meta"), b.to("meta"), 0.2)
    with pytest.raises(ValueError, match="impl"):
        bl.bias_lrelu_(y, b, 0.2, impl="fast")
    with pytest.raises(RuntimeError, match="no backward"):
        bl.bias_lrelu_(y.clone().requires_grad_(), b, 0.2)
    with pytest.raises(RuntimeError, match="no backward"):
        bl.bias_lrelu_(y, b.clone().requires_grad_(), 0.2)


def test_no_launch_and_no_span_on_the_cpu():
    kernels.reset_launch_counts()
    torch.manual_seed(0)
    unet = Unet(2, (8, 16, 16, 16), (16, 16, 16, 16, 16, 8), 1, dtype=torch.float32).eval()
    before = {r[3] for r in profiling.spans()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            bl.bias_lrelu_(output((1, 4, 2, 3, 4), torch.bfloat16), bias(4), 0.2)
            unet(t(rand((1, 16, 16, 16, 2), 3)))
    assert kernels.BIAS_LRELU.launches == 0
    assert "unet.bias_lrelu" not in {r[0] for r in profiling.spans() if r[3] not in before}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["cpu", "grad", "plain"])
def test_conv_block_runs_the_old_composition_off_the_kernel(mode, dtype):
    """On the CPU, under grad and with ``impl="plain"``, ``ConvBlock.forward``
    is the conv with its bias and ``F.leaky_relu``: the same outputs and
    gradients."""
    block = small_block(dtype=dtype)
    x = t(rand((2, 4, 5, 6, 5), 7))
    g = t(rand((2, 4, 5, 6, 6), 8))
    impl = "plain" if mode == "plain" else None
    if mode != "grad":
        with torch.inference_mode():
            assert not block.fuses_bias_lrelu(x, impl)
            assert torch.equal(block(x, impl=impl), old_block(block, x))
        return
    grads = []
    for fn in (block.forward, lambda v: old_block(block, v)):
        block.zero_grad()
        xl = x.clone().requires_grad_()
        assert not block.fuses_bias_lrelu(xl)
        out = fn(xl)
        out.backward(g.to(out.dtype))
        grads.append((out.detach(), xl.grad, block.conv.weight.grad.clone(),
                      block.conv.bias.grad.clone()))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_block_kernel_route_is_the_unbiased_conv_then_the_library_composition(
        monkeypatch, dtype):
    """The route the card takes, run here with the plain version in K11's place:
    the conv without its bias, then the bias and LeakyReLU in place on its
    output, bit for bit the library's add and LeakyReLU after that conv, which
    is what cuDNN's route computed for the conv with its bias (its bias comes
    after the conv; the CPU's conv adds it inside, so the CPU's old
    composition is no yardstick in bf16)."""
    calls = []

    def plain_in_place(y, b, slope, impl=None):
        calls.append((bl.layout(y), b.dtype, slope))
        return bl.bias_lrelu_(y, b, slope, impl="plain")

    monkeypatch.setattr(unet_mod, "use_kernel", lambda x, impl: impl is None)
    monkeypatch.setattr(unet_mod, "bias_lrelu_", plain_in_place)
    block = small_block(dtype=dtype, cin=3, cout=5)
    x = t(rand((1, 6, 4, 5, 3), 9))
    with torch.inference_mode():
        assert block.fuses_bias_lrelu(x)
        got = block(x)
    assert len(calls) == 1 and calls[0][0] is not None and calls[0][1:] == (torch.float32, 0.2)
    with torch.no_grad(), full_fp32_convs():
        y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), block.conv.weight.to(dtype), None,
                     padding=1)
        want = library(y, block.conv.bias).permute(0, 2, 3, 4, 1)
    assert got.dtype == dtype and torch.equal(got, want)
    # with impl="plain" and under grad the route stays the old composition
    with torch.inference_mode():
        assert not block.fuses_bias_lrelu(x, "plain")
        assert torch.equal(block(x, impl="plain"), old_block(block, x))
    xl = x.clone().requires_grad_()
    assert not block.fuses_bias_lrelu(xl)
    block(xl).sum().backward()
    assert len(calls) == 1 and xl.grad is not None


FORWARD_K11 = {
    "flagship": ({}, False, 1, 9),
    "w256": (W256, False, 1, 9),
    "w256_int8": (dict(W256, quantize="int8"), False, 1, 0),
    "w256_int8_calibrating": (dict(W256, quantize="int8"), True, 1, 9),
    "flagship_slabs2": ({}, False, 2, 18),
    "w256_slabs4": (W256, False, 4, 36),
    "w256_int8_calibrating_slabs2": (dict(W256, quantize="int8"), True, 2, 18),
    # no K1: enc_0 runs a library conv too
    "svf_res1": (dict(svf_res=1, int_res=1), False, 1, 10),
    "float16": (dict(compute_dtype="float16"), False, 1, 0),
}


@pytest.mark.parametrize("case", sorted(FORWARD_K11))
def test_forward_states_k11_for_each_library_conv(case):
    over, calibrating, slabs, want = FORWARD_K11[case]
    model = VxmDense(VxmConfig(**over), device="meta", quant_calibrate=calibrating)
    got = model.kernel_launches(slabs)
    assert got["bias_lrelu"] == want
    assert got.get("bias_lrelu_launch", 0) == want


def test_a_training_step_states_no_k11():
    cfg = TrainConfig.from_dict(dict(in_shape=[32, 32, 32], num_labels=4))
    assert Trainer(cfg, device="cpu").step_launches()["bias_lrelu"] == 0


# ---- the card --------------------------------------------------------------------

def _k11_against_plain_and_library(y, b):
    want = library(y, b)
    plain = bl.bias_lrelu_plain(y.clone(), b, 0.2)
    got = y.clone(memory_format=torch.preserve_format)
    assert bl.layout(got) == bl.layout(y)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        assert bl.bias_lrelu_(got, b, 0.2) is got
        torch.cuda.synchronize()
        assert kernels.BIAS_LRELU.launches == 1
    assert torch.equal(got, plain)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels", [64, 256], ids=["flagship", "w256"])
@pytest.mark.parametrize("level", range(len(LEVELS)), ids=["half", "quarter", "eighth",
                                                             "sixteenth"])
def test_k11_equals_plain_at_the_library_convs_outputs(cuda_device, level, channels, dtype):
    B, *sp = LEVELS[level]
    y = output((B, channels, *sp), dtype, seed=level, device=cuda_device)
    _k11_against_plain_and_library(y, bias(channels, seed=channels, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, lay, offset", [
    ((2, 3, 3, 5, 7), torch.bfloat16, "channels_last", 0),   # 6-byte rows: 2-byte access
    ((2, 3, 3, 5, 7), torch.float32, "channels_last", 0),    # 4-byte access, 3 a row
    ((1, 16, 4, 6, 5), torch.bfloat16, "channels_last", 0),  # 2 vectors a row
    ((3, 48, 2, 3, 5), torch.bfloat16, "channels_last", 0),  # 6 vectors a row: 42 rows a block
    ((1, 48, 2, 3, 5), torch.float32, "channels_last", 0),   # 12 vectors a row
    ((1, 64, 3, 4, 5), torch.bfloat16, "channels_last", 1),  # one value past a line: 2 bytes
    ((1, 64, 3, 4, 5), torch.float32, "channels_last", 2),   # 8 bytes past: 8-byte access
    ((1, 2056, 2, 3, 4), torch.bfloat16, "channels_last", 0),  # 257 vectors: wider than a block
    ((1, 1100, 2, 2, 3), torch.float32, "channels_last", 0),   # 275 vectors
    ((2, 3, 3, 5, 7), torch.bfloat16, "ncdhw", 0),           # planes of 105: 2-byte access
    ((2, 5, 4, 6, 8), torch.float32, "ncdhw", 0),            # planes of 192: 16-byte access
    ((1, 64, 10, 10, 12), torch.bfloat16, "ncdhw", 0),       # the coarsest level, NCDHW
    ((1, 16, 40, 40, 48), torch.bfloat16, "ncdhw", 1),       # planes off the line
])
def test_k11_equals_plain_at_ragged_shapes(cuda_device, shape, dtype, lay, offset):
    y = output(shape, dtype, lay, seed=11, device=cuda_device)
    if offset:  # the same layout, starting off the 16-byte line
        buf = torch.empty(y.numel() + offset, dtype=dtype, device=cuda_device)
        perm = (0, 2, 3, 4, 1) if lay == "channels_last" else (0, 1, 2, 3, 4)
        dense = y.permute(*perm).contiguous()
        buf[offset:] = dense.reshape(-1)
        y = buf[offset:].view(dense.shape)
        y = y.permute(0, 4, 1, 2, 3) if lay == "channels_last" else y
        assert y.data_ptr() % 16 and bl.layout(y) == lay
    _k11_against_plain_and_library(y, bias(shape[1], seed=3, device=cuda_device))


def _library_blocks(model):
    unet = model.unet
    return [(name, block) for name, block in unet.named_children()
            if not (name == "enc_0" and unet.nb_upsample_skips >= 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, W256], ids=["flagship", "w256"])
def test_each_conv_block_equals_the_old_composition(cuda_device, over):
    """Each library ConvBlock of the model at its input's shape in a
    160x160x192 forward, with K11, against the conv with its bias and
    ``F.leaky_relu`` written out: bit for bit (one cuDNN conv either way)."""
    torch.manual_seed(0)
    model = VxmDense(VxmConfig(**over), device=cuda_device)
    with torch.no_grad():
        for p in model.unet.parameters():
            if p.ndim == 1:
                p.normal_(0.0, 0.1)
    width = model.unet.enc_nf[0]
    # (the block's input spatial shape): enc_1..3 at 80, 40, 20; dec_0..3 at 10, 20, 40, 80;
    # final_0, final_1 at 80 (half of 160x160x192 with nb_upsample_skips 1)
    spatial = {"enc_1": 80, "enc_2": 40, "enc_3": 20, "dec_0": 10, "dec_1": 20, "dec_2": 40,
               "dec_3": 80, "final_0": 80, "final_1": 80}
    blocks = _library_blocks(model)
    assert [n for n, _ in blocks] == list(spatial)
    for i, (name, block) in enumerate(blocks):
        s = spatial[name]
        cin = block.conv.in_channels
        x = torch.randn((1, s, s, s * 6 // 5, cin), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(i)).bfloat16()
        with torch.inference_mode():
            kernels.reset_launch_counts()
            got = block(x)
            assert kernels.BIAS_LRELU.launches == 1, name
            want = old_block(block, x)
        assert got.shape == (1, s, s, s * 6 // 5, width)
        assert torch.equal(got, want), name
        del x, got, want


@pytest.mark.cuda
def test_float32_conv_block_equals_the_old_composition(cuda_device):
    block = small_block(cin=16, cout=24, dtype=torch.float32, device=cuda_device)
    x = t(rand((2, 10, 12, 14, 16), 5)).to(cuda_device)
    with torch.inference_mode():
        assert torch.equal(block(x), old_block(block, x))


@pytest.mark.cuda
def test_k11_launches_nine_a_forward_and_none_a_training_step(cuda_device):
    torch.manual_seed(0)
    model = VxmDense(VxmConfig(), device=cuda_device)  # the flagship's widths
    mov, fx = (torch.rand((1, 32, 32, 48, 1), device=cuda_device) for _ in range(2))
    with torch.inference_mode():
        kernels.reset_launch_counts()
        model(mov, fx)
        torch.cuda.synchronize()
    assert kernels.BIAS_LRELU.launches == 9 == model.kernel_launches()["bias_lrelu"]
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    kernels.reset_launch_counts()
    out = model(mov, fx, with_moved=False)  # K3 has no backward: the loss reads no moved image
    out["warp"].square().mean().backward()
    opt.step()
    torch.cuda.synchronize()
    assert kernels.BIAS_LRELU.launches == 0


@pytest.mark.cuda
def test_the_forward_opens_unet_bias_lrelu_around_each_launch(cuda_device):
    """Under a profiler the card's forward records the span ``unet.bias_lrelu``
    nine times, each inside ``vxm.unet``, and a forward under grad none."""
    torch.manual_seed(0)
    model = VxmDense(VxmConfig(), device=cuda_device)
    mov, fx = (torch.rand((1, 32, 32, 48, 1), device=cuda_device) for _ in range(2))
    before = {r[3] for r in profiling.spans()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            model(mov, fx)
        model(mov, fx, with_moved=False)["warp"].sum().backward()
    recs = [r for r in profiling.spans() if r[3] not in before]
    by_id = {r[3]: r for r in recs}
    mine = [r for r in recs if r[0] == "unet.bias_lrelu"]
    assert len(mine) == 9
    assert {by_id[r[4]][0] for r in mine} == {"vxm.unet"}
