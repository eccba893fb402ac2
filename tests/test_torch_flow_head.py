"""The flow head (``ops/flow_head.py``, kernel K9 on the card) on the CPU.

The plain versions compute the three formulas that the kernel's entries
implement (forward, input gradient, weight and bias gradients) tap by tap,
and are what the card's tests hold the kernel against; here they are held
in float64 against autograd through ``F.conv3d``: 1e-12 of the largest
value, the two differing only in the order of a few float64 sums. The
float32 limits of ``references_and_limits`` admit the plain versions' own
float32 sums and refuse terms rounded to bf16. ``VxmDense.flow_head``
against the JAX package's head (``nn.Conv`` in float32) through the weight
mapping: 1e-5 of the largest value (float32 sums of 27 * C terms in another
order). The kernels themselves run on the card only
(``tests/test_torch_kernels.py -k flow_head``, ``chip_smoke.py`` phase 16)."""

import itertools

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_torch import kernels
from multimodal_registration_torch.models import vxm_dense as tvd
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.ops import flow_head as fh
from multimodal_registration_torch.parallel.spatial import with_halo

from _torch_port import random_flat_params, rand, t


def _reference(feat, w, b):
    """autograd's conv: ``(B, X, Y, Z, C)`` -> ``(B, X, Y, Z, 3)``."""
    return F.conv3d(feat.permute(0, 4, 1, 2, 3), w, b, padding=1).permute(0, 2, 3, 4, 1)


def _grads(fn, feat, w, b, cot):
    leaves = [x.detach().clone().requires_grad_() for x in (feat, w, b)]
    out = fn(*leaves)
    out.backward(cot)
    return [out.detach()] + [x.grad for x in leaves]


def _plain(feat, w, b, cot):
    """The plain versions' four results, the input gradient in the features'
    type."""
    return [fh.flow_head_plain(feat, w, b), fh.flow_head_dgrad_plain(cot, w, feat.dtype),
            *fh.flow_head_wgrad_plain(feat, cot)]


def _share_of_limit(got, want, limit):
    """The largest error as a share of its element's limit."""
    return float(((got.double() - want).abs() / limit.clamp_min(1e-300)).max())


def _case(shape, C, seed):
    B, X, Y, Z = shape
    feat = t(rand((B, X, Y, Z, C), seed), torch.float64)
    w = t(rand((3, C, 3, 3, 3), seed + 1, 0.3), torch.float64)
    b = t(rand((3,), seed + 2), torch.float64)
    cot = t(rand((B, X, Y, Z, 3), seed + 3), torch.float64)
    return feat, w, b, cot


def _close(got, want, rel=1e-12):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("C", [2, 5, 64])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("grid", [(5, 7, 9), (6, 4, 8)], ids=["odd", "even"])
def test_function_plain_path_matches_autograd_conv_in_float64(C, B, grid):
    """The plain versions of the three entries against autograd's conv."""
    feat, w, b, cot = _case((B, *grid), C, 10 * C + B)
    got = _plain(feat, w, b, cot)
    want = _grads(_reference, feat, w, b, cot)
    for name, g, r in zip(("svf", "dfeat", "dw", "db"), got, want):
        assert g.shape == r.shape and g.dtype == torch.float64, name
        _close(g, r)


def test_function_on_one_halo_slab_as_the_sharded_forward_cuts_it():
    """``parallel/spatial.py``: the head on X slabs with one plane of each
    neighbour (zeros at the ends), cropped, equals the whole volume's; so
    does the input gradient of the cotangent's slabs with their halo; the
    weight and bias gradients of the slabs, their cotangent zero on the halo,
    sum to the whole volume's."""
    feat, w, b, cot = _case((1, 8, 6, 8), 16, 7)
    whole = _plain(feat, w, b, cot)
    slabs = with_halo(list(feat.chunk(2, dim=1)), 1)
    cots = with_halo(list(cot.chunk(2, dim=1)), 1)
    _close(torch.cat([fh.flow_head_plain(s, w, b)[:, 1:-1] for s in slabs], 1), whole[0])
    _close(torch.cat([fh.flow_head_dgrad_plain(c, w, torch.float64)[:, 1:-1] for c in cots], 1),
           whole[1])
    parts = [fh.flow_head_wgrad_plain(s, F.pad(c, (0, 0, 0, 0, 0, 0, 1, 1)))
             for s, c in zip(slabs, cot.chunk(2, dim=1))]
    _close(sum(p[0] for p in parts), whole[2])
    _close(sum(p[1] for p in parts), whole[3])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_input_gradient_comes_back_in_the_features_type(dtype):
    """bf16 features: the float32 sum rounded once to bf16, as the backward
    of ``feat.float()`` gives it; both within the float32 limit of the
    float64 sum (for bf16, one bf16 ulp more)."""
    feat, w, b, cot = _case((1, 4, 6, 8), 6, 3)
    feat, w, b, cot = feat.to(dtype), w.float(), b.float(), cot.float()
    got = fh.flow_head_dgrad_plain(cot, w, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, fh.flow_head_dgrad_plain(cot, w, torch.float32).to(dtype))
    leaf = feat.detach().requires_grad_()
    _reference(leaf.float(), w, b).backward(cot)
    assert leaf.grad.dtype == dtype
    want, limits = fh.references_and_limits(feat, w, b, cot)
    for g in (got, leaf.grad):
        assert _share_of_limit(g, want[1], limits[1]) <= 1.0


def test_launch_counters_stay_zero_on_the_cpu():
    """The plain versions and the model's head on the CPU launch nothing; the
    kernel's Function refuses CPU tensors."""
    kernels.reset_launch_counts()
    feat, w, b, cot = _case((1, 4, 4, 8), 4, 5)
    _plain(feat.float(), w.float(), b.float(), cot.float())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fh.flow_head_conv(feat.float(), w.float(), b.float())
    model = tvd.VxmDense(tvd.VxmConfig(enc=(4,) * 4, dec=(4,) * 6), device="cpu")
    mov = torch.rand((1, 16, 16, 16, 1))
    out = model(mov, torch.rand((1, 16, 16, 16, 1)), with_moved=False)
    out["warp"].sum().backward()
    assert kernels.FLOW_HEAD.launches == 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    assert kernels.entry_launch_counts() == {}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vxm_flow_head_equals_the_jax_head(dtype):
    """The port's head (``impl`` None on the CPU: the library conv; and the
    plain forward) against the JAX package's ``flow`` conv, on the
    same features and the weights mapped by ``params_from_jax``."""
    jcfg = jvd.VxmConfig(enc=(8, 8, 8, 8), dec=(8, 8, 8, 8, 8, 12))
    tcfg = tvd.VxmConfig(enc=jcfg.enc, dec=jcfg.dec)
    flat = random_flat_params(jcfg, seed=4, flow_scale=0.3)
    model = tvd.VxmDense(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(flat, tcfg))
    feat = t(rand((2, 6, 8, 10, 12), 9), dtype)
    jax_svf = nn.Conv(3, kernel_size=(3, 3, 3), padding="SAME", dtype=jnp.float32,
                      param_dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(flat["params/flow/kernel"]),
                    "bias": jnp.asarray(flat["params/flow/bias"])}},
        jnp.asarray(feat.float().numpy()))
    want = torch.from_numpy(np.array(jax_svf, np.float32))
    with torch.no_grad():
        for got in (model.flow_head(feat),
                    fh.flow_head_plain(feat, model.flow.weight, model.flow.bias)):
            assert got.shape == (2, 6, 8, 10, 3) and got.dtype == torch.float32
            _close(got, want, 1e-5)


def test_slots_and_weight_gradient_blocks():
    """The lane layout and the weight gradient's partition that the wrapper
    and ``csrc/flow_head.cu`` agree on."""
    assert fh.slots(64, torch.bfloat16) == (2, 1)
    assert fh.slots(256, torch.bfloat16) == (2, 4)
    assert fh.slots(5, torch.bfloat16) == (1, 1)
    assert fh.slots(64, torch.float32) == (1, 2)
    assert fh.slots(65, torch.float32) == (1, 3)
    for lines, groups, sms in itertools.product((1, 7, 100, 6400, 25600), (1, 4), (1, 132)):
        span, nblk = fh.wgrad_blocks(lines, groups, sms)
        assert span % 8 == 0 and nblk >= 1
        assert (nblk - 1) * span < lines <= nblk * span
        assert 3 * groups * nblk <= max(3 * groups, 2 * sms)
    assert fh.wgrad_blocks(80 * 80, 1, 132) == (80, 80)


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    """Type, shapes and 32-bit indices (any C fits: the kernels stage one
    channel group at a time); meta tensors, no memory."""
    meta = dict(device="meta")
    w, b = torch.empty((3, 64, 3, 3, 3), **meta), torch.empty((3,), **meta)
    fh._check(torch.empty((1, 80, 80, 96, 64), dtype=torch.bfloat16, **meta), w, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fh._check(torch.empty((1, 8, 8, 8, 64), dtype=torch.float16, **meta), w, b)
    with pytest.raises(TypeError, match="w and b must be float32"):
        fh._check(torch.empty((1, 8, 8, 8, 64), **meta), w.double(), b)
    with pytest.raises(ValueError, match="do not fit"):
        fh._check(torch.empty((1, 8, 8, 8, 32), **meta), w, b)
    wide = torch.empty((3, 1024, 3, 3, 3), **meta)
    fh._check(torch.empty((1, 8, 8, 8, 1024), dtype=torch.bfloat16, **meta), wide, b)
    with pytest.raises(ValueError, match="32-bit"):
        fh._check(torch.empty((1, 8, 8, 2**25, 64), dtype=torch.bfloat16, **meta), w, b)


def test_recursive_halving_leaves_lane_l_with_the_sum_of_voxel_l():
    """The forward's reduction of a z-block of 32 voxels across the 32 lanes
    (``halve`` in the source), step for step in numpy: lanes ``l`` and ``l ^
    M`` swap halves, lane ``l`` keeping the upper half when bit ``M`` is set."""
    rng = np.random.default_rng(0)
    acc = rng.normal(size=(32, 32, 3))  # [lane][voxel][output]
    want = acc.sum(0)
    m = 16
    while m >= 1:
        new = acc.copy()
        for lane in range(32):
            up = bool(lane & m)
            for q in range(m):
                keep = acc[lane, q + m] if up else acc[lane, q]
                # the partner's `send`: the half that this lane keeps
                recv = acc[lane ^ m, q + m] if up else acc[lane ^ m, q]
                new[lane, q] = keep + recv
        acc = new
        m //= 2
    for lane in range(32):
        np.testing.assert_allclose(acc[lane, 0], want[lane], rtol=1e-12)


@pytest.mark.parametrize("C", [5, 64])
def test_float32_limits_admit_a_float32_sum_and_refuse_bf16_terms(C):
    """``references_and_limits``: the plain versions summed in float32 lie
    within every limit; a weight gradient and bias gradient of the cotangent
    rounded to bf16, and a forward of the weights rounded to bf16, do not
    (about 2**-9 of each term, where the limit allows some 2**-24 * sqrt(N))."""
    feat, w, b, cot = _case((2, 6, 5, 8), C, 30 + C)
    feat, w, b, cot = feat.bfloat16(), w.float(), b.float(), cot.float()
    want, limits = fh.references_and_limits(feat, w, b, cot)
    for got, r, lim in zip(_plain(feat, w, b, cot), want, limits):
        assert _share_of_limit(got, r, lim) <= 1.0
    dw, db = fh.flow_head_wgrad_plain(feat, cot.bfloat16().float())
    assert _share_of_limit(dw, want[2], limits[2]) > 10.0
    assert _share_of_limit(db, want[3], limits[3]) > 10.0
    svf = fh.flow_head_plain(feat, w.bfloat16().float(), b)
    assert _share_of_limit(svf, want[0], limits[0]) > 10.0
