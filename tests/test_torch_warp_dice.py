"""The training loss's fused Dice (``ops/warp.py::warp_onehot_dice_batch``),
on the CPU, where it runs the plain versions of K6's and K7's Dice entries,
against the dense composition (``impl="plain"``: ``warp_onehot_batch`` then
``dice_loss``) and against ``jax.grad`` of the JAX package's ``dice_loss`` /
``dice_loss_zeropad`` of ``jax.vmap(warp_onehot)``, on the same numpy inputs.

Tolerances: the value and the flow gradient within atol 1e-5 and rtol 1e-5,
the atol taken of the largest gradient (a Dice gradient is of order 1e-3 at
these sizes, so an absolute 1e-5 would hold nothing); float32 sums in
another order on each side (the plain entries sum in float64). The JAX side
runs its production sampler (``MMREG_WARP_MODE=packed``), as in
``test_torch_warp_grad.py``. The plain entries are also held against their
formulas: the sums against the dense soft map, the flow gradient against
autograd of the dense cotangent's contraction."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.losses import losses as jl
from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops import warp as tw
from multimodal_registration_torch.train import trainer as ttr

from _torch_port import rand, t

jwarp = importlib.import_module("multimodal_registration_tpu.ops.warp")

SHAPE = (2, 10, 12, 8)
L = 6


@pytest.fixture(autouse=True)
def jax_production_sampler(monkeypatch):
    monkeypatch.setenv("MMREG_WARP_MODE", "packed")


def padded(labels, width=2):
    """Label 0 on the borders, ``width`` voxels deep; the inside keeps its labels."""
    out = np.zeros_like(labels)
    w = width
    out[:, w:-w, w:-w, w:-w] = labels[:, w:-w, w:-w, w:-w]
    return out


def case_inputs(case):
    """``(source labels, flow, target map, upstream gradient)`` of a case."""
    rng = np.random.default_rng(21)
    src = rng.integers(0, L, SHAPE)
    trg = rng.integers(0, L, SHAPE)
    flow = rand((*SHAPE, 3), 22, low=-3.0, high=3.0)
    up = 1.0
    if case == "absent label":  # label L-1 in neither map: S = 0
        src, trg = rng.integers(0, L - 1, SHAPE), rng.integers(0, L - 1, SHAPE)
    elif case == "clip bounds":
        flow[0, :2] = 0.0  # on the lower bound
        flow[0, -1] = 0.0  # on the far bound
        x = np.arange(SHAPE[1], dtype=np.float32)
        flow[1, :, :3, :, 0] = -x[:, None, None]  # exactly onto 0
        flow[1, :, 3:6, :, 0] = (SHAPE[1] - 1 - x)[:, None, None]  # exactly onto X-1
    elif case == "padded borders":  # label 0 only on the borders of both maps
        src, trg = padded(rng.integers(1, L, SHAPE)), padded(rng.integers(1, L, SHAPE))
        flow = rand((*SHAPE, 3), 23, low=-0.45, high=0.45)
    elif case == "upstream gradient":
        up = -2.5
    lt = torch.as_tensor(src, dtype=torch.uint8)
    # the target: the soft warp of the target labels by a second field
    map2 = tw.warp_onehot_batch(torch.as_tensor(trg, dtype=torch.uint8),
                                t(rand((*SHAPE, 3), 24, low=-0.45, high=0.45)), L)
    if case == "padded borders":  # keep the borders' one-hot exact
        map2 = torch.nn.functional.one_hot(torch.as_tensor(trg), L).float()
    return lt, flow, map2, up


def torch_value_grad(lt, flow, map2, up, zeropad, impl=None):
    f = t(flow).requires_grad_()
    d = tw.warp_onehot_dice_batch(lt, f, map2, L, zeropad=zeropad, impl=impl)
    (d * up).backward()
    return float(d.detach()), f.grad.numpy()


def jax_value_grad(lt, flow, map2, up, zeropad):
    loss = jl.dice_loss_zeropad if zeropad else jl.dice_loss
    labels = jnp.asarray(lt.numpy(), jnp.int32)
    m2 = jnp.asarray(map2.numpy())

    def scalar(f):
        pred = jax.vmap(lambda l, ff: jwarp.warp_onehot(l, ff, L))(labels, f)
        return loss(m2, pred) * up

    v, g = jax.value_and_grad(scalar)(jnp.asarray(flow))
    return float(v) / up, np.asarray(g)


CASES = ["random", "absent label", "clip bounds", "padded borders", "upstream gradient"]


@pytest.mark.parametrize("zeropad", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_fused_dice_equals_dense_and_jax(case, zeropad):
    lt, flow, map2, up = case_inputs(case)
    v, g = torch_value_grad(lt, flow, map2, up, zeropad)
    vd, gd = torch_value_grad(lt, flow, map2, up, zeropad, impl="plain")
    vj, gj = jax_value_grad(lt, flow, map2, up, zeropad)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(v, vj, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vd, vj, atol=1e-5, rtol=1e-5)
    atol = 1e-5 * np.abs(gj).max()
    np.testing.assert_allclose(g, gj, atol=atol, rtol=1e-5)
    np.testing.assert_allclose(g, gd, atol=atol, rtol=1e-5)
    if case == "clip bounds":
        assert (g[0, 0] != 0).any()  # half the slope passes on the lower bound
    if case == "padded borders" and zeropad:
        assert (g[:, 0] == 0).all()  # padded in both maps: no gradient


@pytest.mark.parametrize("zeropad", [False, True])
def test_absent_label_has_zero_coefficients(zeropad):
    lt, flow, map2, _ = case_inputs("absent label")
    sums = tw.warp_labels_dice_sums(lt, t(flow), map2, L, zeropad)
    loss, coef = tw.dice_coefficients(sums, zeropad)
    S = sums[..., 1] + sums[..., 2]
    assert (S[:, L - 1] == 0).all() and (S[:, :L - 1] > 0).all()
    assert (coef[:, L - 1] == 0).all() and torch.isfinite(coef).all() and torch.isfinite(loss)
    assert (coef[:, 0] == 0).all() == zeropad
    assert (coef[:, 1:L - 1, 0] < 0).all() and (coef[:, 1:L - 1, 1] > 0).all()


def dense_keep(map2, soft, zeropad):
    if not zeropad:
        return torch.ones(soft.shape[:-1])
    return (~((map2[..., 0] >= 1.0) | (soft[..., 0] >= 1.0))).float()


@pytest.mark.parametrize("zeropad", [False, True])
@pytest.mark.parametrize("case", ["random", "padded borders"])
def test_plain_sums_equal_their_formula(case, zeropad):
    """I, P and T from the corner weights against the same from the dense
    soft map, summed in float64."""
    lt, flow, map2, _ = case_inputs(case)
    sums = tw.warp_labels_dice_sums(lt, t(flow), map2, L, zeropad)
    soft = tw.warp_onehot_batch(lt, t(flow), L).double()
    keep = dense_keep(map2, soft, zeropad).double()[..., None]
    tt = map2.double()
    want = torch.stack([(keep * tt * soft).sum((1, 2, 3)), (keep * soft).sum((1, 2, 3)),
                        (keep * tt).sum((1, 2, 3))], -1)
    assert sums.shape == (SHAPE[0], L, 3) and sums.dtype == torch.float32
    torch.testing.assert_close(sums.double(), want, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("zeropad", [False, True])
@pytest.mark.parametrize("case", ["random", "clip bounds", "padded borders"])
def test_plain_flow_grad_equals_autograd(case, zeropad):
    """The gradient of sum_v,l keep (alpha t + beta) p w.r.t. the flow, the
    plain entry against autograd through the plain soft warp."""
    lt, flow, map2, _ = case_inputs(case)
    coef = t(rand((SHAPE[0], L, 2), 25))
    got = tw.warp_labels_dice_flow_grad(lt, t(flow), map2, coef, L, zeropad)
    f = t(flow).requires_grad_()
    soft = tw.warp_onehot_batch(lt, f, L, impl="plain")
    g = dense_keep(map2, soft.detach(), zeropad)[..., None] * (
        coef[:, None, None, None, :, 0] * map2 + coef[:, None, None, None, :, 1])
    (soft * g).sum().backward()
    m = float(f.grad.abs().max())
    assert m > 0.1
    torch.testing.assert_close(got, f.grad, atol=1e-5 * m, rtol=1e-5)


def test_keep_test_sums_as_k6_does():
    """The zeropad test reads p[..., 0] >= 1 where all 8 corners are label 0:
    a sum of 8 weights that rounds to 1 or just below. The plain entries sum
    it corner by corner in K6's order, as the plain soft warp does: the same
    voxels flip."""
    labels = torch.zeros((1, 9, 8, 10), dtype=torch.uint8)
    labels[0, 4:, :, :] = 3
    flow = t(rand((1, 9, 8, 10, 3), 26, low=-0.49, high=0.49))
    soft = tw.warp_onehot_batch(labels, flow, 4)
    map2 = torch.zeros((1, 9, 8, 10, 4))
    _, _, labs, ws = tw._label_corners_plain(labels, flow)
    keep = tw._dice_keep_plain(map2.reshape(1, -1, 4), labs, ws, True)
    want = dense_keep(map2, soft, True).reshape(1, -1)
    assert torch.equal(keep, want)
    p0 = soft[..., 0].reshape(-1)
    inside = (labs[0] == 0).all(-1)
    assert inside.sum() > 100 and ((p0[inside] >= 1.0) == (keep[0, inside] == 0)).all()


@pytest.mark.parametrize("L_", [1, 6, 26, 64, 100, 255, 256])
def test_dice_plan_is_a_function_of_volume_and_labels(L_):
    """The forward's tiles and blocks: a multiple of 32 voxels a tile, at
    most one block per tile and 512 a batch element, shared memory within
    what a block may use (the formula of ``csrc/warp_labels.cu``)."""
    for n in (1, 31, 960, 160 * 160 * 192):
        tv, g = tw._dice_plan(n, L_)
        assert tv % 32 == 0 and 32 <= tv <= 256
        assert 1 <= g <= min(-(-n // tv), 512)
        smem = tw._dice_smem(tv, L_)
        assert smem == 4 * max(3 * (tv * L_ + 8) + 2 * (3 * tv + 4), 256 * 24)
        assert smem <= 227 * 1024 and (smem <= 100 * 1024 or tv == 32)
    src = (tw.kernels.CSRC / "warp_labels.cu").read_text()
    assert ("(size_t)3 * dice_span(TV, L) + (size_t)2 * (3 * TV + 4)" in src
            and "return TV * L + 8;" in src and "(size_t)THREADS * 24" in src)


def test_fused_dice_refuses_what_it_does_not_compute():
    lt, flow, map2, _ = case_inputs("random")
    with pytest.raises(NotImplementedError, match="target map"):
        tw.warp_onehot_dice_batch(lt, t(flow), map2.clone().requires_grad_(), L)
    with pytest.raises(ValueError, match="impl"):
        tw.warp_onehot_dice_batch(lt, t(flow), map2, L, impl="dense")
    with pytest.raises(ValueError, match="target map"):
        tw.warp_onehot_dice_batch(lt, t(flow), map2[..., :-1], L)


def test_fused_dice_counts_no_launch_on_the_cpu():
    lt, flow, map2, _ = case_inputs("random")
    kernels.reset_launch_counts()
    f = t(flow).requires_grad_()
    tw.warp_onehot_dice_batch(lt, f, map2, L).backward()
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    assert kernels.entry_launch_counts() == {}


def test_trainer_loss_takes_the_fused_dice(monkeypatch):
    """``loss_from_batch`` computes its Dice term through
    ``warp_onehot_dice_batch``, with the trainer's zeropad rule and ``impl``."""
    calls = []
    real = ttr.warp_onehot_dice_batch

    def spy(labels, flow, map2, num_classes, zeropad=False, impl=None):
        calls.append((tuple(labels.shape), num_classes, zeropad, impl))
        return real(labels, flow, map2, num_classes, zeropad=zeropad, impl=impl)

    monkeypatch.setattr(ttr, "warp_onehot_dice_batch", spy)
    from multimodal_registration_torch.train.config import TrainConfig

    cfg = TrainConfig.from_dict(dict(in_shape=[16, 16, 16], num_labels=4, num_maps=2,
                                     enc=[4] * 4, dec=[4] * 6, batch_size=1,
                                     compute_dtype="float32", save_label=False, verbose=0))
    trainer = ttr.Trainer(cfg, device="cpu")
    maps = torch.as_tensor(np.random.default_rng(27).integers(0, 4, (2, 16, 16, 16)),
                           dtype=torch.uint8)
    batch = ttr.synthesize(trainer.generator(1), maps[:1], maps[1:], trainer.engine_cfg, cfg,
                           False)
    d = {}
    for zeropad in (False, True):
        for impl in (None, "plain"):
            loss, aux = ttr.loss_from_batch(trainer.model, batch, trainer.engine_cfg, cfg,
                                            zeropad, impl)
            d[zeropad, impl] = float(aux["dice_loss"])
    assert [c[2:] for c in calls] == [(False, None), (False, "plain"), (True, None),
                                     (True, "plain")]
    assert all(c[:2] == ((1, 16, 16, 16), 4) for c in calls)
    for zeropad in (False, True):
        np.testing.assert_allclose(d[zeropad, None], d[zeropad, "plain"], atol=1e-6, rtol=1e-6)
