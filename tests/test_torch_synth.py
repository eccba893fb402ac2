"""The port's synthesis (``synth/``, ``ops/field.py::smooth_field``) against
the JAX package's. ``jax.random`` streams cannot be reproduced, so each test
draws with JAX by the JAX function's own key schedule (helpers in
``_torch_port.py``) and hands those arrays to the port's computing part; the
port's own drawing parts are checked for ranges and statistics.

Tolerances: float32, another summation order: 1e-5 relative to the values'
scale. Label maps: an argmax over 4-6 noise channels flips where two channels
are within rounding of each other, so maps are compared by the fraction of
equal voxels (>= 0.995), not exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.ops import field as jfield
from multimodal_registration_tpu.synth import augment as jaug
from multimodal_registration_tpu.synth import image_engine as jeng
from multimodal_registration_tpu.synth import labelmaps as jlab
from multimodal_registration_tpu.synth import perlin as jper
from multimodal_registration_tpu.train.trainer import _unflatten_params
from multimodal_registration_torch.models import vxm_dense as tvd
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.ops import field as tfield
from multimodal_registration_torch.synth import augment as taug
from multimodal_registration_torch.synth import image_engine as teng
from multimodal_registration_torch.synth import labelmaps as tlab
from multimodal_registration_torch.synth import perlin as tper

from _torch_port import (jax_engine_randoms, jax_flip_mask, jax_perlin_randoms,
                         jax_zero_border_box, rand, random_flat_params, t)

SHAPE = (16, 12, 20)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---- perlin -----------------------------------------------------------------

@pytest.mark.parametrize("out_shape,scales,stds", [
    ((*SHAPE, 3), [4, 8], None),
    ((*SHAPE,), 5.0, None),           # a scale that does not divide the shape
    ((*SHAPE, 1), [2, 16], [0.3, 1.7]),
    ((*SHAPE, 2, 3), [1, 4], None),   # scale 1: no resize; two channel dims
])
def test_draw_perlin_from_the_jax_draws(out_shape, scales, stds):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jper.draw_perlin(key, out_shape, scales, max_std=2.0, stds=stds))
    randoms = jax_perlin_randoms(key, out_shape, scales, max_std=2.0, stds=stds)
    got = tper.perlin_from_randoms(randoms, out_shape, scales).numpy()
    assert got.shape == tuple(out_shape)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=1e-5)


def test_draw_perlin_own_draws():
    a = tper.draw_perlin(gen(1), (*SHAPE, 3), [4, 8], min_std=0.5, max_std=2.0)
    b = tper.draw_perlin(gen(1), (*SHAPE, 3), [4, 8], min_std=0.5, max_std=2.0)
    c = tper.draw_perlin(gen(2), (*SHAPE, 3), [4, 8], min_std=0.5, max_std=2.0)
    assert a.shape == (*SHAPE, 3) and torch.equal(a, b) and not torch.equal(a, c)
    stds = torch.stack([s for i in range(200)
                        for s in tper.draw_perlin_randoms(gen(i), SHAPE, [4], 0.5, 2.0)["stds"]])
    assert 0.5 <= float(stds.min()) and float(stds.max()) <= 2.0
    assert abs(float(stds.mean()) - 1.25) < 0.1
    fixed = tper.draw_perlin_randoms(gen(0), SHAPE, [4, 8], stds=[0.25, 0.5])
    assert [float(s) for s in fixed["stds"]] == [0.25, 0.5]
    assert [tuple(n.shape) for n in fixed["noises"]] == [(4, 3, 5, 1), (2, 2, 3, 1)]
    with pytest.raises(ValueError, match="one std per scale"):
        tper.draw_perlin(gen(0), SHAPE, [4, 8], stds=[1.0])


# ---- blur and field smoothing -----------------------------------------------

@pytest.mark.parametrize("sigma,radius", [(0.7, 3), (1e-6, 3), (2.0, 5)])
def test_gaussian_blur(sigma, radius):
    img = rand(SHAPE, 4)
    want = np.asarray(jeng._gaussian_blur(jnp.asarray(img), jnp.float32(sigma), radius))
    got = teng._gaussian_blur(t(img), torch.tensor(sigma), radius).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_smooth_field_and_batch():
    field = rand((2, *SHAPE, 3), 5, 2.0)
    want = np.asarray(jfield.smooth_field_batch(jnp.asarray(field), 1.2))
    got = tfield.smooth_field_batch(t(field), 1.2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    const = torch.full((*SHAPE, 3), 2.5)
    torch.testing.assert_close(tfield.smooth_field(const, 1.0), const, atol=1e-5, rtol=0)
    assert tfield.smooth_field(const, 0.0) is const


def test_svf_smooth_sigma_through_vxm_dense():
    """``svf_smooth_sigma > 0``: the model smooths the SVF before integration."""
    kw = dict(enc=(4,) * 4, dec=(4,) * 6, compute_dtype="float32",
              integrate_payload_dtype="", svf_smooth_sigma=1.5)
    jcfg, tcfg = jvd.VxmConfig(**kw), tvd.VxmConfig(**kw)
    flat = random_flat_params(jcfg, 6, flow_scale=0.05)
    mov, fx = rand((1, 16, 16, 16, 1), 7), rand((1, 16, 16, 16, 1), 8)
    params = _unflatten_params(jvd.params_template(jcfg), flat)
    want = jvd.VxmDense(cfg=jcfg).apply(params, jnp.asarray(mov), jnp.asarray(fx))
    model = tvd.VxmDense(tcfg, device="cpu").eval()
    model.load_state_dict(params_from_jax(flat, tcfg))
    with torch.inference_mode():
        got = model(t(mov), t(fx))
    assert float(got["warp"].abs().max()) > 0.05
    for k in ("svf", "warp", "moved"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5, rtol=1e-4)
    # and it is not a no-op
    plain = tvd.VxmDense(tvd.VxmConfig(**dict(kw, svf_smooth_sigma=0.0)), device="cpu").eval()
    plain.load_state_dict(params_from_jax(flat, tcfg))
    with torch.inference_mode():
        assert float((plain(t(mov), t(fx))["svf"] - got["svf"]).abs().max()) > 1e-3


# ---- augment ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_flips_and_zero_borders_from_the_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    a = np.random.default_rng(seed).integers(0, 5, SHAPE).astype(np.uint8)
    b = np.random.default_rng(seed + 50).integers(0, 5, SHAPE).astype(np.uint8)
    ja, jb = jaug.random_flips(key, (jnp.asarray(a), jnp.asarray(b)))
    ta, tb = taug.apply_flips(jax_flip_mask(key), (torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    want = np.asarray(jaug.random_zero_borders(key, jnp.asarray(a), scale=4))
    got = taug.apply_zero_borders(jax_zero_border_box(key, SHAPE, 4), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_own_draws():
    g = gen(3)
    counts = torch.stack([taug.draw_flip_mask(g) for _ in range(400)]).sum(1)
    assert set(counts.tolist()) == {0, 1, 2, 3}          # m ~ U{0..3}
    assert all(60 < int((counts == m).sum()) < 140 for m in range(4))
    vol = torch.ones(SHAPE, dtype=torch.uint8)
    for _ in range(20):
        box = taug.draw_zero_border_box(g, SHAPE, scale=4)
        for ax, dim in enumerate(SHAPE):
            assert 0 <= int(box[ax, 0]) < max(dim // 4, 1)
            assert 3 * dim // 4 <= int(box[ax, 1]) <= dim
        kept = taug.apply_zero_borders(box, vol)
        assert int(kept.sum()) == int(torch.prod(box[:, 1] - box[:, 0]))
    assert torch.equal(taug.maybe_zero_borders(g, vol, 4, 0.0), vol)
    zeroed = [taug.maybe_zero_borders(g, vol, 2, 1.0) for _ in range(8)]
    assert any(int(z.sum()) < vol.numel() for z in zeroed)
    s, u = taug.random_flips(g, (vol, vol))
    assert s.shape == vol.shape and torch.equal(s, u)


# ---- the image engine ---------------------------------------------------------

def engine_cfgs(**kw):
    base = dict(num_labels=5, vel_res=4.0, bias_res=8.0, integrate_payload_dtype="")
    base.update(kw)
    return jeng.ImageEngineConfig(**base), teng.ImageEngineConfig(**base)


@pytest.mark.parametrize("kw", [
    dict(svf_int_res=2), dict(svf_int_res=4), dict(svf_int_res=1),
    dict(svf_int_res=2, vel_res=[4.0, 8.0]), dict(vel_std=0.0),
    dict(svf_int_res=2, zero_background=1.0),
], ids=["half", "quarter", "full", "two-scales", "no-warp", "zero-bg"])
def test_labels_to_image_full_from_the_jax_draws(kw):
    jcfg, tcfg = engine_cfgs(**kw)
    key = jax.random.PRNGKey(11)
    lab = np.random.default_rng(12).integers(0, 5, SHAPE).astype(np.uint8)
    jimg, jsoft, jraw, jphi, jphis = jeng.labels_to_image_full(key, jnp.asarray(lab), jcfg)
    randoms = jax_engine_randoms(key, SHAPE, jcfg)
    img, soft, raw, phi, phis = teng.labels_to_image_full(torch.from_numpy(lab), tcfg,
                                                          randoms=randoms)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-4, rtol=1e-4)
    assert (phis is None) == (jphis is None)
    if phis is not None:
        np.testing.assert_allclose(phis.numpy(), np.asarray(jphis), atol=1e-4, rtol=1e-4)
    # soft maps: weights follow phi (|d soft| <= |d phi|)
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), atol=5e-4, rtol=0)
    # the image: a hard label may flip where a coordinate lies within rounding
    # of a half voxel; everywhere else it agrees to float32 precision
    close = np.isclose(img.numpy(), np.asarray(jimg), atol=1e-4, rtol=1e-4)
    assert close.mean() >= 0.995, close.mean()
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
    img2, soft2 = teng.labels_to_image(torch.from_numpy(lab), tcfg, randoms=randoms)
    assert torch.equal(img2, img) and torch.equal(soft2, soft)


def test_preintegrated_svf_path_equals_the_in_engine_one():
    from multimodal_registration_torch.ops.integrate import integrate_svf_batch

    _, tcfg = engine_cfgs(svf_int_res=4, integrate_payload_dtype="bfloat16")
    lab = torch.from_numpy(np.random.default_rng(13).integers(0, 5, SHAPE).astype(np.uint8))
    randoms = teng.draw_engine_randoms(gen(5), SHAPE, tcfg)
    svf = teng.draw_svf_small(randoms, SHAPE, tcfg)
    assert tuple(svf.shape) == (4, 3, 5, 3)
    pre = integrate_svf_batch(svf[None], tcfg.int_steps, torch.bfloat16)[0]
    a = teng.labels_to_image_full(lab, tcfg, randoms=randoms, phi_small_pre=pre)
    b = teng.labels_to_image_full(lab, tcfg, randoms=randoms)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = teng.labels_to_image(lab, tcfg, gen=gen(5))      # drawing itself: same draws
    assert torch.equal(c[0], a[0])
    assert teng.draw_svf_small(randoms, (15, 12, 20), tcfg) is None
    with pytest.raises(ValueError, match="either gen"):
        teng.labels_to_image(lab, tcfg)


def test_engine_own_draws_are_in_range():
    _, tcfg = engine_cfgs()
    r = teng.draw_engine_randoms(gen(6), SHAPE, tcfg)
    assert 25 <= float(r["means"].min()) and float(r["means"].max()) <= 225
    assert 5 <= float(r["stds"].min()) and float(r["stds"].max()) <= 25
    assert 0 <= float(r["blur"]) < tcfg.blur_std and 0 <= float(r["zero_bg"]) < 1
    assert tuple(r["noise"].shape) == SHAPE and abs(float(r["noise"].mean())) < 0.1
    assert tuple(r["svf"]["noises"][0].shape) == (4, 3, 5, 3)  # ceil(half grid / (4 / 2))


# ---- label maps ---------------------------------------------------------------

def jax_label_map_randoms(key, in_shape, L, im_scales, def_scales, im_max_std, def_max_std):
    """The draws of ``synth/labelmaps.py::generate_label_map(key, ...)``."""
    import math

    shape3 = tuple(in_shape) if len(in_shape) == 3 else (*in_shape, 1)
    k_imstd, k_defstd, k_ch = jax.random.split(key, 3)
    im_stds = jax.random.uniform(k_imstd, (len(im_scales),), minval=0.0, maxval=im_max_std)
    def_stds = jax.random.uniform(k_defstd, (len(def_scales),), minval=0.0, maxval=def_max_std)
    k_ch_im, k_ch_def = jax.random.split(k_ch)
    keys = jax.random.split(k_ch_im, L)
    im_noises = [jax_perlin_randoms(keys[l], (*shape3, 1), im_scales,
                                    stds=list(im_stds))["noises"] for l in range(L)]
    k_scale = jax.random.split(k_ch_def, len(def_scales))
    def_noises = []
    for i, s in enumerate(def_scales):
        cs = tuple(int(math.ceil(d / s)) for d in shape3)
        cl = max(1, int(math.ceil(L / s)))
        def_noises.append(torch.from_numpy(np.array(
            jax.random.normal(k_scale[i], (*cs, cl, len(in_shape)), jnp.float32))))
    return {"im_stds": torch.from_numpy(np.array(im_stds)),
            "def_stds": torch.from_numpy(np.array(def_stds)),
            "im_noises": im_noises, "def_noises": def_noises}


@pytest.mark.parametrize("in_shape,L,def_scales", [
    ((16, 12, 20), 5, (2, 4)),   # scale 2 < L: labels get correlated, distinct warps
    ((24, 20), 4, (4,)),         # 2-D: a single plane, in-plane displacement
], ids=["3d", "2d"])
def test_generate_label_map_from_the_jax_draws(in_shape, L, def_scales):
    key = jax.random.PRNGKey(21)
    kw = dict(im_scales=(4, 8), def_scales=def_scales)
    want = np.asarray(jlab.generate_label_map(key, in_shape, L, im_max_std=1.0,
                                              def_max_std=3.0, **kw))
    randoms = jax_label_map_randoms(key, in_shape, L, kw["im_scales"], def_scales, 1.0, 3.0)
    got = tlab.label_map_from_randoms(randoms, in_shape, L, **kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == tuple(in_shape)
    agree = float((got.numpy() == want).mean())
    assert agree >= 0.995, agree  # statistics, not equality: see the module's note
    assert len(np.unique(want)) > 2


def test_generate_label_maps_own_draws():
    maps = tlab.generate_label_maps(gen(7), 3, (16, 16, 16), 4, im_scales=(4, 8),
                                    def_scales=(4,), device="cpu")
    assert len(maps) == 3 and all(m.dtype == np.uint8 and m.shape == (16, 16, 16) for m in maps)
    assert all(m.max() < 4 for m in maps) and not np.array_equal(maps[0], maps[1])
    # every label shows up somewhere across the maps, none takes the whole volume
    frac = np.bincount(np.concatenate([m.ravel() for m in maps]), minlength=4) / (3 * 16 ** 3)
    assert (frac > 0.02).all() and frac.max() < 0.8, frac
    with pytest.raises(ValueError, match="2-D or 3-D"):
        tlab.generate_label_map(gen(0), (8,), 3)
