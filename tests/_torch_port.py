"""Shared helpers of the ``test_torch_*`` files (the PyTorch port against
the JAX package). Inputs are made with numpy from a seed and handed to both."""

import math
import os

import numpy as np
import pytest
import torch


def rand(shape, seed, scale=1.0, low=None, high=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, high, size=shape).astype(np.float32)
    return (rng.normal(scale=scale, size=shape)).astype(np.float32)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def bf16_ulp(m: float) -> float:
    """One bfloat16 ulp (8 significant bits) at magnitude ``m``."""
    return 2.0 ** (math.floor(math.log2(max(float(m), 1e-30))) - 7)


def random_flat_params(jax_cfg, seed, scale=0.2, flow_scale=5e-4) -> dict:
    """Random weights for a JAX ``VxmConfig``, in the flat npz key format
    (``params/unet/enc_0/conv/kernel`` ...), drawn with numpy from ``seed``."""
    from multimodal_registration_tpu.models.vxm_dense import params_template
    from multimodal_registration_tpu.train.trainer import _flatten_params

    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in sorted(_flatten_params(params_template(jax_cfg)).items()):
        s = flow_scale if k.startswith("params/flow/") else scale
        flat[k] = (rng.normal(scale=s, size=v.shape) if k.endswith("kernel")
                   else rng.normal(scale=s / 4, size=v.shape)).astype(np.float32)
    return flat


def synthetic_pair(shape, seed=0, shift=3):
    """A tube along z and a copy shifted by ``shift`` voxels in x, plus noise."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    tube = np.exp(-(g[0] ** 2 + g[1] ** 2) * 12)
    fx = (tube + 0.05 * rng.random(shape)).astype(np.float32)
    mov = (np.roll(tube, shift, 0) + 0.05 * rng.random(shape)).astype(np.float32)
    return fx, mov


@pytest.fixture()
def cuda_device():
    """The card, for tests of the CUDA kernels; they have no CPU mode, so
    without a card the test skips. Decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---- the JAX package's random draws, by following its visible key schedule --
# ``jax.random`` streams cannot be reproduced by a ``torch.Generator``, so the
# synthesis parity tests draw with JAX exactly as the JAX function does and
# hand the arrays to the port's computing part. jax is imported inside the
# functions: the card tests import this module on a machine without JAX.

def _tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def jax_perlin_randoms(key, out_shape, scales, min_std=0.0, max_std=1.0, stds=None):
    """What ``synth/perlin.py::draw_perlin(key, ...)`` draws: per scale
    ``key, k_std, k_noise = split(key, 3)``, a uniform std and unit normals."""
    import jax
    import jax.numpy as jnp

    from multimodal_registration_torch.synth.perlin import sample_shapes

    scales = [scales] if isinstance(scales, (int, float)) else list(scales)
    out = {"stds": [], "noises": []}
    for i, shp in enumerate(sample_shapes(out_shape, scales)):
        key, k_std, k_noise = jax.random.split(key, 3)
        std = (jnp.asarray(stds[i], jnp.float32) if stds is not None else
               jax.random.uniform(k_std, (), minval=min_std, maxval=max_std))
        out["stds"].append(_tt(std))
        out["noises"].append(_tt(jax.random.normal(k_noise, shp, jnp.float32)))
    return out


def jax_engine_randoms(key, shape, jcfg):
    """What ``synth/image_engine.py::_labels_to_image_impl(key, ...)`` draws
    (its ``split(key, 8)``), as the port's ``draw_engine_randoms`` dict."""
    import jax

    from multimodal_registration_tpu.synth import image_engine as je

    (k_svf, k_mean, k_std, k_noise, k_blur, k_bias, k_gamma, k_zbg) = jax.random.split(key, 8)
    L = jcfg.num_labels
    r = {}
    if jcfg.vel_std > 0:
        small = je.reduced_svf_grid(shape, jcfg)
        div = max(int(jcfg.svf_int_res), 1) if small is not None else 1
        grid = small if small is not None else tuple(shape)
        r["svf"] = jax_perlin_randoms(k_svf, (*grid, 3), je._vel_scales(jcfg, div),
                                      max_std=jcfg.vel_std)
    r["means"] = _tt(jax.random.uniform(k_mean, (L,), minval=jcfg.mean_min, maxval=jcfg.mean_max))
    r["stds"] = _tt(jax.random.uniform(k_std, (L,), minval=jcfg.std_min, maxval=jcfg.std_max))
    r["zero_bg"] = _tt(jax.random.uniform(k_zbg, ()))
    r["noise"] = _tt(jax.random.normal(k_noise, tuple(shape)))
    r["blur"] = _tt(jax.random.uniform(k_blur, (), minval=0.0, maxval=jcfg.blur_std))
    if jcfg.bias_std > 0:
        r["bias"] = jax_perlin_randoms(k_bias, (*shape, 1), [jcfg.bias_res], max_std=jcfg.bias_std)
    r["gamma"] = _tt(jax.random.normal(k_gamma, ()))
    return r


def jax_flip_mask(key, ndim=3):
    """The axes ``synth/augment.py::random_flips(key, ...)`` flips."""
    import jax

    k_m, k_perm = jax.random.split(key)
    m = jax.random.randint(k_m, (), 0, ndim + 1)
    return torch.from_numpy(np.array(jax.random.permutation(k_perm, ndim) < m))


def jax_zero_border_box(key, shape, scale=8):
    """The box ``synth/augment.py::random_zero_borders(key, ...)`` keeps."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(key, 12)
    box = []
    for ax, dim in enumerate(shape[:3]):
        k_cmin, k_vmin, k_cmax, k_vmax = keys[4 * ax: 4 * ax + 4]
        lo = jnp.where(jax.random.bernoulli(k_cmin), 0,
                       jax.random.randint(k_vmin, (), 0, max(dim // scale, 1)))
        hi = jnp.where(jax.random.bernoulli(k_cmax), dim,
                       jax.random.randint(k_vmax, (), (scale - 1) * dim // scale, dim))
        box.append([int(lo), int(hi)])
    return torch.tensor(box)


# ---- the trainer tests' tiny configuration and label maps --------------------

def tiny_train_cfg(tmp_path, **overrides) -> dict:
    base = dict(
        in_shape=[16, 16, 16], num_labels=4, num_maps=6, im_scales=[4, 8], def_scales=[4],
        epochs=2, batch_size=2, batch_size_val=1, save_freq=1, vel_res=4.0, bias_res=8.0,
        enc=[4, 4, 4, 4], dec=[4, 4, 4, 4, 4, 4], model_dir=str(tmp_path / "models"),
        log_dir=str(tmp_path / "logs"), label_dir=str(tmp_path / "labels"),
        save_label=False, compute_dtype="float32", lr=1e-3, verbose=0)
    base.update(overrides)
    return base


def label_maps(n, seed=9):
    """``n`` tiny 4-label maps from the port's own generator, on the CPU."""
    from multimodal_registration_torch.synth.labelmaps import generate_label_maps

    return np.stack(generate_label_maps(torch.Generator().manual_seed(seed), n, (16, 16, 16), 4,
                                        im_scales=[4, 8], def_scales=[4], device="cpu"))


# ---- scan pairs off the fixed grid, and the registration outputs compared ---

def rotation_z(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, -s, 0.0, 0.0], [s, c, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
                     [0.0, 0.0, 0.0, 1.0]])


def scan_affine(shape, voxel, rot_deg=0.0, shift=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Affine of a scan of ``shape`` and ``voxel`` size (mm) whose field of
    view is centred on the origin, rotated about z and shifted (mm)."""
    aff = np.diag([*voxel, 1.0])
    aff[:3, 3] = [-(n - 1) * v / 2 for n, v in zip(shape, voxel)]
    aff = rotation_z(rot_deg) @ aff
    aff[:3, 3] += shift
    return aff


def tube_scan(shape, affine, seed, shift_mm=0.0):
    """A bright tube along z (radius ~5 mm, centred in scanner space, moved
    ``shift_mm`` in x) sampled on the grid ``(shape, affine)``, plus noise."""
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                               indexing="ij"), -1)
    xyz = idx @ affine[:3, :3].T + affine[:3, 3]
    tube = np.exp(-((xyz[..., 0] - shift_mm) ** 2 + xyz[..., 1] ** 2) / 30.0)
    return (tube + 0.05 * rng.random(shape)).astype(np.float32)


def write_scan_pair(d, nifti_mod, fixed, moving, seed=3):
    """Write ``fx.nii.gz`` and ``mov.nii.gz`` into ``d``; ``fixed`` and
    ``moving`` are ``(shape, affine)``. The moving tube is 2 mm off."""
    os.makedirs(d, exist_ok=True)
    (fs, fa), (ms, ma) = fixed, moving
    nifti_mod.save(nifti_mod.NiftiImage(tube_scan(fs, fa, seed), fa), os.path.join(d, "fx.nii.gz"))
    nifti_mod.save(nifti_mod.NiftiImage(tube_scan(ms, ma, seed + 1, 2.0), ma),
                   os.path.join(d, "mov.nii.gz"))


def output_files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def assert_same_outputs(jd, td, nearest=False, field_ulps=1.0):
    """The same files in ``jd`` (JAX package) and ``td`` (port), with the
    same affines and dtypes; fields within ``field_ulps`` bf16 ulp of the
    largest field magnitude (fault F2); moved intensities (in [0, 1], which
    change by less than 1 per voxel) within that or 1e-3; inputs and
    preprocessed volumes within 1e-5 (the resampling's float32 products run
    in another order). With ``nearest`` warping a sample whose field differs
    slightly may fall on the other side of a half-voxel tie, so moved images
    may differ in 0.1% of their voxels."""
    from multimodal_registration_tpu.utils import nifti as jnifti
    from multimodal_registration_torch.utils import nifti as tnifti

    names = output_files(jd)
    assert names == output_files(td)
    pairs = {n: (jnifti.load(os.path.join(jd, n)), tnifti.load(os.path.join(td, n)))
             for n in names}
    is_field = {n: "field" in n or "warp" in n for n in names}
    field_tol = field_ulps * bf16_ulp(max(np.abs(a.get_fdata()).max()
                                          for n, (a, _) in pairs.items() if is_field[n]))
    for name, (a, b) in pairs.items():
        np.testing.assert_array_equal(b.affine, a.affine, err_msg=name)
        assert b.dataobj.dtype == a.dataobj.dtype, name
        assert b.header["intent_code"] == a.header["intent_code"], name
        x, y = a.get_fdata(), b.get_fdata()
        assert x.shape == y.shape, name
        if is_field[name]:
            tol = field_tol
        elif "reg" in name:
            tol = max(field_tol, 1e-3)
        else:
            tol = 1e-5
        if nearest and "reg" in name:
            assert (np.abs(x - y) > tol).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(y, x, atol=tol, rtol=0, err_msg=name)
    return names


def write_keras_h5(path, flat: dict, with_bias=True):
    """A Keras VoxelMorph-layout ``.h5`` (``model_weights`` group, one
    Conv3D layer per conv in module order, then the flow head) holding the
    kernels and biases of ``flat`` (the JAX package's flat key format)."""
    import h5py

    rank = {"enc": 0, "dec": 1, "final": 2}

    def order(name):  # params/unet/enc_3/conv, ..., params/flow last
        if name == "params/flow":
            return (3, 0)
        kind, i = name.split("/")[2].split("_")
        return (rank[kind], int(i))

    names = sorted({k.rsplit("/", 1)[0] for k in flat if k.endswith("/kernel")}, key=order)
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        layers = []
        for li, name in enumerate(names):
            lname = f"vxm_dense_conv_{li}"
            layers.append(lname)
            g = mw.create_group(lname)
            g.create_dataset(f"{lname}/kernel:0", data=np.asarray(flat[name + "/kernel"]))
            wn = [f"{lname}/kernel:0".encode()]
            if with_bias:
                g.create_dataset(f"{lname}/bias:0", data=np.asarray(flat[name + "/bias"]))
                wn.append(f"{lname}/bias:0".encode())
            g.attrs["weight_names"] = wn
        mw.attrs["layer_names"] = [n.encode() for n in layers]
    return names
