"""The published inference widths (``config/config_inference.json``: enc
[256]x4, dec [256]x6) on the in-repo checkpoint
``benchmarks/learned_w256_160x160x192_26lab.npz``: the port against the JAX
package on the CPU, in float32, in bf16 and in int8 with the in-repo
sidecar ``learned_w256_...npz.quant.json``.

Tolerances:
  * float32 forward at 32³: ``warp`` 1e-3 voxel, ``moved`` 1e-4 (measured
    6.1e-4 and 4.9e-5). The same float32 network, but ten convs of 256
    channels whose sums of 6,912 (and 13,824) terms run in another order than
    XLA's, and five squaring steps that carry the last-bit differences on.
  * bf16 ``register()`` with the published config at 32³: the output files
    through ``_torch_port.assert_same_outputs`` (the F2 rule), with fields
    within 4 bf16 ulp of their magnitude instead of 1 (measured 2.0): each of
    the ten convs rounds its outputs to bf16, so a last-bit difference of a
    sum flips a rounding, and at these widths the flips of one layer reach
    the sums of the next.
  * int8 forward with the sidecar at 16³: an int8 conv is exact given the
    same input (``tests/test_torch_quantize.py``), but a last-bit difference
    of an activation that lies next to a rounding boundary of ``x / a_scale``
    flips its int8 value by one step. The test counts those flips at the
    input of each of the nine int8 convs. float32: at most 1 in 10^4 of a
    conv's input values may flip, by one step (measured: none), and ``warp``
    and ``moved`` agree within 1e-4. bf16: a bf16 ulp of an activation is
    about a third of a quantization step at these scales, so flips are many.
    At the input of enc_1, the first int8 conv, whose input comes from the
    bf16 enc_0 alone, at most 1% may flip, by one step (measured 0.40%);
    every later conv's input carries the divergence of the int8 convs before
    it: at most 30% may differ, by at most 2 steps (measured up to 24%, in
    the 256 values of dec_0, and 2 steps). ``warp`` agrees within 0.1 voxel
    and ``moved`` within 0.05 (measured 0.027 and 0.017; the limits that
    ``chip_smoke.py`` holds the card's int8 path to against its plain path).
"""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.models.quantize import load_scales as jax_load_scales
from multimodal_registration_tpu.train.trainer import _unflatten_params
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.models import vxm_dense as tvd
from multimodal_registration_torch.models.quantize import load_scales
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import assert_same_outputs, synthetic_pair

jreg = importlib.import_module("multimodal_registration_tpu.infer.register")

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "benchmarks", "learned_w256_160x160x192_26lab.npz")
SIDECAR = CKPT + ".quant.json"
W256 = dict(enc=(256,) * 4, dec=(256,) * 6)
INT8_BLOCKS = ("enc_1", "enc_2", "enc_3", "dec_0", "dec_1", "dec_2", "dec_3", "final_0", "final_1")


@pytest.fixture(scope="module")
def flat():
    with np.load(CKPT) as z:
        return dict(z)


def _pair(shape):
    fx, mov = synthetic_pair(shape)
    return mov[None, ..., None], fx[None, ..., None]


def _jax_forward(flat, dtype, quantize, mov, fx, capture=False):
    cfg = jvd.VxmConfig(**W256, compute_dtype=dtype, quantize=quantize)
    variables = _unflatten_params(jvd.params_template(cfg), flat)
    if quantize:
        variables = {**variables, "quant": jax_load_scales(SIDECAR)}
    model = jvd.VxmDense(cfg=cfg)
    if capture:
        out, state = model.apply(variables, jnp.asarray(mov), jnp.asarray(fx),
                                 capture_intermediates=True, mutable=["intermediates"])
        blocks = {k: np.asarray(v["__call__"][0], np.float32)
                  for k, v in state["intermediates"]["unet"].items() if k != "__call__"}
    else:
        out, blocks = model.apply(variables, jnp.asarray(mov), jnp.asarray(fx)), None
    return {k: np.asarray(out[k], np.float32) for k in ("moved", "warp")}, blocks


def _port_model(flat, dtype, quantize):
    cfg = tvd.VxmConfig(**W256, compute_dtype=dtype, quantize=quantize)
    model = tvd.VxmDense(cfg, device="cpu").eval()
    model.load_state_dict(params_from_jax(flat, cfg))
    if quantize:
        model.set_quant_scales(load_scales(SIDECAR))
    return model


def _port_forward(model, mov, fx):
    with torch.inference_mode():
        out = model(torch.from_numpy(mov), torch.from_numpy(fx))
    return {k: out[k].float().numpy() for k in ("moved", "warp")}


def test_w256_float32_forward_matches_jax(flat):
    mov, fx = _pair((32, 32, 32))
    want, _ = _jax_forward(flat, "float32", "", mov, fx)
    got = _port_forward(_port_model(flat, "float32", ""), mov, fx)
    assert got["warp"].shape == (1, 16, 16, 16, 3)
    np.testing.assert_allclose(got["warp"], want["warp"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["moved"], want["moved"], atol=1e-4, rtol=0)


def test_w256_bf16_register_with_the_published_config(flat, tmp_path):
    """``register()`` with ``config/config_inference.json`` as it is (bf16),
    through both packages: the same files, fields within 4 bf16 ulp."""
    with open(os.path.join(ROOT, "config", "config_inference.json")) as f:
        settings = json.load(f)
    runs = {}
    for side, nifti, conf, reg in (("jax", jnifti, jconf, jreg), ("port", tnifti, tconf, treg)):
        d = str(tmp_path / side)
        os.makedirs(d)
        fx, mov = synthetic_pair((32, 32, 32), seed=3)
        nifti.save(nifti.NiftiImage(fx, np.eye(4)), os.path.join(d, "fx.nii.gz"))
        nifti.save(nifti.NiftiImage(mov, np.eye(4)), os.path.join(d, "mov.nii.gz"))
        cfg = conf.InferenceConfig.from_dict(dict(settings))
        kw = {"device": "cpu"} if side == "port" else {}
        registrar = reg.Registrar(cfg, reg.load_params_any(CKPT, cfg), **kw)
        runs[side] = reg.register(cfg, registrar, os.path.join(d, "fx.nii.gz"),
                                  os.path.join(d, "mov.nii.gz"), fx_contrast="T2w",
                                  naming="standalone", res_dir=os.path.join(d, "res"))
    assert tconf.InferenceConfig.from_dict(dict(settings)).enc == [256] * 4
    assert assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"), field_ulps=4.0)
    assert runs["port"]["warp"].shape == (32, 32, 32, 1, 3)


def _maxpool2(a):
    B, X, Y, Z, C = a.shape
    return a.reshape(B, X // 2, 2, Y // 2, 2, Z // 2, 2, C).max(axis=(2, 4, 6))


def _up2(a):
    return a.repeat(2, 1).repeat(2, 2).repeat(2, 3)


def _jax_int8_inputs(blocks) -> dict:
    """The input of each int8 conv of the JAX forward, rebuilt from the
    captured block outputs (enc_0 unfused on the CPU)."""
    e = [blocks[f"enc_{i}"] for i in range(4)]
    d = [blocks[f"dec_{i}"] for i in range(4)]
    return {"enc_1": _maxpool2(e[0]), "enc_2": _maxpool2(e[1]), "enc_3": _maxpool2(e[2]),
            "dec_0": _maxpool2(e[3]),
            "dec_1": np.concatenate([_up2(d[0]), e[3]], -1),
            "dec_2": np.concatenate([_up2(d[1]), e[2]], -1),
            "dec_3": np.concatenate([_up2(d[2]), e[1]], -1),
            "final_0": d[3], "final_1": blocks["final_0"]}


def _quantized(x, amax):
    a = np.maximum(np.float32(amax), np.float32(1e-12)) / np.float32(127)
    inv = np.float32(1) / a
    return np.clip(np.round(np.asarray(x, np.float32) * inv), -127, 127)


@pytest.mark.parametrize("dtype,first_share,share_limit,max_step,tol_warp,tol_moved", [
    ("float32", 1e-4, 1e-4, 1, 1e-4, 1e-4),
    ("bfloat16", 0.01, 0.3, 2, 0.1, 0.05),
])
def test_w256_int8_forward_with_the_sidecar_matches_jax(flat, dtype, first_share, share_limit,
                                                        max_step, tol_warp, tol_moved):
    mov, fx = _pair((16, 16, 16))
    want, blocks = _jax_forward(flat, dtype, "int8", mov, fx, capture=True)
    model = _port_model(flat, dtype, "int8")
    assert {k for k, blk in model.quant_blocks().items() if blk.amax is not None} == {
        f"unet/{b}/amax" for b in INT8_BLOCKS}
    inputs = {}
    hooks = [getattr(model.unet, b).register_forward_pre_hook(
        lambda mod, args, b=b: inputs.__setitem__(b, args[0].float().numpy()))
        for b in INT8_BLOCKS]
    got = _port_forward(model, mov, fx)
    for h in hooks:
        h.remove()
    scales = load_scales(SIDECAR)
    for name, x in _jax_int8_inputs(blocks).items():
        q_jax = _quantized(x, scales[f"unet/{name}/amax"])
        q_port = _quantized(inputs[name], scales[f"unet/{name}/amax"])
        assert q_port.shape == q_jax.shape, name
        step = np.abs(q_port - q_jax)
        share = float((step > 0).mean())
        assert step.max() <= max_step, (name, step.max())
        assert share <= (first_share if name == "enc_1" else share_limit), (name, share)
    np.testing.assert_allclose(got["warp"], want["warp"], atol=tol_warp, rtol=0)
    np.testing.assert_allclose(got["moved"], want["moved"], atol=tol_moved, rtol=0)
