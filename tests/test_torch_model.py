"""Port ``models/`` (``VxmDense``, ``Unet``, ``params_from_jax``) against the
JAX package's, on the CPU.

Tolerances:
  * flagship checkpoint in float32: atol 1e-4 on ``warp``/``svf``/``moved``/
    ``flow_fullres`` — the same float32 network, but ten 64-channel convs
    whose 1728-term sums run in another order (cuDNN/oneDNN vs XLA), and five
    squaring steps that carry those last-bit differences on;
  * a tiny random model in bfloat16: at most twice the JAX package's own
    bf16-vs-f32 difference on the same inputs — every conv output is rounded
    to bf16 on both sides, so a last-bit difference of a sum flips a rounding
    by one bf16 ulp, which is the size of the effect bf16 itself has.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.train.trainer import _flatten_params, _unflatten_params
from multimodal_registration_torch.models import vxm_dense as tvd
from multimodal_registration_torch.models.weights import params_from_jax, params_to_jax

from _torch_port import random_flat_params, synthetic_pair

CKPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                    "learned_ref_160x160x192_26lab.npz")
KEYS = ("moved", "warp", "svf", "flow_fullres")


def _flagship_flat():
    with np.load(CKPT) as z:
        return dict(z)


def _pair(shape, seed=0):
    fx, mov = synthetic_pair(shape, seed)
    return mov[None, ..., None], fx[None, ..., None]


def _jax_forward(jcfg, flat, mov, fx):
    params = _unflatten_params(jvd.params_template(jcfg), flat)
    out = jvd.VxmDense(cfg=jcfg).apply(params, jnp.asarray(mov), jnp.asarray(fx))
    return {k: np.asarray(out[k], np.float32) for k in KEYS}


def _port_forward(tcfg, flat, mov, fx):
    model = tvd.VxmDense(tcfg, device="cpu").eval()
    model.load_state_dict(params_from_jax(flat, tcfg))
    with torch.inference_mode():
        out = model(torch.from_numpy(mov), torch.from_numpy(fx))
    return {k: out[k].float().numpy() for k in KEYS}


def test_params_from_jax_round_trip_and_checks():
    flat = _flagship_flat()
    cfg = tvd.VxmConfig()
    sd = params_from_jax(flat, cfg)
    assert tuple(sd["unet.enc_0.conv.weight"].shape) == (64, 2, 3, 3, 3)
    assert tuple(sd["flow.weight"].shape) == (3, 64, 3, 3, 3)
    np.testing.assert_array_equal(sd["unet.enc_0.conv.weight"].numpy(),
                                  flat["params/unet/enc_0/conv/kernel"].transpose(4, 3, 0, 1, 2))
    back = params_to_jax(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])

    # a nested Flax params tree is flattened the same way
    tree = _unflatten_params(jvd.params_template(jvd.VxmConfig()), flat)
    sd2 = params_from_jax(tree, cfg)
    for k in sd:
        np.testing.assert_array_equal(sd2[k].numpy(), sd[k].numpy())

    missing = dict(flat)
    del missing["params/unet/dec_3/conv/bias"]
    with pytest.raises(KeyError, match="dec_3"):
        params_from_jax(missing, cfg)
    extra = dict(flat, **{"params/unet/enc_9/conv/bias": np.zeros(64, np.float32)})
    with pytest.raises(KeyError, match="enc_9"):
        params_from_jax(extra, cfg)
    bad = dict(flat, **{"params/flow/kernel": np.zeros((3, 3, 3, 64, 4), np.float32)})
    with pytest.raises(ValueError, match="flow/kernel"):
        params_from_jax(bad, cfg)
    with pytest.raises(ValueError):  # the checkpoint is enc 64, not 32
        params_from_jax(flat, tvd.VxmConfig(enc=(32,) * 4, dec=(32,) * 6))


def test_flagship_checkpoint_forward_matches_jax_f32():
    """The in-repo flagship model (enc [64]x4, dec [64]x6, int_steps 5,
    svf_res = int_res = 2) at 32^3, float32 network and payload."""
    flat = _flagship_flat()
    mov, fx = _pair((32, 32, 32))
    jcfg = jvd.VxmConfig(compute_dtype="float32", integrate_payload_dtype="")
    tcfg = tvd.VxmConfig(compute_dtype="float32", integrate_payload_dtype="")
    want = _jax_forward(jcfg, flat, mov, fx)
    got = _port_forward(tcfg, flat, mov, fx)
    assert np.abs(want["warp"]).max() > 0.5  # a real field, not the identity
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("res", [2, 1], ids=["half_grid_K3", "full_grid_K2"])
def test_tiny_random_model_bf16_matches_jax(res):
    enc, dec = (8, 8, 8, 8), (8, 8, 8, 8, 8, 8)
    common = dict(enc=enc, dec=dec, int_res=res, svf_res=res)
    flat = random_flat_params(jvd.VxmConfig(**common), seed=1)
    mov, fx = _pair((32, 32, 16), seed=2)
    j16 = _jax_forward(jvd.VxmConfig(**common), flat, mov, fx)
    j32 = _jax_forward(jvd.VxmConfig(compute_dtype="float32", integrate_payload_dtype="",
                                     **common), flat, mov, fx)
    got = _port_forward(tvd.VxmConfig(**common), flat, mov, fx)
    assert np.abs(j32["warp"]).max() > 0.5
    for k in ("warp", "moved"):
        own = np.abs(j16[k] - j32[k]).max()  # JAX's own bf16 effect
        err = np.abs(got[k] - j16[k]).max()
        assert err <= 2 * own, (k, err, own)


def test_vxm_config_from_json_dict_matches_jax():
    d = {"enc": [16, 32, 32, 32], "dec": [32] * 6, "int_steps": 7, "int_res": 1,
         "svf_res": 1, "compute_dtype": "float32", "integrate_payload_dtype": "",
         "svf_smooth_sigma": 0, "quantize": None}
    j = jvd.VxmConfig.from_json_dict(d)
    p = tvd.VxmConfig.from_json_dict(d)
    assert p.__dict__ == j.__dict__
    assert tvd.VxmConfig.from_json_dict({}).__dict__ == jvd.VxmConfig.from_json_dict({}).__dict__


def test_forward_rejects_shapes_not_multiple_of_16():
    model = tvd.VxmDense(tvd.VxmConfig(enc=(4,) * 4, dec=(4,) * 6), device="cpu")
    x = torch.zeros(1, 16, 16, 24, 1)
    with pytest.raises(ValueError, match="multiples of 16"):
        model(x, x)


def test_flat_keys_match_jax_template():
    cfg = jvd.VxmConfig(enc=(8, 16, 16, 16), dec=(16,) * 7)
    flat = _flatten_params(jvd.params_template(cfg))
    sd = params_from_jax(flat, tvd.VxmConfig(enc=cfg.enc, dec=cfg.dec))
    assert set(params_to_jax(sd)) == set(flat)
