"""int8 inference of the port (``ops/conv_int8.py``'s plain version of kernel
K8, ``models/unet.py``'s int8 route, ``models/quantize.py``, the registrar's
lazy calibration and the ``quant-calibrate`` CLI) against the JAX package's
on the CPU. The JAX side runs as its own tests run it here: the ``lax`` int8
conv with int32 accumulation (``MMREG_CONV2D_DECOMP`` unset).

Tolerances:
  * the int8 conv block: exact. The int32 sums of the same int8 inputs are
    the same integers, and the quantization and the float32 epilogue are the
    same operations in the same order, so the outputs are equal bit for bit,
    in float32 and in bf16, a clipping ``amax`` included.
  * calibration: the same keys; each ``amax`` within 1e-5 relative
    (measured 1.5e-6). The recorded maxima are of float32 activations that
    both packages compute with convs summing in their own order, so the
    largest value may differ in its last bits.
  * sidecars: the same bytes for the same scales.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.infer import cli as jcli
from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models import quantize as jq
from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.models.unet import ConvBlock as JaxConvBlock
from multimodal_registration_tpu.train.trainer import _unflatten_params
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import cli as tcli
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.models import quantize as tq
from multimodal_registration_torch.models import vxm_dense as tvd
from multimodal_registration_torch.models.unet import ConvBlock
from multimodal_registration_torch.models.weights import (
    params_from_jax, quant_from_jax, quant_to_jax)
from multimodal_registration_torch.ops import conv_int8 as ci

from _torch_port import random_flat_params

jreg = importlib.import_module("multimodal_registration_tpu.infer.register")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIDECAR = os.path.join(ROOT, "benchmarks", "learned_w256_160x160x192_26lab.npz.quant.json")
NET = dict(enc=[64, 64], dec=[64, 64, 64, 64], int_steps=3, compute_dtype="float32")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _lax_int8_conv(monkeypatch):
    monkeypatch.delenv("MMREG_CONV2D_DECOMP", raising=False)


def _jax_block(x, k, b, amax, dtype, **kw):
    variables = {"params": {"conv": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}}
    if amax is not None:
        variables["quant"] = {"amax": jnp.float32(amax)}
    out = JaxConvBlock(features=k.shape[-1], dtype=dtype, **kw).apply(
        variables, jnp.asarray(x).astype(dtype))
    return np.asarray(out.astype(jnp.float32))


def _torch_w(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("shape,cin,cout", [((1, 6, 7, 5), 64, 8), ((2, 5, 4, 6), 72, 24),
                                            ((1, 3, 3, 3), 512, 3)])
def test_int32_sums_equal_jax(shape, cin, cout):
    """From the same int8 inputs the plain K8 gives the JAX package's int32
    sums (``lax.conv_general_dilated(..., preferred_element_type=int32)``)."""
    rng = np.random.default_rng(cin + cout)
    xq = rng.integers(-127, 128, (*shape, cin)).astype(np.int8)
    kq = rng.integers(-127, 128, (3, 3, 3, cin, cout)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape, ("NXYZC", "XYZIO", "NXYZC"))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (1, 1, 1), "SAME", dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    got = ci.int8_conv_sums_plain(torch.from_numpy(xq), _torch_w(kq)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amax", [2.5, 0.7])  # 0.7 clips: |x| reaches about 4
@pytest.mark.parametrize("shape,cin,cout", [((2, 7, 8, 9), 64, 24), ((1, 5, 6, 4), 96, 7)])
def test_int8_block_equals_jax_bit_for_bit(dtype, amax, shape, cin, cout):
    rng = np.random.default_rng(cin * cout)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    k = rng.normal(scale=0.05, size=(3, 3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(cout,)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = _jax_block(x, k, b, amax, jdt, quant="int8")
    block = ConvBlock(cin, cout, tdt, "cpu", quant="int8")
    with torch.no_grad():
        block.conv.weight.copy_(_torch_w(k))
        block.conv.bias.copy_(torch.from_numpy(b))
    block.amax = amax
    with torch.inference_mode():
        got = block(torch.from_numpy(x).to(tdt))
        sums = ci.conv3_int8(torch.from_numpy(x).to(tdt), _torch_w(k), torch.from_numpy(b),
                             amax, sums=True)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the sums are those of the quantized operands, and clip at +-127 x 127 per term
    xq = ci.quantize_act(torch.from_numpy(x).to(tdt), amax)
    assert int(xq.abs().max()) <= 127 and (amax > 2 or int(xq.abs().max()) == 127)
    assert torch.equal(sums, ci.int8_conv_sums_plain(xq, ci.quantize_weights(_torch_w(k))[0]))


def test_grid_exact_and_the_thin_and_unscaled_rules():
    """The JAX ``test_grid_exact`` rule: inputs and weights on the int8 grid
    (amax 127, every output channel's max|w| 127) make the int8 block equal to
    the float32 block; a thin input stays full precision without a scale; a
    wide one without a scale raises the JAX package's error."""
    rng = np.random.RandomState(0)
    C = 8
    x = rng.randint(-127, 128, (1, 6, 6, 6, C)).astype(np.float32)
    k = rng.randint(-126, 127, (3, 3, 3, C, C)).astype(np.float32)
    k[0, 0, 0, 0, :] = 127.0
    b = rng.normal(0, 1, (C,)).astype(np.float32)
    blocks = {q: ConvBlock(C, C, torch.float32, "cpu", quant=q, quant_min_cin=4)
              for q in ("", "int8")}
    for blk in blocks.values():
        with torch.no_grad():
            blk.conv.weight.copy_(_torch_w(k))
            blk.conv.bias.copy_(torch.from_numpy(b))
    blocks["int8"].amax = 127.0
    with torch.inference_mode():
        ref, got = (blocks[q](torch.from_numpy(x)).numpy() for q in ("", "int8"))
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(got, _jax_block(x, k, b, 127.0, jnp.float32, quant="int8",
                                                  quant_min_cin=4))

    thin = ConvBlock(2, 8, torch.float32, "cpu", quant="int8")
    assert not thin.quantizable
    wide = ConvBlock(64, 8, torch.float32, "cpu", quant="int8")
    assert wide.quantizable
    with pytest.raises(ValueError, match="calibrated activation scales"):
        wide(torch.zeros(1, 4, 4, 4, 64))


def _nets(cfg_dict, seed):
    jcfg = jvd.VxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg_dict.items()})
    flat = random_flat_params(jcfg, seed, scale=0.05, flow_scale=0.05)
    tcfg = tvd.VxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg_dict.items()})
    return jcfg, _unflatten_params(jvd.params_template(jcfg), flat), tcfg, params_from_jax(flat, tcfg), flat


def _pairs(n, shape=(32, 32, 32), seed=21):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, *shape, 1).astype(np.float32), rng.rand(1, *shape, 1).astype(np.float32))
            for _ in range(n)]


def _assert_same_scales(got, want_jax):
    want = quant_from_jax(want_jax)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_calibrate_scales_matches_jax():
    jcfg, jparams, tcfg, sd, _ = _nets(NET, 0)
    pairs = _pairs(2)
    want = jq.calibrate_scales(jcfg, jparams, pairs)
    got = tq.calibrate_scales(tcfg, sd, pairs, device="cpu")
    # every conv but enc_0 (2 input channels) is at least 64 wide
    assert set(got) == {f"unet/{b}/amax" for b in ("enc_1", "dec_0", "dec_1", "final_0", "final_1")}
    _assert_same_scales(got, want)
    # the running maximum over the pairs, times the margin, in float32
    one = tq.calibrate_scales(tcfg, sd, pairs[:1], margin=1.0, device="cpu")
    both = tq.calibrate_scales(tcfg, sd, pairs, margin=1.0, device="cpu")
    assert all(both[k] >= one[k] and got[k] == both[k] * np.float32(1.25) for k in got)
    with pytest.raises(ValueError, match="at least one"):
        tq.calibrate_scales(tcfg, sd, [], device="cpu")
    # nets with no quantizable conv record nothing
    _, _, tthin, sthin, _ = _nets(dict(NET, enc=[16, 16], dec=[16] * 4), 1)
    assert tq.calibrate_scales(tthin, sthin, pairs[:1], device="cpu") == {}


def test_sidecars_are_byte_equal_and_the_in_repo_sidecar_loads(tmp_path):
    scales = {"unet/enc_1/amax": np.float32(2.05078125), "unet/dec_3/amax": np.float32(0.1),
              "unet/final_0/amax": np.float32(7.578125)}
    tq.save_scales(str(tmp_path / "port.json"), scales)
    jq.save_scales(str(tmp_path / "jax.json"), quant_to_jax(scales))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert tq.load_scales(str(tmp_path / "port.json")) == scales

    loaded = tq.load_scales(SIDECAR)
    assert set(loaded) == {f"unet/{b}/amax" for b in (
        "enc_1", "enc_2", "enc_3", "dec_0", "dec_1", "dec_2", "dec_3", "final_0", "final_1")}
    assert loaded == quant_from_jax(jax.device_get(jq.load_scales(SIDECAR)))
    # written back, it is the in-repo file byte for byte
    tq.save_scales(str(tmp_path / "again.json"), loaded)
    with open(SIDECAR, "rb") as f:
        assert (tmp_path / "again.json").read_bytes() == f.read()

    cfg = tconf.InferenceConfig.from_dict(dict(NET))
    assert tq.sidecar_kwargs(str(tmp_path / "w.npz"), cfg) == {}
    qcfg = tconf.InferenceConfig.from_dict(dict(NET, quantize="int8"))
    kw = tq.sidecar_kwargs(SIDECAR[:-len(".quant.json")], qcfg)
    assert kw["quant_scales"] == loaded and kw["quant_sidecar"] == SIDECAR


def test_lazy_calibration_persists_caches_and_repeats(tmp_path, monkeypatch):
    """A registrar without scales calibrates on its first chunk, writes the
    sidecar (as the JAX registrar does for the same pair), keeps the scales
    and repeats itself on a second predict; one built through
    ``sidecar_kwargs`` reads the file and never calibrates."""
    cfg_d = dict(NET, quantize="int8")
    _, jparams, _, sd, _ = _nets(NET, 2)
    rng = np.random.RandomState(21)
    mov, fx = (rng.rand(1, 32, 32, 32).astype(np.float32) for _ in range(2))

    jpath = str(tmp_path / "jax_w.npz")
    jcfg = jconf.InferenceConfig.from_dict(dict(cfg_d))
    jreg.Registrar(jcfg, jparams, **jq.sidecar_kwargs(jpath, jcfg)).predict(mov, fx)

    path = str(tmp_path / "w.npz")
    cfg = tconf.InferenceConfig.from_dict(dict(cfg_d))
    kw = tq.sidecar_kwargs(path, cfg)
    assert kw["quant_scales"] is None
    reg = treg.Registrar(cfg, sd, device="cpu", **kw)
    m1, w1 = reg.predict(mov, fx)
    assert os.path.exists(tq.sidecar_path(path))
    scales = reg.quant_scales
    assert scales == tq.load_scales(tq.sidecar_path(path))
    _assert_same_scales(scales, jq.load_scales(jq.sidecar_path(jpath)))

    def boom(*a, **k):
        raise AssertionError("calibrate_scales called again")

    monkeypatch.setattr(tq, "calibrate_scales", boom)
    m2, w2 = reg.predict(mov, fx)
    assert reg.quant_scales is scales
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(m1, m2)
    kw2 = tq.sidecar_kwargs(path, cfg)
    assert kw2["quant_scales"] == scales
    _, w3 = treg.Registrar(cfg, sd, device="cpu", **kw2).predict(mov, fx)
    np.testing.assert_array_equal(w1, w3)


def test_persist_never_raises(tmp_path):
    assert not treg.persist_quant_sidecar("", {"unet/enc_1/amax": np.float32(1)})
    assert not treg.persist_quant_sidecar(str(tmp_path / "w.json"), {})
    with pytest.warns(UserWarning, match="could not persist"):
        assert not treg.persist_quant_sidecar(str(tmp_path / "no" / "dir" / "w.json"),
                                              {"unet/enc_1/amax": np.float32(1)})


def _write_pair(d, shape=(40, 44, 36), zeros=False):
    rng = np.random.RandomState(3)
    for name in ("fx", "mov"):
        g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
        data = np.zeros(shape) if zeros else np.exp(-(g ** 2).sum(0) * 4) + 0.05 * rng.rand(*shape)
        jnifti.save(jnifti.NiftiImage(data.astype(np.float32), np.eye(4)),
                    os.path.join(d, f"{name}.nii.gz"))
    return f"{d}/fx.nii.gz,{d}/mov.nii.gz"


@pytest.mark.parametrize("use_subvol", [False, True])
def test_quant_calibrate_cli_writes_the_jax_clis_file(tmp_path, use_subvol):
    """The same pairs (through the same preprocessing, tiles included) and
    ``--out`` give the JAX CLI's sidecar; then the pair CLI runs int8 from it
    without calibrating."""
    cfg_d = dict(NET, quantize="int8", use_subvol=use_subvol, subvol_size=[32, 32, 32])
    _, _, _, _, flat = _nets(NET, 3)
    model = str(tmp_path / "w.npz")
    np.savez(model, **flat)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_d, f)
    pair = _write_pair(str(tmp_path))
    common = ["--model-path", model, "--config-path", cfg_path, "--pair", pair,
              "--one-cpu-tf", "False"]
    jout = jcli.quant_calibrate(common + ["--out", str(tmp_path / "jax.json")])
    tout = tcli.quant_calibrate(common + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert tout == str(tmp_path / "port.json") and not os.path.exists(tq.sidecar_path(model))
    with open(jout) as f:
        want = json.load(f)
    with open(tout) as f:
        got = json.load(f)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)

    # with no --out, next to the checkpoint; then the pair CLI reads it
    assert tcli.quant_calibrate(common + ["--device", "cpu"]) == tq.sidecar_path(model)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(tq, "calibrate_scales", lambda *a, **k: pytest.fail("recalibrated"))
    try:
        res = tcli.pair_registration([
            "--model-path", model, "--config-path", cfg_path, "--fx-img-path",
            f"{tmp_path}/fx.nii.gz", "--mov-img-path", f"{tmp_path}/mov.nii.gz",
            "--res-dir", str(tmp_path / "res"), "--one-cpu-tf", "False", "--device", "cpu"])
    finally:
        monkeypatch.undo()
    assert os.path.exists(res["paths"]["moved_orig"])


def test_quant_calibrate_cli_thin_net_exits_as_jax(tmp_path):
    thin = dict(NET, enc=[16, 16], dec=[16] * 4)
    _, _, _, _, flat = _nets(thin, 4)
    model = str(tmp_path / "w.npz")
    np.savez(model, **flat)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(thin, f)
    argv = ["--model-path", model, "--config-path", cfg_path,
            "--pair", _write_pair(str(tmp_path), zeros=True), "--one-cpu-tf", "False"]
    with pytest.raises(SystemExit, match="nothing to calibrate"):
        jcli.quant_calibrate(argv)
    with pytest.raises(SystemExit, match="nothing to calibrate"):
        tcli.quant_calibrate(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="FIXED,MOVING"):
        tcli.quant_calibrate(argv[:5] + ["a.nii.gz"] + argv[6:] + ["--device", "cpu"])
