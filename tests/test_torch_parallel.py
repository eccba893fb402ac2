"""The port's multi-device inference (``parallel/``, ``infer/sharded.py``,
``infer/selftest.py``) on the CPU, against the JAX package's
``ShardedRegistrar`` on its 8 virtual CPU devices.

A port mesh on the CPU names ``cpu`` several times: the batch rows and X
slabs are split, the halos copied, as on several cards. Tolerances: the
port's sharded registrar against its own single-device ``Registrar`` and
against the JAX package's sharded registrar, float32 networks: 1e-5, but
each squaring step of the integration rounds the field to bfloat16 in both
packages, and a float32 sum that differs in its last bit (another batch per
forward, another order) can flip one of those roundings; such a flip moves
the field by one bfloat16 ulp of its magnitude (fault F2's rule) and a
moved intensity (in [0, 1], warped by the full-res field, twice the int-res
one) by no more than that field's ulp. So: within 1e-5 plus that ulp, and
99.9% of the values within 1e-5. int8 within the JAX check's 2e-5.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.infer.config import InferenceConfig as JInferenceConfig
from multimodal_registration_tpu.infer.sharded import ShardedRegistrar as JShardedRegistrar
from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodal_registration_tpu.train.trainer import _unflatten_params
from multimodal_registration_torch.infer import selftest
from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar, vxm_config_from
from multimodal_registration_torch.infer.sharded import ShardedRegistrar, make_registrar
from multimodal_registration_torch.models import quantize as tq
from multimodal_registration_torch.models.unet import ConvBlock
from multimodal_registration_torch.models.weights import params_from_jax, quant_to_jax
from multimodal_registration_torch.ops.conv_pool import conv3_lrelu_pool
from multimodal_registration_torch.parallel import mesh as tmesh
from multimodal_registration_torch.parallel import spatial

from _torch_port import bf16_ulp, random_flat_params

CFG = dict(enc=[4, 4, 4, 4], dec=[4, 4, 4, 4, 4, 4], compute_dtype="float32")
INT8 = dict(enc=[64, 64], dec=[64] * 4, int_steps=3, compute_dtype="float32")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets(arch, seed):
    """The same random weights for the JAX package (nested) and the port."""
    jcfg = jvd.VxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})
    flat = random_flat_params(jcfg, seed, scale=0.05, flow_scale=0.05)
    return (_unflatten_params(jvd.params_template(jcfg), flat),
            params_from_jax(flat, vxm_config_from(InferenceConfig.from_dict(arch))))


def _pair(b, x, seed, yz=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((b, x, yz, yz)).astype(np.float32) for _ in range(2))


def assert_same(got, want, field_max, tol=1e-5):
    """Within ``tol`` plus one bfloat16 ulp of ``field_max``, and 99.9% of
    the values within ``tol`` (the module's docstring)."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= tol + bf16_ulp(field_max), err.max()
    assert (err > tol).mean() <= 1e-3, (err > tol).mean()


def _cpu_mesh(data, space):
    return tmesh.make_mesh(data * space, space=space, devices=["cpu"] * (data * space))


# ---- the mesh ---------------------------------------------------------------

def test_mesh_shapes_and_errors():
    assert tmesh.setup_devices(None) == ([], 0)  # no card in this process
    assert tmesh.setup_devices("0,1") == ([], 0)  # indices past the last card are dropped
    cpu = torch.device("cpu")
    assert tmesh.setup_devices("cpu,cpu") == ([cpu, cpu], 2)
    assert tmesh.setup_devices(["cpu", "cpu:0"]) == ([cpu, torch.device("cpu", 0)], 2)
    m = _cpu_mesh(4, 2)
    assert m.shape == {"data": 4, "space": 2} and m.home == torch.device("cpu")
    assert m.distinct() == [torch.device("cpu")]
    assert tmesh.make_mesh(8, devices=["cpu"] * 8).shape == {"data": 8, "space": 1}
    with pytest.raises(ValueError, match="not divisible by space=4"):
        tmesh.make_mesh(6, space=4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="needs 3"):
        tmesh.make_mesh(3, devices=["cpu"] * 2)
    assert tmesh.mesh_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert tmesh.mesh_devices("cpu,cpu") == [torch.device("cpu")] * 2
    assert tmesh.first_device("cpu,cpu") == torch.device("cpu")

    x = torch.arange(4 * 32 * 2, dtype=torch.float32).reshape(4, 32, 2)
    rows = tmesh.split_rows(x, m)
    assert [r.shape[0] for r in rows] == [1] * 4
    slabs = tmesh.split_slabs(rows[1], list(m.devices[1]))
    assert [s.shape[1] for s in slabs] == [16, 16]
    assert torch.equal(tmesh.gather([tmesh.gather(slabs, "cpu", dim=1), *rows[2:]], "cpu"),
                       x[1:])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.split_rows(x[:3], m)


# ---- the sharded registrar against the JAX package's and the port's own ----

@pytest.mark.parametrize("data,space,batch,max_batch", [
    (1, 2, 1, 4),    # space 2
    (2, 1, 2, 4),    # data 2
    (2, 2, 2, 4),    # data 2 x space 2
    (4, 2, 3, 4),    # batch padding: 3 pairs on a data axis of 4
    (4, 2, 6, 2),    # chunked: chunks of 4 pairs, the last one padded
])
def test_sharded_registrar_matches_jax_and_single_device(data, space, batch, max_batch):
    jparams, params = _nets(CFG, seed=data * 10 + space + batch)
    mov, fx = _pair(batch, 32, seed=batch)
    m1, w1 = ShardedRegistrar(InferenceConfig.from_dict(CFG), params, _cpu_mesh(data, space),
                              max_batch=max_batch).predict(mov, fx)
    assert m1.shape == (batch, 32, 16, 16) and w1.shape == (batch, 16, 8, 8, 3)
    jm, jw = JShardedRegistrar(JInferenceConfig.from_dict(CFG), jparams,
                               jmake_mesh(data * space, space=space),
                               max_batch=max_batch).predict(mov, fx)
    field_max = float(np.abs(jw).max())
    assert field_max > 0.01  # a field that moves the image
    for m2, w2 in (
        (jm, jw),
        Registrar(InferenceConfig.from_dict(CFG), params, max_batch=max_batch,
                  device="cpu").predict(mov, fx),
        # chunked against one shot
        ShardedRegistrar(InferenceConfig.from_dict(CFG), params, _cpu_mesh(data, space),
                         max_batch=64).predict(mov, fx),
    ):
        assert_same(m1, m2, 2 * field_max)
        assert_same(w1, w2, field_max)


def test_distinct_devices_hold_their_own_copies():
    """``cpu`` and ``cpu:0`` are two devices of the mesh on the CPU: the
    second slab runs on a copy of the model, as on a second card."""
    _, params = _nets(CFG, seed=3)
    cfg = InferenceConfig.from_dict(CFG)
    sharded = ShardedRegistrar(cfg, params, tmesh.make_mesh(2, space=2, devices=["cpu", "cpu:0"]))
    assert len(sharded.models) == 2 and len({id(m) for m in sharded.models.values()}) == 2
    mov, fx = _pair(2, 32, seed=3)
    m1, w1 = sharded.predict(mov, fx)
    m2, w2 = Registrar(cfg, params, device="cpu").predict(mov, fx)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(w1, w2)


def test_bad_x_falls_back_with_a_warning_or_raises_when_strict():
    _, params = _nets(CFG, seed=1)
    cfg = InferenceConfig.from_dict(CFG)
    sharded = ShardedRegistrar(cfg, params, _cpu_mesh(4, 2))
    mov, fx = _pair(1, 16, seed=1)
    with pytest.raises(ValueError, match="not divisible"):
        sharded.predict(mov, fx, strict=True)
    with pytest.warns(UserWarning, match="falling back"):
        m1, w1 = sharded.predict(mov, fx)
    m2, w2 = Registrar(cfg, params, device="cpu").predict(mov, fx)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(w1, w2)


def test_make_registrar_factory():
    _, params = _nets(CFG, seed=2)
    cfg = InferenceConfig.from_dict(CFG)
    assert isinstance(make_registrar(cfg, params, device="cpu"), Registrar)
    assert make_registrar(cfg, params, device="cpu,cpu").device == torch.device("cpu")
    cfg.sharding = {"space": 2}
    reg = make_registrar(cfg, params, device="cpu")
    assert isinstance(reg, ShardedRegistrar)
    assert reg.mesh.shape == {"data": 1, "space": 2} and reg.device == torch.device("cpu")
    cfg.sharding = {"data": 4, "space": 2}
    assert make_registrar(cfg, params, device="cpu").mesh.shape == {"data": 4, "space": 2}
    with pytest.raises(ValueError, match=r"needs 8 devices, have 2"):
        make_registrar(cfg, params, device=["cpu", "cpu"])
    assert cfg.round16(100, axis=0) == 96 and cfg.round16(100, axis=1) == 96
    cfg.sharding = {"space": 3}
    assert cfg.round16(100, axis=0) == 96 and cfg.round16(40, axis=0) == 0


# ---- the slab routes and the int8 forward ------------------------------------

def test_k8_weight_cache_keeps_each_devices_entries():
    """K8's prepared weights: each device keeps its own ``_PREPARED_MAX``
    newest entries, so a second card's entries never push out the first's."""
    from multimodal_registration_torch.ops import conv_int8 as tci

    other = torch.device("cuda", 1)
    saved = dict(tci._PREPARED)
    tci._PREPARED.clear()
    try:
        for i in range(tci._PREPARED_MAX):  # a full cache of another card's
            tci._PREPARED[(i, 0, i, 0, 1.0, other, 0, (4, 64, 3, 3, 3))] = None
        rng = np.random.default_rng(5)
        keep = [(torch.tensor(rng.normal(size=(4, 64, 3, 3, 3)), dtype=torch.float32),
                 torch.zeros(4)) for _ in range(tci._PREPARED_MAX + 3)]
        for w, b in keep:
            tci.prepared_int8_weights(w, b, 2.0)
        on = {d: sum(k[5] == d for k in tci._PREPARED) for d in (other, torch.device("cpu"))}
        assert on == {other: tci._PREPARED_MAX, torch.device("cpu"): tci._PREPARED_MAX}
        w, b = keep[-1]  # the newest are kept: prepared once
        assert tci.prepared_int8_weights(w, b, 2.0)[0] is tci.prepared_int8_weights(w, b, 2.0)[0]
        w, b = keep[0]  # the oldest went first
        assert all(k[0] != w.data_ptr() for k in tci._PREPARED)
    finally:
        tci._PREPARED.clear()
        tci._PREPARED.update(saved)


def test_k1_weight_cache_keeps_each_devices_entries():
    """K1's prepared weights, as K8's: a full cache of another device's
    entries (``cpu:0``, which the mesh counts apart from ``cpu``) pushes out
    none of this device's, and each device keeps its ``_PREPARED_MAX`` newest."""
    from multimodal_registration_torch.ops import conv_pool as tcp

    other = torch.device("cpu", 0)
    saved = dict(tcp._PREPARED)
    tcp._PREPARED.clear()
    try:
        for i in range(tcp._PREPARED_MAX):
            tcp._PREPARED[(i, 0, i, 0, torch.float32, other, 0, (4, 2, 3, 3, 3))] = None
        rng = np.random.default_rng(6)
        keep = [(torch.tensor(rng.normal(size=(4, 2, 3, 3, 3)), dtype=torch.float32),
                 torch.zeros(4)) for _ in range(tcp._PREPARED_MAX + 3)]
        for w, b in keep:
            tcp.prepared_weights(w, b, torch.float32)
        on = {d: sum(k[5] == d for k in tcp._PREPARED) for d in (other, torch.device("cpu"))}
        assert on == {other: tcp._PREPARED_MAX, torch.device("cpu"): tcp._PREPARED_MAX}
        w, b = keep[-1]  # the newest are kept: prepared once
        assert (tcp.prepared_weights(w, b, torch.float32)[0]
                is tcp.prepared_weights(w, b, torch.float32)[0])
        w, b = keep[0]  # the oldest went first
        assert all(k[0] != w.data_ptr() for k in tcp._PREPARED)
    finally:
        tcp._PREPARED.clear()
        tcp._PREPARED.update(saved)


def test_k5_scratch_cache_keeps_each_devices_buffers(monkeypatch):
    """K5's scratch buffers: keyed on the device itself (``cpu`` and ``cpu:0``
    are two, as ``cuda:0`` and ``cpu:0`` are), at most ``_SCRATCH_MAX`` a
    device, the oldest going first."""
    from multimodal_registration_torch.ops import warp as tw

    monkeypatch.setattr(tw.kernels, "stream_of", lambda t: 0)
    other = torch.device("cpu", 0)
    saved = dict(tw._SCRATCH)
    tw._SCRATCH.clear()
    try:
        for n in range(1, tw._SCRATCH_MAX + 1):
            tw._SCRATCH[(other, 0, n)] = [None, False]
        like = torch.zeros(1)
        sizes = range(100, 100 + tw._SCRATCH_MAX + 3)
        for n in sizes:
            entry = tw._scratch(like, n)
            entry[1] = False  # the finishing kernel was enqueued
        on = {d: sum(k[0] == d for k in tw._SCRATCH) for d in (other, like.device)}
        assert on == {other: tw._SCRATCH_MAX, like.device: tw._SCRATCH_MAX}
        newest = tw._scratch(like, sizes[-1])  # kept: the same buffer
        assert newest is tw._SCRATCH[(like.device, 0, sizes[-1])] and newest[0].numel() == sizes[-1]
        newest[1] = False
        assert (like.device, 0, sizes[0]) not in tw._SCRATCH  # the oldest went first
    finally:
        tw._SCRATCH.clear()
        tw._SCRATCH.update(saved)


def test_slab_k1_and_conv_routes_match_the_whole_volume_at_a_ragged_x():
    """enc_0 on K1 (here its plain version, as on every CPU tensor) with a
    halo of 2, and a 3^3 conv with a halo of 1, over three slabs of a volume
    whose X (36) no tile divides, against the unsharded calls."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 36, 10, 12, 2)).astype(np.float32))
    block = ConvBlock(2, 6, torch.float32, "cpu")
    with torch.no_grad():
        block.conv.weight.normal_(0, 0.3)
        block.conv.bias.normal_(0, 0.1)
    layers = spatial.Slabs([type("U", (), {"enc_0": block})()] * 3)
    slabs = tmesh.split_slabs(x, ["cpu"] * 3)
    with torch.inference_mode():
        pooled = torch.cat(layers.conv_pooled("enc_0", slabs), dim=1)
        convd = torch.cat(layers.conv("enc_0", slabs), dim=1)
        want = conv3_lrelu_pool(x, block.conv.weight, block.conv.bias, 0.2, impl="plain")
        want_conv = block(x)
    assert pooled.shape == want.shape == (2, 18, 5, 6, 6)
    torch.testing.assert_close(pooled, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(convd, want_conv, rtol=0, atol=1e-5)
    # halos: a neighbour's planes inside, zeros at the volume's ends
    h = spatial.with_halo(slabs, 2)
    assert torch.equal(h[1][:, :2], slabs[0][:, -2:]) and torch.equal(h[1][:, -2:], slabs[2][:, :2])
    assert not h[0][:, :2].any() and not h[2][:, -2:].any()


def test_slab_calibration_equals_the_whole_volume():
    """The maxima of |x| over slabs with their halos are the whole volume's."""
    _, params = _nets(INT8, seed=6)
    cfg = InferenceConfig.from_dict(dict(INT8, quantize="int8"))
    sharded = ShardedRegistrar(cfg, params, _cpu_mesh(2, 2))
    mov, fx = (torch.as_tensor(a) for a in _pair(2, 32, seed=6))
    rows = sharded._rows(mov, fx)
    slab_scales = spatial.calibrate_slabs(sharded.models, rows)
    whole = tq.calibrate_scales(sharded.vxm_cfg, params, [(mov[..., None], fx[..., None])],
                                device="cpu")
    assert sorted(slab_scales) == sorted(whole) and len(whole) == 5  # every conv but enc_0
    # the maxima of the same activations: equal but for the last bits of
    # float32 conv sums, which on slab shapes run in another order
    for k in whole:
        np.testing.assert_allclose(slab_scales[k], whole[k], rtol=1e-5, err_msg=k)
    # the lazy calibration of a sharded registrar writes those scales
    sharded._ensure_scales(rows)
    assert sharded.quant_scales == slab_scales


def test_int8_sharded_forward_matches_jax(tmp_path):
    """The JAX ``int8_sharded_forward_check`` configuration and shapes
    (enc [64]x2, dec [64]x4, 16*space cubes): the port's sharded int8
    forward against the JAX package's sharded one, both on the JAX
    calibration's scales, and the port's whole selftest."""
    jparams, params = _nets(INT8, seed=13)
    jparams = jax.tree_util.tree_map(lambda a: a * 0.4, jparams)  # scale 0.02, as there
    params = {k: v * 0.4 for k, v in params.items()}
    mov, fx = _pair(1, 32, seed=13)
    from multimodal_registration_tpu.models import quantize as jq

    jcfg = JInferenceConfig.from_dict(dict(INT8, quantize="int8"))
    jscales = jq.calibrate_scales(jvd.VxmConfig(enc=(64, 64), dec=(64,) * 4, int_steps=3,
                                                compute_dtype="float32"),
                                  jparams, [(mov[..., None], fx[..., None])])
    flat = {f"unet/{b}/amax": np.float32(v["amax"]) for b, v in jscales["unet"].items()}
    assert quant_to_jax(flat) == {"unet": {b: {"amax": v["amax"]}
                                           for b, v in jscales["unet"].items()}}
    jm, jw = JShardedRegistrar(jcfg, jparams, jmake_mesh(2, space=2),
                               quant_scales=jscales).predict(mov, fx)
    tcfg = InferenceConfig.from_dict(dict(INT8, quantize="int8"))
    m1, w1 = ShardedRegistrar(tcfg, params, _cpu_mesh(1, 2), quant_scales=flat).predict(mov, fx)
    np.testing.assert_allclose(w1, jw, atol=2e-5, rtol=0)
    np.testing.assert_allclose(m1, jm, atol=2e-5, rtol=0)
    selftest.int8_sharded_forward_check(2)


@pytest.mark.parametrize("check", ["cli_space_parity_check", "cli_cascade_space_parity_check"])
def test_selftest_cli_checks(check, tmp_path):
    getattr(selftest, check)(2, str(tmp_path), seed=3)


def test_selftest_catches_a_wrong_halo(tmp_path, monkeypatch):
    """The checks are not vacuous: with the halos left as zeros (SAME
    padding at every slab's edge), the sharded CLI's outputs differ."""
    real = spatial.with_halo

    def zero_halo(slabs, h):
        return [torch.cat([s.new_zeros((s.shape[0], h, *s.shape[2:])), s,
                           s.new_zeros((s.shape[0], h, *s.shape[2:]))], dim=1) for s in slabs]

    monkeypatch.setattr(spatial, "with_halo", zero_halo)
    with pytest.raises(AssertionError, match="sharded CLI"):
        selftest.cli_space_parity_check(2, str(tmp_path), seed=3)
    monkeypatch.setattr(spatial, "with_halo", real)


def test_run_batch_with_space_sharding_writes_the_same_tree(tmp_path):
    """``run_batch(sharding={"space": 2})`` on the pipeline tests' tiny BIDS
    tree (40x40x32 volumes, X cut to 32, two slabs of 16) writes the tree
    of the unsharded run: the same files, NIfTI volumes within the selftest's
    2e-4, the same CSV rows but for the time of writing."""
    from multimodal_registration_torch.pipeline import run_batch
    from multimodal_registration_torch.utils import nifti as tnifti

    from _torch_port import output_files
    from test_torch_pipeline import CSVS, TINY as PTINY, _csv_rows, _make_bids, _weights

    data = _make_bids(str(tmp_path))
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(PTINY, f)
    w = _weights(str(tmp_path), 1)
    outs = {}
    for tag, sharding in (("single", None), ("sharded", {"space": 2, "data": None})):
        outs[tag] = str(tmp_path / tag)
        results, summary = run_batch(data, outs[tag], w, config_path=cfg, sharding=sharding,
                                     fx_contrast="T2w", mov_contrast="T1w", device="cpu")
        assert summary["n_ok"] == 2, [r.error for r in results]
    assert output_files(outs["sharded"]) == output_files(outs["single"])
    for name in output_files(outs["single"]):
        a, b = (os.path.join(outs[t], name) for t in ("single", "sharded"))
        if name.endswith(".nii.gz"):
            np.testing.assert_allclose(tnifti.load(b).get_fdata(), tnifti.load(a).get_fdata(),
                                       atol=2e-4, rtol=0, err_msg=name)
    for name in CSVS:
        ha, ra = _csv_rows(os.path.join(outs["single"], "data_processed", name))
        hb, rb = _csv_rows(os.path.join(outs["sharded"], "data_processed", name))
        assert ha == hb and [r[1:] for r in rb] == [r[1:] for r in ra], name


def test_dryrun_multichip_on_the_cpu():
    from multimodal_registration_torch.tools.dryrun_multichip import dryrun_multichip, main

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback may warn
        line = main(["2", "--device", "cpu"])
    assert "params allclose" in line and "cascade CLI ok" in line
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        dryrun_multichip(2, device=["cpu"])
    assert os.path.exists(os.path.join(os.path.dirname(__file__), "..",
                                       "multimodal_registration_torch", "tools",
                                       "dryrun_multichip.py"))
