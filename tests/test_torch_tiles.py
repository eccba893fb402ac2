"""Subvolume registration on the device (``Registrar.register_tensors`` with
``use_subvol``) against the plain tiled reference of the benchmark
(``perfbench/reference/tiles.py``), and that reference's grid and blend
against the JAX package's, on the CPU in float32 at widths 8.

A 32x32x48 volume in tiles of 16x16x32 with the least overlap 0.1: 3 x 3 x
2 = 18 tiles, in 5 chunks of ``max_batch`` 4, the last padded to 4.

Tolerances: the reference's tile coordinates equal the JAX package's; its
blend within 1e-6 of the JAX package's (the same float32 products, summed in
the same tile order); the program against the reference: the field within
one bfloat16 ulp (2**-8) of its largest magnitude and the moved volume within
1e-3 (intensities in [0, 1]), since both store the integration's gathered
values in bfloat16 (the configuration's payload) and a float32 sum that
differs in its last bit can round to the neighbouring bfloat16 value (read:
1.8e-4 and 7.6e-6); ``register()`` equal to
``register_tensors`` bit for bit (the same operations on the same
device)."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_registration_tpu.infer import blend as jblend
from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.infer.preprocess import preprocess
from multimodal_registration_torch.utils import nifti as tnifti
from multimodal_registration_torch.utils import profiling
from perfbench import flops_tiles, harness
from perfbench.reference import model as ref_model
from perfbench.reference import tiles as ref_tiles

from _torch_port import rand, synthetic_pair

# the JAX infer package re-exports functions named like these modules
jpre = importlib.import_module("multimodal_registration_tpu.infer.preprocess")

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (32, 32, 48)
SUBVOL = dict(use_subvol=True, subvol_size=[16, 16, 32], min_perc_overlap=0.1)
ARCH = dict(enc=[8] * 4, dec=[8] * 6, int_steps=5, int_res=2, svf_res=2,
            compute_dtype="float32")
MODEL = dict(ARCH, payload="bfloat16")  # the reference's reading of the same network
LIMITS = harness.load_json(ROOT / "perfbench" / "limits" / "w256_subvol.tiles.json")


@pytest.fixture(scope="module")
def setup():
    """A registrar with weights drawn as the benchmark draws them, the
    pair, and one ``register_tensors`` of it."""
    # the head's std makes the field a few voxels at widths 8
    weights = ref_model.make_weights(2**31 + 11, MODEL, 1.0, torch.device("cpu"))
    cfg = tconf.InferenceConfig.from_dict(dict(ARCH, **SUBVOL))
    reg = treg.Registrar(cfg, weights, max_batch=4, device="cpu")
    fx, mov = (torch.as_tensor(a) for a in synthetic_pair(SHAPE, seed=3))
    return weights, cfg, reg, mov, fx, reg.register_tensors(mov, fx)


def test_register_tensors_matches_the_plain_tiled_reference(setup):
    weights, _, _, mov, fx, (moved, field, scale) = setup
    ref_moved, ref_field = ref_tiles.register(weights, mov, fx, MODEL, SUBVOL["subvol_size"],
                                              SUBVOL["min_perc_overlap"])
    assert scale == 2 and field.shape == ref_field.shape == (16, 16, 24, 3)
    assert moved.shape == SHAPE
    top = float(ref_field.abs().max())
    assert top > 0.2  # a real field, not the identity
    assert float((field - ref_field).abs().max()) <= 2.0**-8 * top
    assert float((moved - ref_moved).abs().max()) <= 1e-3


@pytest.mark.parametrize("vol, subvol, perc", [
    ((160, 160, 192), [80, 80, 96], 0.1),
    (SHAPE, [16, 16, 32], 0.1),
    ((32, 48, 40), [16, 16, 16], 0.25),
    ((48, 40, 64), [20, 16, 33], 30),  # a size floored to 16, a share given in percent
    ((64, 32, 32), [32, 16, 16], 0),  # a share that is not positive reads 0.1
])
def test_reference_grid_equals_the_jax_package(vol, subvol, perc):
    cfg = jconf.InferenceConfig.from_dict(dict(use_subvol=True, subvol_size=subvol,
                                               min_perc_overlap=perc))
    tile, coords = jpre.subvol_grid(cfg, vol)
    assert ref_tiles.grid(vol, subvol, perc) == (tuple(tile), [tuple(c) for c in coords])
    if perc == 0.1:
        assert flops_tiles.tile_count(vol, tile, perc) == len(coords)
    if vol == (160, 160, 192):
        assert len(coords) == 27 and tile == (80, 80, 96)


def test_reference_blend_equals_the_jax_package():
    tile, coords = ref_tiles.grid((32, 48, 40), [16, 16, 16], 0.25)
    half = tuple(s // 2 for s in tile)
    coords = [tuple(c // 2 for c in co) for co in coords]
    vol = (16, 24, 20)
    warps = rand((len(coords), *half, 3), seed=4)
    np.testing.assert_array_equal(ref_tiles.pyramid(half, "cpu").numpy(),
                                  jblend.pyramid_weights(half))
    want = np.asarray(jblend.blend_subvol_fields(half, vol, coords, list(warps)))
    got = ref_tiles.blend(torch.as_tensor(warps), coords, half, vol).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_register_runs_register_tensors(setup, tmp_path):
    _, cfg, reg, mov, fx, _ = setup
    paths = []
    for name, data in (("fx", fx), ("mov", mov)):
        paths.append(str(tmp_path / f"{name}.nii.gz"))
        tnifti.save(tnifti.NiftiImage(data.numpy(), np.eye(4)), paths[-1])
    out = treg.register(cfg, reg, *paths, fx_contrast="T2w")
    pre = preprocess(cfg, tnifti.load(paths[0]), tnifti.load(paths[1]), device="cpu")
    moved, field, scale = reg.register_tensors(pre.moving.get_fdata(), pre.fixed.get_fdata())
    assert out["scale"] == scale == 2
    np.testing.assert_array_equal(out["warp_data"], field.numpy())
    np.testing.assert_array_equal(out["moved"], moved.numpy())


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_register_of_a_whole_volume_runs_register_tensors(setup, tmp_path, interp):
    """Without ``use_subvol`` ``register()`` takes the same entry: its moved
    volume and field are those of ``register_tensors`` of the preprocessed
    pair, and no tile is counted."""
    weights, _, _, mov, fx, _ = setup
    cfg = tconf.InferenceConfig.from_dict(dict(ARCH, warp_interpolation=interp))
    reg = treg.Registrar(cfg, weights, device="cpu")
    paths = []
    for name, data in (("fx", fx), ("mov", mov)):
        paths.append(str(tmp_path / f"{name}.nii.gz"))
        tnifti.save(tnifti.NiftiImage(data.numpy(), np.eye(4)), paths[-1])
    out = treg.register(cfg, reg, *paths, fx_contrast="T2w")
    pre = preprocess(cfg, tnifti.load(paths[0]), tnifti.load(paths[1]), device="cpu")
    moved, field, scale = reg.register_tensors(pre.moving.get_fdata(), pre.fixed.get_fdata())
    assert out["scale"] == scale == 2 and reg.tile_counts == {"tiles": 0, "slots": 0}
    np.testing.assert_array_equal(out["warp_data"], field.numpy())
    np.testing.assert_array_equal(out["moved"], moved.numpy())


def test_spans_and_counter_once_a_subject(setup):
    weights, cfg, _, mov, fx, _ = setup
    reg = treg.Registrar(cfg, weights, max_batch=4, device="cpu")
    before = {r[3] for r in profiling.spans()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reg.register_tensors(mov, fx)
    recs = [r for r in profiling.spans() if r[3] not in before]
    names = [r[0] for r in recs]
    root = [r for r in recs if r[0] == "registrar.register_tensors"]
    assert len(root) == 1
    for name in ("registrar.cut", "registrar.predict_tensors", "registrar.blend",
                 "registrar.warp_volume"):
        (rec,) = [r for r in recs if r[0] == name]
        assert rec[4] == root[0][3], name  # nested directly under the entry
    assert names.count("vxm.unet") == 5 and "vxm.warp" not in names and "vxm.fullres" not in names
    assert reg.tile_counts == {"tiles": 18, "slots": 20}
    reg.register_tensors(mov, fx)
    assert reg.tile_counts == {"tiles": 36, "slots": 40}


def test_a_sharded_registrar_registers_the_tiles_as_one_device(setup):
    """The tiles' chunks over a ``{data: 2}`` mesh of the CPU: the same
    fields as on one device, and the counter at 18 tiles in 3 chunks of 8
    (4 a data row)."""
    from multimodal_registration_torch.infer.sharded import ShardedRegistrar
    from multimodal_registration_torch.parallel.mesh import make_mesh

    weights, cfg, _, mov, fx, (moved, field, scale) = setup
    sharded = ShardedRegistrar(cfg, weights, make_mesh(2, devices=["cpu", "cpu:0"]))
    got = sharded.register_tensors(mov, fx)
    assert got[2] == scale
    np.testing.assert_allclose(got[1].numpy(), field.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), moved.numpy(), rtol=0, atol=1e-5)
    assert sharded.tile_counts == {"tiles": 18, "slots": 24}


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_without_tiles_register_tensors_is_the_whole_pair(setup, interp):
    weights, _, _, mov, fx, _ = setup
    cfg = tconf.InferenceConfig.from_dict(dict(ARCH, warp_interpolation=interp))
    reg = treg.Registrar(cfg, weights, device="cpu")
    moved, field, scale = reg.register_tensors(mov, fx)
    want_moved, want_field = reg.predict_tensors(mov[None], fx[None])
    assert scale == 2 and reg.tile_counts == {"tiles": 0, "slots": 0}
    assert torch.equal(field, want_field[0])
    if interp == "linear":
        assert torch.equal(moved, want_moved[0])
    else:
        want = treg.apply_warp(mov, field, "nearest", rescale=2, device="cpu")
        np.testing.assert_array_equal(moved.numpy(), want)


def test_the_tiled_path_states_its_launches(setup):
    _, cfg, reg, *_ = setup
    want = reg.register_launches(SHAPE)
    fwd = reg.model.kernel_launches(with_moved=False)
    assert fwd["warp_up2x"] == 0 and "warp_up2x_launch" not in fwd
    # five chunks without a moved image, then one general warp of the volume
    assert want["warp_up2x"] == 0 and want["flow_head"] == 5 == want["conv3_lrelu_pool"]
    assert want["warp_trilinear"] == 5 * 5 + 1 and want["warp_launch"] == 1
    assert want["self_warp_add_launch"] == 25
    whole = treg.Registrar(tconf.InferenceConfig.from_dict(ARCH),
                           setup[0], device="cpu").register_launches(SHAPE)
    assert whole == reg.model.kernel_launches()


def cell_overrides() -> dict:
    flagship = harness.load_json(ROOT / "perfbench" / "configs" / "flagship64.json")["model"]
    model = {**flagship, "enc": [8] * 4, "dec": [8] * 6, "num_labels": 6,
             "in_shape": list(SHAPE), "im_scales": [4, 8, 16], "def_scales": [4, 8, 16],
             **SUBVOL}
    # a head std that makes the field about a voxel at widths 8, so that the
    # planted fault moves the volume as it does at the published widths
    return {"config": {"model": model, "compute_dtype": "float32",
                       "serving_flow_head_std": 0.3},
            "traffic": {"shape": list(SHAPE), "pairs": 2, "maps": 2, "warm_calls": 1,
                        "check_sample": 2, "trace_seconds": 1}}


CELL_RUNS = """
import argparse, contextlib, json, sys, time
from pathlib import Path
import torch
from perfbench import harness
from perfbench.drivers import tiles
over = json.loads(sys.argv[1])
args = argparse.Namespace(workload="w256_subvol.tiles", seed=2**31 + 7, seconds=0.3, trace=0)
for fault in (None, "flat_blend"):
    with tiles.FAULTS[fault]() if fault else contextlib.nullcontext():
        out = harness.run(args, Path.cwd(), time.perf_counter(), device=torch.device("cpu"),
                          overrides=over)
    print(json.dumps(out))
"""


def test_the_cell_runs_correct_and_its_fault_does_not():
    """The cell through ``perfbench/harness.py::run`` at the size above, in a
    process of its own (the benchmark refuses to run where JAX is loaded, as
    it is in this one): correct, and with ``flat_blend`` not."""
    r = subprocess.run([sys.executable, "-c", CELL_RUNS, json.dumps(cell_overrides())],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    sound, flat = (json.loads(line) for line in r.stdout.strip().splitlines()[-2:])
    for out in (sound, flat):
        assert out["attempted"] > 0 and out["failed"] == 0
        assert set(out["checks"]) == set(LIMITS) == {"moved_max_abs"}
    assert sound["correct"] is True, sound["checks"]
    assert flat["correct"] is False, flat["checks"]
