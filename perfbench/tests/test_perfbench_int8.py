"""The int8 cell ``w256_int8.int8_pairs`` on the CPU: the plain int8
reference's sums and quantization, the int8 yardstick, and whole runs at
32^3 with width 64, where every conv but the first is int8 (at the width 8
of ``test_perfbench_cells.py`` none is)."""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, flops, flops_int8, harness
from perfbench.drivers import pairs_int8
from perfbench.reference import int8 as ref_int8
from perfbench.reference import model as ref_model
from perfbench.tests.test_perfbench_cells import small

ROOT = Path(__file__).resolve().parents[2]
CELL = "w256_int8.int8_pairs"
CPU = torch.device("cpu")
LIMITS = harness.load_json(ROOT / "perfbench" / "limits" / f"{CELL}.json")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(seed: int = 2**31 + 11) -> dict:
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5, trace=0)
    return harness.run(args, ROOT, time.perf_counter(), device=CPU,
                       overrides=small(CELL, width=64))


def taps_loop(xq, wq):
    """The conv's sums in float64, tap by tap and channel by channel."""
    B, cin, X, Y, Z = xq.shape
    xp = torch.nn.functional.pad(xq.double(), (1, 1, 1, 1, 1, 1))
    out = torch.zeros((B, wq.shape[0], X, Y, Z), dtype=torch.float64)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                tap = xp[:, :, dx:dx + X, dy:dy + Y, dz:dz + Z]
                for c in range(cin):
                    out += tap[:, c, None] * wq[None, :, c, dx, dy, dz, None, None, None].double()
    return out


def test_int8_sums_are_exact_above_two_to_the_24():
    from multimodal_registration_torch.ops.conv_int8 import int8_conv_sums_plain

    g = torch.Generator().manual_seed(1)
    xq = torch.randint(-127, 128, (1, 512, 3, 4, 5), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (6, 512, 3, 3, 3), generator=g, dtype=torch.int8)
    xq[..., :3, :3, :3] = 127  # output (1, 1, 1) of channel 0 reaches 27 * 512 * 127**2
    wq[0] = 127
    got = ref_int8.conv_sums(xq, wq)
    assert got.abs().max() == 27 * 512 * 127 ** 2 > 2 ** 24
    assert torch.equal(got, taps_loop(xq, wq))
    port = int8_conv_sums_plain(xq.permute(0, 2, 3, 4, 1), wq).permute(0, 4, 1, 2, 3)
    assert torch.equal(got, port.double())


def test_quantization_equals_the_port():
    from multimodal_registration_torch.ops import conv_int8

    g = torch.Generator().manual_seed(2)
    w = torch.randn((16, 64, 3, 3, 3), generator=g) * 0.03
    x = torch.randn((1, 5, 6, 7, 64), generator=g) * 2.0
    for amax in (0.5, 3.7, 11.0):
        assert torch.equal(ref_int8.quantize_act(x, amax), conv_int8.quantize_act(x, amax))
    wq, w_scale = ref_int8.quantize_weights(w)
    pq, p_scale = conv_int8.quantize_weights(w)
    assert torch.equal(wq, pq) and torch.equal(w_scale, p_scale)


def test_int8_ops_and_quantize_bytes():
    shape, enc, dec = (160, 160, 192), [256] * 4, [256] * 6
    assert round(flops_int8.int8_ops(shape, enc, dec) / 1e12, 4) == 11.7932
    assert round(flops_int8.quantize_bytes(shape, enc, dec) / 1e9, 4) == 2.5593
    # the rest of the forward: enc_0, the head, the integration and the warp
    leaves = ref_model.conv_leaves(enc, dec, 2)
    assert [ci >= 64 for _, ci, _ in leaves[1:-1]] == [True] * 9
    full, half = math.prod(shape), math.prod(s // 2 for s in shape)
    (_, ci0, co0), (_, cih, coh) = leaves[0], leaves[-1]
    rest = (2 * full * 27 * ci0 * co0 + 2 * half * 27 * cih * coh + 5 * half * 24 * 3
            + full * 24)
    total = flops.forward_flops(shape, enc, dec)
    assert total - flops_int8.int8_ops(shape, enc, dec) == pytest.approx(rest, rel=1e-12)


def test_configuration_is_one_of_its_own():
    # a configuration with the source and the cuts of another is that other one
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    keys = [(c["source"], tuple(c["reduced"])) for c in bench["configs"]]
    assert len(set(keys)) == len(keys)
    cfg = next(c for c in bench["configs"] if c["name"] == "w256_int8")
    data = harness.load_json(ROOT / cfg["file"])
    assert data["quantize"] == "int8" and "int8" in cfg["source"]


def test_scale_keys_map_onto_the_reference_blocks():
    assert pairs_int8.block_of("unet/final_1/amax") == "unet.final_1"
    assert pairs_int8.scale_gap({}, {}) == 0.0
    assert pairs_int8.scale_gap({"a": 1.1}, {"a": 1.0}) == pytest.approx(0.1)
    assert pairs_int8.scale_gap({"a": 1.0}, {"b": 1.0}) == float("inf")


@pytest.mark.parametrize("seed", [2**31 + 11, 5400000007])
def test_cell_is_correct(seed):
    out = run(seed)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"moved_max_abs", "warp_max_rel", "scale_max_rel"}
    assert 0 < out["checks"]["scale_max_rel"]["value"]


@pytest.mark.parametrize("arm", ["control", "fault:amax_halved"])
def test_control_and_fault_read_above_the_limits(arm):
    got = control.reading(ROOT, CELL, 7, 0.3, arm, CPU, small(CELL, width=64))["numbers"]
    over = [k for k, limit in LIMITS.items() if got[k] > limit]
    assert over, got
    assert got["scale_max_rel"] > LIMITS["scale_max_rel"]


def test_altered_answer_is_not_correct(monkeypatch):
    from multimodal_registration_torch.infer import register

    real = register.Registrar.predict_tensors

    def altered(self, mov, fx):
        moved, warp = real(self, mov, fx)
        moved = moved.clone()
        moved[0, 5, 5, 5] += 0.5
        return moved, warp

    monkeypatch.setattr(register.Registrar, "predict_tensors", altered)
    out = run()
    assert out["correct"] is False
    assert out["checks"]["moved_max_abs"]["value"] >= 0.4
