"""Each per-layer reader, and the trace's reduction, on synthetic traces."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from perfbench import flops, harness
from perfbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000  # ns


def make_trace(units=2, info=None, rate=200.0):
    """A 10 ms window; two calls of 4 ms each, starting at 1 and 5 ms; under
    each, a U-Net span (1.0-2.5 ms of the call) and spans of every other
    layer; device operations launched inside them."""
    spans = {tr.WINDOW: [(0, 10 * MS)]}
    ops = []
    for c, base in enumerate((1 * MS, 5 * MS)):
        spans.setdefault("bench.call", []).append((base, base + 4 * MS))
        for layer, lo, hi in (("unet", 0.0, 1.5), ("flow_head", 1.5, 2.0),
                              ("integrate", 2.0, 2.5),
                              ("draw_batch", 0.0, 0.2), ("build_batch", 0.2, 0.5),
                              ("loss", 0.5, 1.5), ("backward", 1.5, 3.0),
                              ("optimizer", 3.0, 3.5)):
            spans.setdefault(f"bench.{layer}", []).append(
                (base + int(lo * MS), base + int(hi * MS)))
        # one 1 ms kernel launched in the U-Net span, running 2-3 ms after the call's start
        ops.append(("conv_kernel", base + 2 * MS, 1 * MS, base + int(0.1 * MS), "kernel"))
        # a 0.25 ms kernel from the head's span, a 0.1 ms one from the integration
        ops.append(("head_kernel", base + 3 * MS, MS // 4, base + int(1.6 * MS), "kernel"))
        ops.append(("k2", base + int(3.25 * MS), MS // 10, base + int(2.1 * MS), "kernel"))
        ops.append(("Memcpy HtoD", base + int(3.4 * MS), MS // 10, base + int(2.6 * MS),
                    "memcpy"))
    for s in spans.values():
        s.sort()
    return tr.Trace(spans[tr.WINDOW][0], spans, ops, units,
                    info or {"unit_flops": 777.8e9, "integrate_bytes": 1e6}, rate=rate)


def read(name, trace):
    return harness.reader(ROOT, name)(trace)


def test_busy_and_idle():
    t = make_trace()
    busy = 2 * (1.0 + 0.25 + 0.1 + 0.1)  # ms; the four operations do not overlap
    assert t.busy_s() == pytest.approx(busy * 1e-3)
    for name in ("idle_share.pairs", "idle_share.w256", "idle_share.train"):
        assert read(name, t) == pytest.approx(100 * (1 - busy / 10))


def test_span_readers():
    t = make_trace()
    assert read("unet_ms.pairs", t) == pytest.approx(1.0)
    assert read("head_ms.pairs", t) == pytest.approx(0.25)
    assert read("device_ops.pairs", t) == pytest.approx(4.0)
    for cells in ("pairs", "w256"):
        assert read(f"unet_ms.{cells}", t) == pytest.approx(1.0)
    # the training layers: the conv kernel was launched at 0.1 ms of the call,
    # inside draw_batch (0-0.2 ms); the head's, K2's and the copy inside backward
    assert read("synth_ms.train", t) == pytest.approx(1.0)
    assert read("forward_loss_ms.train", t) is None
    assert read("backward_ms.train", t) == pytest.approx(0.25 + 0.1 + 0.1)
    assert read("optimizer_ms.train", t) is None


def test_roofline_and_mfu():
    t = make_trace()
    least = 1e6 / flops.PEAK_HBM_BYTES
    assert read("integrate_roofline.pairs", t) == pytest.approx(100 * least / 1e-4)
    # the shares of the peak read the untraced rate, not the traced window's
    mfu = 100 * 777.8e9 * 200.0 / flops.PEAK_BF16_FLOPS
    assert read("forward_mfu", t) == pytest.approx(mfu)
    assert read("train_mfu", t) == pytest.approx(3 * mfu)
    assert read("forward_mfu", make_trace(rate=None)) is None


def test_the_idle_shares_share_one_reader():
    readers = {harness.reader(ROOT, n).__code__.co_filename
               for n in ("idle_share.pairs", "idle_share.w256", "idle_share.train")}
    assert [Path(f).name for f in readers] == ["idle_share.py"]


def test_readers_find_nothing_in_an_empty_trace():
    t = tr.Trace((0, 10 * MS), {tr.WINDOW: [(0, 10 * MS)]}, [], 0,
                 {"unit_flops": 1.0, "integrate_bytes": 1.0})
    for m in harness.load_json(ROOT / "BENCHMARK.json")["per_layer"]:
        assert read(m["name"], t) is None, m["name"]


def test_breakdown_labels_gaps_by_open_span():
    t = make_trace()
    b = t.breakdown()
    assert b["device_ops"][0] == ["conv_kernel", pytest.approx(2e-3)]
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) <= 10
    # the longest gap: 0-3 ms of the window, open span at 0 ms: none
    gap, secs = b["idle_gaps"][0]
    assert secs == pytest.approx(3e-3) and gap == "none"
    assert all(isinstance(g[0], str) for g in b["idle_gaps"])


class FakeEvent:
    def __init__(self, name, dev, start, dur, corr=0, linked=0):
        self._v = (name, dev, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_parse_matches_kernels_to_launches_and_spans():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        FakeEvent(tr.WINDOW, cpu, 0, 100),
        FakeEvent("bench.unet", cpu, 10, 20),
        FakeEvent("aten::conv3d", cpu, 11, 5, corr=7),
        FakeEvent("cudaLaunchKernel", cpu, 12, 1, corr=41, linked=7),
        FakeEvent("aten::copy_", cpu, 39, 5, corr=8),
        FakeEvent("cudaMemcpyAsync", cpu, 40, 1, corr=42, linked=8),
        FakeEvent("some_kernel", cuda, 50, 10, corr=41, linked=7),
        FakeEvent("Memcpy DtoH (Device -> Pageable)", cuda, 70, 5, corr=42, linked=8),
        FakeEvent("bench.unet", cuda, 50, 10, corr=2),  # the annotation's device projection
    ]
    t = tr.parse(events, 1, {})
    assert [op[0] for op in t.ops] == ["some_kernel", "Memcpy DtoH (Device -> Pageable)"]
    assert [op[3] for op in t.ops] == [12, 40]
    assert [op[4] for op in t.ops] == ["kernel", "memcpy"]
    assert [op[0] for op in t.under("unet")] == ["some_kernel"]
    assert t.unmatched == 0 and t.busy_s() == pytest.approx(15e-9)


def test_profiled_records_the_spans_and_not_every_operator():
    x = torch.ones(8, 8)
    with tr.profiled() as events:
        with tr.record_function(tr.WINDOW):
            with tr.record_function("bench.call"):
                for _ in range(20):
                    x = (x * 1.5).tanh()
    names = [e.name() for e in events()]
    assert tr.WINDOW in names and "bench.call" in names
    assert not [n for n in names if n.startswith("aten::")]


def test_spans_wrap_and_restore():
    class Obj:
        def f(self, x):
            return x + 1

    o = Obj()
    mod = type(torch)("fake_mod")
    mod.g = lambda x: x * 2
    original_g = mod.g
    spans = tr.Spans()
    spans.wrap(o, "f", "f")
    spans.wrap(mod, "g", "g")
    lin = torch.nn.Linear(2, 2)
    spans.hook(lin, "lin")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            assert o.f(1) == 2 and mod.g(2) == 4
            lin(torch.zeros(1, 2))
    spans.close()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"bench.f", "bench.g", "bench.lin"} <= names
    assert "f" not in vars(o) and mod.g is original_g
    assert not lin._forward_hooks and not lin._forward_pre_hooks
