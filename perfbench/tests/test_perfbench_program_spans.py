"""The readers of the program's own spans (``perfbench/program_spans.py``
and the metrics that use it) on a synthetic trace and synthetic span
records."""

from __future__ import annotations

from pathlib import Path

import pytest

from perfbench import harness
from perfbench import trace as tr
from multimodal_registration_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000  # ns
T0 = 1_800_000_000 * 10**9  # the window opens here, on the Unix-epoch clock


def read(name, trace):
    return harness.reader(ROOT, name)(trace)


def at(ms: float) -> int:
    return T0 + int(round(ms * MS))


def make_trace(units=2):
    """A 10 ms window. Device operations (start, duration, launch) in ms:
    under each of two calls at 1 and 5 ms, a 1 ms op running 2-3 ms after
    the call began (launched at +0.2), and two ops of the tail, 0.1 and 0.05
    ms, launched at +2.1 and +2.2, running at +3.0 and +3.1."""
    ops = []
    for base in (1.0, 5.0):
        ops.append(("conv", at(base + 2.0), MS, at(base + 0.2), "kernel"))
        ops.append(("k2", at(base + 3.0), MS // 10, at(base + 2.1), "kernel"))
        ops.append(("k3", at(base + 3.1), MS // 20, at(base + 2.2), "kernel"))
    return tr.Trace((at(0), at(10)), {tr.WINDOW: [(at(0), at(10))]}, ops, units, {})


def records(extra=()):
    """Program spans: under each call (0-3.5 ms of it) the tail (2.0-2.5
    ms) and the U-Net; a training step from 0.5 to 9.5 ms of the window;
    one call that ended before the window opened."""
    recs, sid = [], 1
    recs.append(("registrar.predict_tensors", at(-3), at(-0.5), sid, 0, sid, 1))
    for base in (1.0, 5.0):
        root = sid = sid + 1
        for name, lo, hi in (("vxm.unet", 0.1, 1.5), ("vxm.tail", 2.0, 2.5),
                             ("registrar.predict_tensors", 0.0, 3.5)):
            recs.append((name, at(base + lo), at(base + hi), sid, 0 if sid == root else root,
                         root, 1))
            sid += 1
    recs.append(("train.step", at(0.5), at(9.5), sid + 1, 0, sid + 1, 1))
    recs.extend(extra)
    return sorted(recs, key=lambda r: r[2])


@pytest.fixture
def ring(monkeypatch):
    """Stands the given records and drop count in for the port's ring."""
    def set_ring(recs, dropped=0):
        monkeypatch.setattr(profiling, "spans", lambda: list(recs))
        monkeypatch.setattr(profiling, "dropped", lambda: dropped)

    set_ring(records())
    return set_ring


def test_tail_ms_counts_the_ops_launched_under_the_tail(ring):
    t = make_trace()
    for name in ("tail_ms.pairs", "tail_ms.w256"):
        assert read(name, t) == pytest.approx(0.15)  # (0.1 + 0.05) ms a pair


def test_idle_inside_a_span_counts_only_its_overlap(ring):
    # busy (ms of the window): 3-4, 4-4.1, 4.1-4.15, 7-8, 8-8.1, 8.1-8.15;
    # the calls' spans 1-4.5 and 5-8.5: idle inside them 1-3, 4.15-4.5, 5-7, 8.15-8.5
    t = make_trace()
    idle = (2.0 + 0.35 + 2.0 + 0.35) / 2
    for name in ("launch_gap_ms.pairs", "launch_gap_ms.w256"):
        assert read(name, t) == pytest.approx(idle)
    # the step's span 0.5-9.5: all idle of the window but 0-0.5 and 9.5-10
    busy = 2 * 1.15
    assert read("host_gap_ms.train", t) == pytest.approx((9.0 - busy) / 2)


def test_an_idle_gap_across_a_span_edge(ring):
    # one op at 2-6 ms, launched at 1 ms; a span 1-3 ms and one 5-9 ms: idle
    # 0-2 and 6-10 overlap them by 1 and 3 ms
    ring([("train.step", at(1), at(3), 1, 0, 1, 1), ("train.step", at(5), at(9), 2, 0, 2, 1)])
    t = tr.Trace((at(0), at(10)), {tr.WINDOW: [(at(0), at(10))]},
                 [("k", at(2), 4 * MS, at(1), "kernel")], 1, {})
    assert read("host_gap_ms.train", t) == pytest.approx(4.0)


def test_readers_find_nothing_without_spans_in_the_window(ring):
    ring([r for r in records() if r[0] != "vxm.tail"])
    assert read("tail_ms.pairs", make_trace()) is None
    # a span that crosses the window's edge is not in it
    ring([("train.step", at(-1), at(2), 1, 0, 1, 1)])
    assert read("host_gap_ms.train", make_trace()) is None


def test_readers_find_nothing_in_a_window_without_device_operations(ring):
    t = tr.Trace((at(0), at(10)), {tr.WINDOW: [(at(0), at(10))]}, [], 2, {})
    for name in ("tail_ms.pairs", "launch_gap_ms.pairs", "host_gap_ms.train"):
        assert read(name, t) is None


def test_a_dropped_record_of_the_window_makes_the_readers_return_none(ring):
    t = make_trace()
    # dropped records ended before the oldest kept one, which ended inside the window
    ring([r for r in records() if r[2] > at(0)], dropped=1)
    for name in ("tail_ms.pairs", "launch_gap_ms.w256", "host_gap_ms.train"):
        assert read(name, t) is None
    # the oldest kept record ended before the window: what was dropped did too
    ring(records(), dropped=5)
    assert read("tail_ms.pairs", t) == pytest.approx(0.15)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    for name in ("tail_ms.pairs", "launch_gap_ms.pairs", "host_gap_ms.train"):
        assert read(name, make_trace()) is None


def test_the_readers_of_one_quantity_share_a_file():
    for quantity in ("tail_ms", "launch_gap_ms"):
        files = {Path(harness.reader(ROOT, f"{quantity}.{cells}").__code__.co_filename).name
                 for cells in ("pairs", "w256")}
        assert files == {f"{quantity}.py"}
